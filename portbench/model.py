"""A configuration file read into the program's model configuration.

A configuration file holds a model's published settings under the keys
of its public ``config.json``; this module maps those keys onto the
program's ``ModelConfig``.  What the program does not model is kept in
the file under ``published_not_modelled`` and read by nobody.
"""

from __future__ import annotations

import torch

from portbench import counts

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(conf: dict, remat: str = "block"):
    """The program's ``ModelConfig`` of a dense decoder's file."""
    from repro_torch.models.config import ModelConfig
    if conf["family"] != "dense":
        raise ValueError(f"no mapping for the {conf['family']!r} family")
    heads = conf["num_attention_heads"]
    return ModelConfig(
        name=conf["name"], family="dense",
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=heads, n_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
        head_dim=conf.get("head_dim", conf["hidden_size"] // heads),
        rope_theta=float(conf["rope_theta"]),
        tie_embeddings=conf["tie_word_embeddings"], mlp_kind="swiglu",
        dtype=DTYPES[conf["torch_dtype"]], remat=remat)


def heads(conf: dict) -> tuple[int, int, int]:
    """(n_heads, n_kv_heads, head_dim) as the reference takes them."""
    h = conf["num_attention_heads"]
    return h, conf["num_key_value_heads"], conf.get(
        "head_dim", conf["hidden_size"] // h)


def dense_counts(conf: dict, vocab_rows: int) -> counts.Dense:
    h, hkv, hd = heads(conf)
    return counts.Dense(conf["num_hidden_layers"], conf["hidden_size"], h,
                        hkv, hd, conf["intermediate_size"], vocab_rows)
