"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

The package mirrors ``repro``'s layout module for module.  It imports
``torch`` and numpy only: nothing of ``jax`` and nothing of ``repro``.
Every TPU kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/_build.py``); each kernel's wrapper runs its plain PyTorch
version only for tensors that lie on the CPU.
"""
