"""Driver ``serve_open``: an open loop of requests into the port's paged
engine (``PagedEngine.submit`` / ``.step``, its default configuration).

Requests are submitted when they fall due, whatever the engine is
doing; a request is timed from its due time to the return of the
``step()`` that delivered its first token (that step reads the token
back, so the device's work is done).  Requests due in the window are
followed past its end for at most the window's length again; one with
no token by then is a miss.

The check: a sample of the finished requests drawn from the seed, the
longest of the window among them.  For each sampled request the row of
logits its first token was sampled from is copied aside as the engine
samples it, and as it finishes the keys and values its prefill wrote
into the pages (on the device, before any later request can reuse a
page).  After the window the engine is freed and the plain reference
runs each sampled prompt: the relative error of the served row of
logits (every layer, the final norm and the head), the gap of the
served token's logit below the reference's best, and the relative
error of every layer's keys and values.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch

from portbench import compare, devtrace, e2e, model, traffic, weights
from portbench.harness import Check, Outcome, sync
from portbench.reference import dense


@dataclasses.dataclass
class Rec:
    index: int
    due: float                    # s after the window's start
    n: int
    req: object
    started: float | None = None  # host time of the step that began it
    done: float | None = None     # host time of the step that ended it
    status: str | None = None
    token: int | None = None


@dataclasses.dataclass
class State:
    cfg: object
    params: dict
    eng: object
    spans: devtrace.Spans
    pages: dict                   # rid -> pages at eviction
    watch: set = dataclasses.field(default_factory=set)  # rids to record
    logits: dict = dataclasses.field(default_factory=dict)  # rid -> row
    current: int | None = None    # the rid the engine is prefilling
    restore: object = None        # undoes the recording of logits


def setup(ctx) -> State:
    """Weights, the engine, and the warm-up of every shape the mix
    uses (the mix's ``warmup_lengths``)."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import PagedEngine, PagedServeConfig
    mix = ctx.mix
    if ctx.device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build(mix["kernels"])
    cfg = model.model_config(ctx.config)
    params = weights.make(T.model_defs(cfg), ctx.seed, ctx.device)
    eng = PagedEngine(cfg, params, PagedServeConfig(
        max_seq=mix["max_seq"], max_batch=mix["max_batch"],
        device=ctx.device.type))
    st = State(cfg, params, eng, devtrace.Spans(), {})
    evict = eng.scheduler.evict

    def recording_evict(slot):
        req = eng.scheduler.running[slot]
        st.pages[req.rid] = list(req.pages)
        return evict(slot)
    eng.scheduler.evict = recording_evict
    _record_logits(st)
    for p in traffic.prompts_of(mix["warmup_lengths"], ctx.seed, cfg.vocab):
        eng.submit(p, mix["max_new_tokens"])
        while eng.has_work:
            eng.step()
    sync(ctx.device)
    return st


def _record_logits(st: State) -> None:
    """Copy aside the row of logits each watched request's first token
    is sampled from: the engine's prefill methods name the request, the
    module's ``sample_tokens`` sees the row (a copy on the device, no
    host sync)."""
    from repro_torch.serve import engine
    for name in ("_join", "_prefill_one_chunk"):
        def prefilling(req, _orig=getattr(st.eng, name)):
            st.current = req.rid
            try:
                return _orig(req)
            finally:
                st.current = None
        setattr(st.eng, name, prefilling)
    orig = engine.sample_tokens

    def sample_tokens(cfg, logits, temperature, generator):
        if st.current in st.watch:
            st.logits[st.current] = logits[0, :cfg.vocab].to(
                torch.float32, copy=True)
        return orig(cfg, logits, temperature, generator)
    engine.sample_tokens = sample_tokens
    st.restore = lambda: setattr(engine, "sample_tokens", orig)


def _capture(st: State, rid: int, n: int):
    """The keys and values of a finished request, (layers, n, Hkv, D)
    each, copied out of its pages before they can be reused."""
    idx = torch.tensor(st.pages[rid], dtype=torch.long)
    if st.eng.device.type == "cuda":       # no host sync in the window
        idx = idx.pin_memory().to(st.eng.device, non_blocking=True)
    out = []
    for name in ("k_pages", "v_pages"):
        pool = st.eng.cache[name]
        blocks = pool[:, idx]
        out.append(blocks.reshape(pool.shape[0], -1,
                                  *pool.shape[3:])[:, :n])
    return out


def sample(arr: traffic.Arrivals, k: int, seed: int) -> set[int]:
    """The arrivals whose outputs are checked: the longest and ``k - 1``
    others drawn from the seed."""
    longest = int(max(range(len(arr.prompt_lens)),
                      key=lambda i: arr.prompt_lens[i]))
    rest = [i for i in range(len(arr.prompt_lens)) if i != longest]
    g = traffic.rng(seed, 3)
    pick = g.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return {longest} | {rest[int(i)] for i in pick}


def serve(st: State, arr: traffic.Arrivals, seconds: float, checked=(),
          tw: devtrace.Window | None = None, tw_at=(0.0, 0.0)):
    """The open loop over ``arr``.  Returns (records, t0, pieces,
    captures): ``pieces`` are the prefill work of each step as (step
    start, step end, first position, tokens, ends the prompt).  With
    ``tw`` the profiler runs from before the loop to after it, and the
    loop marks the sub-window ``tw_at`` (start after the window's start,
    length) inside it."""
    eng, spans = st.eng, st.spans
    recs, open_, pieces, caps = [], {}, [], {}
    n, i = len(arr.due_s), 0
    if tw is not None:
        tw.open()
    t0 = time.perf_counter()
    cut = t0 + 2 * seconds
    tw_state = 0
    while True:
        now = time.perf_counter()
        if tw is not None:
            if tw_state == 0 and now - t0 >= tw_at[0]:
                with spans("sync"):
                    tw.mark_start()
                tw_state = 1
            elif tw_state == 1 and now - tw.t0 >= tw_at[1]:
                with spans("sync"):
                    tw.mark_end()
                tw_state = 2
        if i < n and t0 + arr.due_s[i] <= now:
            with spans("submit"):
                while i < n and t0 + arr.due_s[i] <= now:
                    rid = eng.submit(arr.prompts[i], arr.max_new_tokens)
                    req = eng.scheduler.waiting[-1]
                    assert req.rid == rid
                    rec = Rec(i, float(arr.due_s[i]), int(arr.prompt_lens[i]),
                              req)
                    if i in checked:
                        st.watch.add(rid)
                    recs.append(rec)
                    open_[rid] = rec
                    i += 1
        if eng.has_work:
            before = {rid: r.req.prefilled for rid, r in open_.items()}
            ts = time.perf_counter()
            with spans("step"):
                finished = eng.step()
            te = time.perf_counter()
            for rid, rec in open_.items():
                d = rec.req.prefilled - before[rid]
                if d > 0:
                    rec.started = ts if rec.started is None else rec.started
                    pieces.append((ts, te, before[rid], d,
                                   rec.req.prefilled >= rec.n))
            for r in finished:
                rec = open_.pop(r.rid)
                rec.done, rec.status = te, r.status.value
                rec.token = int(r.output[0]) if len(r.output) else None
                if rec.index in checked:
                    with spans("capture"):
                        caps[rec.index] = _capture(st, r.rid, rec.n)
        elif i < n:
            with spans("wait"):
                time.sleep(max(0.0, t0 + arr.due_s[i] - time.perf_counter()))
        else:
            break
        if time.perf_counter() > cut:
            break
    if tw is not None:
        if tw_state == 1:
            tw.mark_end()
        tw.close()
    return recs, t0, pieces, caps


def check(ctx, st: State, arr, recs, caps, control: bool) -> dict:
    """The reference over every sampled request that finished; the
    program's state is freed first.  Returns the readings by name (and
    the control's, with ``control``)."""
    cfg_vocab = st.cfg.vocab
    st.restore()
    served = {rec.index: st.logits.get(rec.req.rid) for rec in recs
              if rec.index in caps}
    st.eng = None
    st.logits = {}
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    heads = model.heads(ctx.config)
    theta = float(ctx.config["rope_theta"])
    mms = (dense.fp32_mm, dense.fp8_mm) if control else (dense.fp32_mm,)
    out = {"logits_rel_err": 0.0, "kv_rel_err": 0.0, "logit_gap": 0.0,
           "ref_margin_min": math.inf, "served_last_prompt_token": 0}
    if control:
        out.update(logits_rel_err_control=0.0, kv_rel_err_control=0.0,
                   logit_gap_control=0.0)
    by_index = {r.index: r for r in recs}
    with dense.strict_fp32():
        for index in sorted(caps):
            rec = by_index[index]
            kp, vp = caps[index]
            tokens = torch.from_numpy(arr.prompts[index]).to(ctx.device)

            def on_kv(layer, kvs):
                k, v = kvs[0]
                out["kv_rel_err"] = max(out["kv_rel_err"],
                                        compare.rel_err(kp[layer], k),
                                        compare.rel_err(vp[layer], v))
                if control:
                    kc, vc = kvs[1]
                    out["kv_rel_err_control"] = max(
                        out["kv_rel_err_control"],
                        compare.rel_err(kc, k), compare.rel_err(vc, v))
            hs = dense.prefill(st.params, tokens, heads, theta, mms, on_kv)
            ref_last = dense.logits(st.params, hs[0][-1:], dense.fp32_mm)[0]
            row = served[index]
            out["logits_rel_err"] = max(out["logits_rel_err"], math.inf
                                        if row is None else compare.rel_err(
                                            row, ref_last[:cfg_vocab]))
            out["logit_gap"] = max(out["logit_gap"], compare.logit_gap(
                ref_last, rec.token, cfg_vocab))
            top2 = ref_last[:cfg_vocab].topk(2).values
            out["ref_margin_min"] = min(out["ref_margin_min"],
                                        float(top2[0] - top2[1]))
            out["served_last_prompt_token"] += int(
                rec.token == int(arr.prompts[index][-1]))
            if control:
                low_last = dense.logits(st.params, hs[1][-1:],
                                        dense.fp8_mm)[0]
                out["logits_rel_err_control"] = max(
                    out["logits_rel_err_control"], compare.rel_err(
                        low_last[:cfg_vocab], ref_last[:cfg_vocab]))
                out["logit_gap_control"] = max(
                    out["logit_gap_control"], _control_gap(
                        st.params, hs, cfg_vocab))
            del hs
    out["sampled"] = len(caps)
    return out


def _control_gap(params, hs, vocab: int, rows: int = 1024) -> float:
    """The control's reading at every position of a prompt: how far the
    reference's logit of the token the control puts first lies below
    the reference's best (a served model's control is read position by
    position over the same prompt, decoding nothing)."""
    worst = 0.0
    for r0 in range(0, hs[0].shape[0], rows):
        ref = dense.logits(params, hs[0][r0:r0 + rows],
                           dense.fp32_mm)[:, :vocab]
        low = dense.logits(params, hs[1][r0:r0 + rows],
                           dense.fp8_mm)[:, :vocab]
        pick = low.argmax(dim=1, keepdim=True)
        gap = ref.max(dim=1).values - ref.gather(1, pick)[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def run(ctx) -> Outcome:
    mix = ctx.mix
    st = setup(ctx)
    arr = traffic.open_loop(mix, ctx.seconds, ctx.seed, st.cfg.vocab)
    checked = sample(arr, mix["check_sample"], ctx.seed)
    tw = devtrace.Window(torch) if ctx.trace else None
    setup_s = time.perf_counter() - ctx.t_start
    at = mix["trace"]
    recs, t0, pieces, caps = serve(
        st, arr, ctx.seconds, checked, tw,
        (at["start_share"] * ctx.seconds, at["seconds"]))
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    # a request due in the window that was never sent (the loop was cut
    # first) is a miss too
    unsent = len(arr.due_s) - len(recs)
    ttft, waits, failed = [math.inf] * unsent, [math.inf] * unsent, unsent
    for rec in recs:
        due = t0 + rec.due
        ok = rec.done is not None and rec.status == "ok"
        failed += not ok
        ttft.append((rec.done - due) * 1e3 if ok else math.inf)
        waits.append((rec.started - due) * 1e3 if rec.started is not None
                     else math.inf)
    readings = None
    busy = window = brk = None
    if tw is not None:
        events = tw.events()
        busy = devtrace.busy_seconds(events)
        window = tw.t1 - tw.t0
        brk = devtrace.breakdown(events, st.spans.items, tw.t0, tw.t1)
        vocab_rows = st.params["embed"]["embedding"].shape[0]
        cnt = model.dense_counts(ctx.config, vocab_rows)
        inside = [p for p in pieces if p[0] >= tw.t0 and p[1] <= tw.t1]
        readings = {
            "events": events, "window_s": window, "busy_s": busy,
            "model_flops": sum(cnt.prefill_flops(s, c, int(end))
                               for _, _, s, c, end in inside),
            "attn_flops": sum(cnt.layers * cnt.attn_flops(s, c)
                              for _, _, s, c, _ in inside),
            "attn_bytes": sum(cnt.layers * cnt.attn_bytes(s, c)
                              for _, _, s, c, _ in inside),
            "queue_waits_ms": waits}
    found = check(ctx, st, arr, recs, caps, ctx.control)
    lim = ctx.limits
    checks = [Check("logits_rel_err", found["logits_rel_err"],
                    lim["logits_rel_err"]),
              Check("logit_gap", found["logit_gap"], lim["logit_gap"]),
              Check("kv_rel_err", found["kv_rel_err"], lim["kv_rel_err"]),
              Check("checked_missing", float(len(checked) - len(caps)),
                    0.0)]
    return Outcome(
        attempted=len(arr.due_s), failed=failed,
        e2e={"ttft_p90_ms": e2e.percentile(ttft, 90), "setup_s": setup_s},
        checks=checks, memory_peak_bytes=int(peak), readings=readings,
        busy_s=busy, window_s=window, breakdown=brk, extra=found)
