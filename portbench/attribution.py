"""Each device operation of a traced run, paired with its launch and
named by the host spans open at that launch.

A CUDA-only ``torch.profiler`` trace carries, beside each kernel,
memcpy and memset, the host's ``cuda_runtime`` / ``cuda_driver`` call
that queued it, with the same ``args.correlation``.  The launch's
timestamp is a host instant, so the span open around it -- the
harness's (``devtrace.Spans``: ``wait``, ``submit``, ``step``,
``train_step``, ...) and the program's (``repro_torch.obs.StepTracer``:
``dispatch.join``, ``readback``, ``optimizer``, ...) -- says what the
host was doing when it asked for the work, however late the device ran
it.  Both kinds of span are on ``time.perf_counter``; the trace's clock
is tied to it by the start marker (``devtrace.Window``): by its launch
where the trace has that, else by its device start, as ``devtrace.clip``.

Each operation's label is the innermost harness span, then ``/`` and
the innermost program span where one is open (``step/dispatch.join``,
``train_step/optimizer``), ``untraced`` outside every harness span; an
operation whose launch the trace lacks is counted as unmatched.  The
spans of each kind must nest (one host thread records them).
"""

from __future__ import annotations

import dataclasses

from portbench import devtrace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Op:
    """One device operation on the host clock, with what launched it."""
    name: str
    start: float
    end: float
    launch: float | None          # None: no launch event in the trace
    label: str = "untraced"
    args: dict | None = None      # the innermost program span's args


def _corr(e) -> int | None:
    c = (e.get("args") or {}).get("correlation")
    return None if c is None else int(c)


def innermost(spans, times) -> list[int | None]:
    """For each instant of ``times`` (ascending), the index into ``spans``
    ((name, start, end, ...) tuples that nest) of the shortest span
    around it, or None."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(order) and spans[order[k]][1] <= t:
            i = order[k]
            while stack and spans[stack[-1]][2] < spans[i][1]:
                stack.pop()
            stack.append(i)
            k += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def labels(harness, program, times) -> list[tuple[str, dict | None]]:
    """(label, program span args) for each instant of ``times``
    (ascending); ``harness`` as (name, start, end) tuples, ``program``
    as (name, start, end, args, ...) ones, such as ``StepTracer.spans()``."""
    hs = innermost(harness, times)
    ps = innermost(program, times)
    out = []
    for h, p in zip(hs, ps):
        name = "untraced" if h is None else harness[h][0]
        if p is not None:
            name = f"{name}/{program[p][0]}"
        out.append((name, None if p is None else program[p][3]))
    return out


def attribute(trace_events, t0: float, harness, program) -> list[Op]:
    """Every device operation of the trace (markers left out) on the
    host clock, in start order, labelled by the spans open at its
    launch.  ``t0`` is the host instant of the start marker's launch
    (``devtrace.Window.t0``)."""
    launches, ops = {}, []
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in LAUNCH_CATS and _corr(e) is not None:
            launches[_corr(e)] = float(e["ts"])
        elif e.get("cat") in devtrace.DEVICE_CATS:
            ops.append(e)
    ops.sort(key=lambda e: float(e["ts"]))
    marks = [e for e in ops if devtrace._is_marker(e)]
    if len(marks) != 2:
        raise RuntimeError(f"the trace holds {len(marks)} of its 2 marker "
                           f"kernels ({len(ops)} operations)")
    tied = launches.get(_corr(marks[0]))
    base = (float(marks[0]["ts"]) if tied is None else tied) * 1e-6 - t0
    out = []
    for e in ops:
        if devtrace._is_marker(e):
            continue
        a = float(e["ts"]) * 1e-6 - base
        ts = launches.get(_corr(e))
        out.append(Op(e["name"], a, a + float(e["dur"]) * 1e-6,
                      None if ts is None else ts * 1e-6 - base))
    matched = sorted((o for o in out if o.launch is not None),
                     key=lambda o: o.launch)
    for o, (name, args) in zip(matched, labels(
            harness, program, [o.launch for o in matched])):
        o.label, o.args = name, args
    return out


def clipped(ops, t0: float, t1: float):
    """(op, seconds of it inside [t0, t1]) for the ops that overlap it."""
    for o in ops:
        d = min(o.end, t1) - max(o.start, t0)
        if d > 0:
            yield o, d


def shares(ops, t0: float, t1: float) -> dict:
    """Of the device time inside [t0, t1]: the share whose launch was
    found, and the share launched outside every harness span."""
    total = matched = outside = 0.0
    for o, d in clipped(ops, t0, t1):
        total += d
        if o.launch is not None:
            matched += d
            outside += d * (o.label == "untraced")
    if total <= 0:
        return {"device_s": 0.0, "matched": None, "outside": None}
    return {"device_s": total, "matched": matched / total,
            "outside": outside / total}


def by_rid(ops, names) -> dict[int, float]:
    """Device seconds launched inside each request's program spans named
    in ``names`` (their ``args["rid"]``), over the whole trace."""
    out: dict[int, float] = {}
    for o in ops:
        rid = (o.args or {}).get("rid")
        if rid is not None and o.label.rsplit("/", 1)[-1] in names:
            out[rid] = out.get(rid, 0.0) + o.end - o.start
    return out


def breakdown(events, harness, program, t0: float, t1: float,
              top: int = 10) -> dict:
    """``devtrace.breakdown`` with each idle gap named by the span path
    open at its middle (``step/readback``).  Temporary, for
    ``span_probe.py``: it goes once ``devtrace.breakdown`` names its
    gaps by the program's spans itself."""
    out = devtrace.breakdown(events, [], t0, t1, top)
    gaps = sorted(devtrace.idle_gaps(events, t0, t1),
                  key=lambda g: g[0] - g[1])[:top]
    mids = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    names = labels(harness, program,
                   [(gaps[i][0] + gaps[i][1]) / 2 for i in mids])
    named = dict(zip(mids, (n for n, _ in names)))
    out["idle_gaps"] = [[named[i], b - a] for i, (a, b) in enumerate(gaps)]
    return out
