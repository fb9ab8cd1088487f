"""Per-layer arithmetic over the program's own spans and stamps, for a
traced run whose readings carry them (``attribution.py``'s operations).

The readings these functions take, beside ``layer_metrics``' keys:

- ``ops``: every device operation of the trace as ``attribution.Op``,
  labelled by the spans open at its launch;
- ``window``: the sub-window's (start, end) on the host clock;
- ``requests``: one dict a request sent in the window, ``rid``, ``ok``
  (it got its token), and the engine's stamps ``t_admit`` and
  ``t_first_token`` in ``perf_counter`` seconds; ``unsent``: the
  requests due in the window that were never sent.

Each returns None where the readings lack what it reads (a program
without the spans) or where a miss sets the percentile.
"""

from __future__ import annotations

import math

from portbench import attribution
from portbench.layer_metrics import p90

# the engine's dispatch spans that run a request's own prefill
PREFILL_SPANS = ("dispatch.join", "dispatch.prefill")


def _per_request(r, value) -> float | None:
    if not r or "requests" not in r or "ops" not in r:
        return None
    dev = attribution.by_rid(r["ops"], PREFILL_SPANS)
    vals = [math.inf] * r["unsent"]
    for q in r["requests"]:
        ok = q["ok"] and q["t_admit"] is not None \
            and q["t_first_token"] is not None
        vals.append(value(q, dev.get(q["rid"], 0.0)) * 1e3 if ok
                    else math.inf)
    return p90(vals)


def prefill_device_p90_ms(r) -> float | None:
    """p90 over the requests due in the window of the device time of
    the operations launched inside their own join and prefill spans."""
    return _per_request(r, lambda q, dev: dev)


def prefill_blocked_p90_ms(r) -> float | None:
    """p90 over the requests due in the window of admission to first
    token on the host, less the request's own device time: what it
    waited inside the engine behind other requests' work and the host."""
    return _per_request(
        r, lambda q, dev: q["t_first_token"] - q["t_admit"] - dev)


def optimizer_pct(r) -> float | None:
    """The share of the sub-window's device busy time taken by
    operations launched inside ``optimizer`` spans."""
    if not r or "ops" not in r or r["busy_s"] <= 0:
        return None
    t = sum(d for o, d in attribution.clipped(r["ops"], *r["window"])
            if o.label.endswith("/optimizer"))
    return 100.0 * t / r["busy_s"] if t > 0 else None
