"""Memory access-energy model (paper §3.4, Table 3).

Energies are pJ per 16-bit access, derived from CACTI at 45 nm, calibrated
against a commercial memory compiler (paper §4.2).  Below 1 KB the paper
uses standard-cell register files; we model those with a sqrt(size) roll-off
from the 1 KB SRAM point, floored at a latch-access cost.  Above 16 MB the
paper switches to DRAM at a flat 320 pJ/16b (Micron TN-41-01).

Area: paper Fig. 7 gives the two calibration points (8 MB = 45 mm^2 = 45x
DianNao baseline; 1 MB = 6x baseline) -> 5.625 mm^2 / MB of SRAM plus a
fixed ~0.85 mm^2 datapath.

Compute: the 256-MAC 16-bit datapath (DianNao-like, 45 nm) is modeled at
1.0 pJ / MAC (DianNao reports ~485 mW at 452 GOP/s ~ 1 pJ/op).
"""

from __future__ import annotations

import bisect
import math

# paper Table 3: pJ per 16 bits. rows: size in KB; columns: word width bits.
_SIZES_KB = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]
_WIDTHS = [64, 128, 256, 512]
_TABLE = {
    1:    [1.20, 0.93, 0.69, 0.57],
    2:    [1.54, 1.37, 0.91, 0.68],
    4:    [2.11, 1.68, 1.34, 0.90],
    8:    [3.19, 2.71, 2.21, 1.33],
    16:   [4.36, 3.57, 2.66, 2.19],
    32:   [5.82, 4.80, 3.52, 2.64],
    64:   [8.10, 7.51, 5.79, 4.67],
    128:  [11.66, 11.50, 8.46, 6.15],
    256:  [15.60, 15.51, 13.09, 8.99],
    512:  [23.37, 23.24, 17.93, 15.76],
    1024: [36.32, 32.81, 28.88, 25.22],
}

DRAM_PJ_PER_16B = 320.0
DRAM_THRESHOLD_BYTES = 16 * 1024 * 1024  # >16MB -> DRAM
MAC_ENERGY_PJ = 1.0
REGFILE_FLOOR_PJ = 0.03  # single flop/latch read
SRAM_AREA_MM2_PER_MB = 45.0 / 8.0  # Fig. 7 calibration
DATAPATH_AREA_MM2 = 0.85


def _col(width_bits: int | None) -> int:
    if width_bits is None:
        return len(_WIDTHS) - 1  # widest = most efficient (paper §4.2)
    return _WIDTHS.index(width_bits)


import functools


@functools.lru_cache(maxsize=65536)
def sram_access_pj(size_bytes: float, width_bits: int | None = None) -> float:
    """Log-log interpolated SRAM access energy per 16-bit word."""
    col = _col(width_bits)
    kb = size_bytes / 1024.0
    pts = [(s, _TABLE[s][col]) for s in _SIZES_KB]
    if kb <= pts[0][0]:
        # register-file regime: sqrt(size) roll-off below 1 KB
        e = pts[0][1] * math.sqrt(max(kb, 1e-6) / pts[0][0])
        return max(e, REGFILE_FLOOR_PJ)
    if kb >= pts[-1][0]:
        # extrapolate with the last decade's log-log slope (1MB..16MB SRAM)
        (s0, e0), (s1, e1) = pts[-2], pts[-1]
        slope = math.log(e1 / e0) / math.log(s1 / s0)
        return e1 * (kb / s1) ** slope
    sizes = [p[0] for p in pts]
    i = bisect.bisect_right(sizes, kb) - 1
    (s0, e0), (s1, e1) = pts[i], pts[i + 1]
    t = math.log(kb / s0) / math.log(s1 / s0)
    return math.exp(math.log(e0) * (1 - t) + math.log(e1) * t)


def access_energy_pj(size_bytes: float, width_bits: int | None = None) -> float:
    """Access energy for a memory of ``size_bytes`` (SRAM/RF or DRAM)."""
    if size_bytes > DRAM_THRESHOLD_BYTES:
        return DRAM_PJ_PER_16B
    return sram_access_pj(size_bytes, width_bits)


def sram_area_mm2(size_bytes: float) -> float:
    return SRAM_AREA_MM2_PER_MB * (size_bytes / (1024.0 * 1024.0))


def broadcast_energy_pj(total_onchip_bytes: float) -> float:
    """Paper §3.4: broadcast cost ~= fetch from a memory the size of the
    total embedded memory the data must traverse."""
    return access_energy_pj(total_onchip_bytes)
