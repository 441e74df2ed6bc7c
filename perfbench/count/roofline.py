"""Published peaks and roofline bounds.

Frozen copies of ``chip_smoke.PEAKS``, ``peaks_for``, ``bound_of``,
``zrun_plan_bytes`` and ``conv_bound``, with the element sizes of
``conv_bound`` made arguments: B1 reads its input rows as bf16 (2 bytes),
which the wrapper casts before the launch, and writes f32 rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

# published dense bf16 tensor-core rate and device-memory rate (NVIDIA's
# data sheets, SXM parts, at their full power limit)
PEAKS = {"H200": (989e12, 4.8e12), "H100": (989e12, 3.35e12)}


def peaks_for(name: str) -> Optional[Tuple[float, float]]:
    """(FLOP/s, bytes/s) of the card named ``name``; None for a device
    with no published peak here (a share of it is then not read)."""
    for key, val in PEAKS.items():
        if key in name:
            return val
    return None


def bound_of(flops: float, nbytes: float, flops_peak: float,
             bw_peak: float) -> Tuple[float, str]:
    """(the larger of the two times in ms, which of them it is)."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def zrun_plan_bytes(n: int, with_valid: bool) -> int:
    """Bytes of the z-run plan (zbase int32 (N, 9), zcode int8 (N, 9, 3))
    and the row mask."""
    return n * 9 * 4 + n * 27 + (n if with_valid else 0)


def conv_bound(n: int, cin: int, cout: int, pairs: float, plan_bytes: int,
               flops_peak: float, bw_peak: float, taps: int = 27,
               x_bytes: int = 4, w_bytes: int = 2, y_bytes: int = 4):
    """(bound ms, what bounds it, flops, bytes) of one sparse conv: the
    valid references' products over the tensor-core peak against reading
    x, W and the plan once and writing y once."""
    flops = 2.0 * pairs * cin * cout
    nbytes = (n * cin * x_bytes + taps * cin * cout * w_bytes + plan_bytes
              + n * cout * y_bytes)
    return bound_of(flops, nbytes, flops_peak, bw_peak) + (flops, nbytes)
