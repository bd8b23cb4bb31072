"""Device-kind peak table and roofline arithmetic (the port of
``torcheval_tpu/tools/roofline.py``).

A kernel's bytes and operations over its measured time give an achieved
GB/s and GFLOP/s, held against the peaks of the device the process runs
on (:func:`current_device_kind`: ``torch.cuda.get_device_name()`` when a
GPU is present, ``"cpu"`` otherwise).  An unknown device kind maps onto
the conservative CPU fallback instead of raising, so the percentages read
as upper bounds rather than breaking an evaluation loop.  Register the
numbers of another card with :func:`register_device_peaks`::

    from torcheval_tpu_torch.tools import roofline
    roofline.register_device_peaks(
        "NVIDIA H100 PCIe", hbm_gbps=2000.0, flops=756e12
    )

The JAX package's rows are TPU generations; none of them is carried over.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

# Peaks keyed on ``torch.cuda.get_device_name()``.  ``hbm_gbps`` is the
# memory-bandwidth roof (GB/s), ``flops`` the dense compute roof (FLOP/s):
# for a GPU, its dense (no sparsity) BF16 tensor-core rate.
_DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    # NVIDIA H100 SXM5 80 GB data sheet, at its 700 W limit: 3.35 TB/s of
    # HBM3, 989.4 TFLOP/s dense BF16 on the tensor cores (1979 with
    # sparsity).  A card capped below 700 W runs slower under load.
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "flops": 989.4e12},
    # Conservative single-socket CPU fallback: ~50 GB/s DDR stream,
    # ~0.5 TFLOP/s vectorized f32.  Deliberately low: on an unknown
    # device the roofline percentages read as upper bounds, the safe
    # direction for an alert on a utilization floor.
    "cpu": {"hbm_gbps": 50.0, "flops": 5e11},
}

_FALLBACK_KIND = "cpu"


def register_device_peaks(
    device_kind: str, *, hbm_gbps: float, flops: float
) -> None:
    """Add (or override) the peak row for ``device_kind``.  Takes effect
    for every later :func:`device_peaks` call."""
    if hbm_gbps <= 0 or flops <= 0:
        raise ValueError(
            f"peaks must be positive, got hbm_gbps={hbm_gbps} flops={flops}"
        )
    _DEVICE_PEAKS[device_kind] = {
        "hbm_gbps": float(hbm_gbps),
        "flops": float(flops),
    }


def known_device_kinds() -> tuple:
    """The device kinds with registered peak rows."""
    return tuple(sorted(_DEVICE_PEAKS))


def current_device_kind() -> str:
    """``torch.cuda.get_device_name()`` of the current card, or the
    fallback when there is no GPU (never raises on the accounting path)."""
    try:
        import torch

        if torch.cuda.is_available():
            return str(torch.cuda.get_device_name())
    except Exception:
        pass
    return _FALLBACK_KIND


def device_peaks(device_kind: Optional[str] = None) -> Dict[str, Any]:
    """The peak row for ``device_kind`` (default: the current process
    device).  Unknown kinds degrade to the conservative CPU fallback, and
    the returned dict says so with ``"exact": False``."""
    kind = device_kind if device_kind is not None else current_device_kind()
    row = _DEVICE_PEAKS.get(kind)
    exact = row is not None
    if row is None:
        row = _DEVICE_PEAKS[_FALLBACK_KIND]
    return {
        "device_kind": kind,
        "hbm_gbps": row["hbm_gbps"],
        "flops": row["flops"],
        "exact": exact,
    }


def roofline(
    *,
    flops: float,
    bytes_accessed: float,
    seconds: float,
    peaks: Optional[Mapping[str, Any]] = None,
) -> Dict[str, float]:
    """Achieved throughput against the device roofs for one call (or a
    mean over calls): achieved GB/s and GFLOP/s, the percent of each roof
    sustained, the bandwidth-floor device seconds (the time the call's
    bytes take at peak memory bandwidth), and which roof binds."""
    peaks = dict(peaks) if peaks is not None else device_peaks()
    sec = max(float(seconds), 1e-12)
    achieved_gbps = float(bytes_accessed) / sec / 1e9
    achieved_gflops = float(flops) / sec / 1e9
    hbm_pct = 100.0 * achieved_gbps / peaks["hbm_gbps"]
    flops_pct = 100.0 * achieved_gflops / (peaks["flops"] / 1e9)
    return {
        "achieved_gbps": achieved_gbps,
        "achieved_gflops": achieved_gflops,
        "hbm_pct": hbm_pct,
        "flops_pct": flops_pct,
        "device_seconds_floor": float(bytes_accessed)
        / (peaks["hbm_gbps"] * 1e9),
        "bound": "compute" if flops_pct > hbm_pct else "bandwidth",
    }


def reread_multiplier(bytes_accessed: float, batch_bytes: float) -> float:
    """Bytes a call moves over the batch's own bytes: a collection whose
    members each re-read the batch reports about one a member, the
    one-pass collection kernel about one; 0.0 when the batch size is
    unknown."""
    if batch_bytes <= 0:
        return 0.0
    return float(bytes_accessed) / float(batch_bytes)
