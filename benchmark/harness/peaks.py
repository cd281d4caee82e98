"""Peaks of the card, from NVIDIA's H100 data sheet (dense rates, no
sparsity, at the full power limit of 700 W for the SXM part).  Copied
from ``chip_smoke.py``'s ``PEAKS`` (:400), with the TF32 rate added.

``tf32x3`` is the rate of an fp32 product formed as three TF32 products
on the tensor cores (the rel kernels' fp32 dots): a third of the TF32
rate.  It bounds from below the time of any product that such a kernel
may run that way."""

from __future__ import annotations

from typing import Dict

PEAKS: Dict[str, Dict[str, float]] = {
    "SXM": dict(bytes=3.35e12, fp32=67e12, tf32=495e12, bf16=989e12),
    "PCIe": dict(bytes=2.0e12, fp32=51e12, tf32=378e12, bf16=756e12),
}
for _p in PEAKS.values():
    _p["tf32x3"] = _p["tf32"] / 3.0


def peaks_for(device_name: str) -> Dict[str, float]:
    """The SXM table unless the card's name says PCIe."""
    return PEAKS["PCIe" if "PCIe" in device_name else "SXM"]


def dtype_peak(peaks: Dict[str, float], dtype: str) -> float:
    """The matmul peak of a configuration's dtype (fp32 outside the tensor
    cores: the port turns TF32 off)."""
    return peaks["bf16"] if dtype in ("bfloat16", "float16") else peaks["fp32"]
