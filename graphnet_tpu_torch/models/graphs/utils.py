"""Host-side (numpy) helpers of graph construction (counterpart of
``graphnet_tpu/models/graphs/utils.py``; the ice-transparency
interpolators so far).

The ice table is read from ``ice_transparency.txt`` beside this module:
a plain-text copy of ``data/ice_properties/ice_transparency.parquet``
(110 rows of depth, scattering and absorption length, each float written
with ``repr``, so it reads back bit for bit), because pandas is not a
dependency of the port.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np

ICE_TRANSPARENCY_TABLE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "ice_transparency.txt"
)


def ice_transparency_table() -> np.ndarray:
    """The ice table, ``[110, 3]`` float64: depth, scattering length,
    absorption length."""
    return np.loadtxt(ICE_TRANSPARENCY_TABLE, dtype=np.float64, ndmin=2)


def ice_transparency(
    z_offset: Optional[float] = None, z_scaling: Optional[float] = None
) -> Tuple[Callable, Callable]:
    """Interpolators of the normalised IceCube scattering and absorption
    lengths over the normalised depth ``(depth + z_offset) / z_scaling``
    (defaults -1950 and 500: pulses with z scaled by 1/500).  Each length
    is robust-scaled: its median subtracted, divided by its interquartile
    range."""
    from scipy.interpolate import interp1d

    table = ice_transparency_table()
    z_offset = z_offset if z_offset is not None else -1950.0
    z_scaling = z_scaling if z_scaling is not None else 500.0
    z_norm = (table[:, 0] + z_offset) / z_scaling

    def robust(col: np.ndarray) -> np.ndarray:
        med = np.median(col)
        q1, q3 = np.percentile(col, [25, 75])
        return (col - med) / (q3 - q1)

    scatt = robust(table[:, 1])
    absorb = robust(table[:, 2])
    return interp1d(z_norm, scatt), interp1d(z_norm, absorb)
