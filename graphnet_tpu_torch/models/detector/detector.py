"""Detector definitions: per-feature standardisation and geometry
(counterpart of ``graphnet_tpu/models/detector/detector.py``).

Standardisation runs on the host, on numpy event arrays: it is part of
the input pipeline, not the model.  A detector is a table of column
scalings plus its geometry metadata; :func:`make_detector` builds and
registers one from such a table.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List

import numpy as np


def affine(scale: float, offset: float = 0.0) -> Callable:
    """x -> (x + offset) / scale."""

    def fn(x: np.ndarray) -> np.ndarray:
        return (x + offset) / scale

    fn.kind = ("affine", scale, offset)  # type: ignore[attr-defined]
    return fn


def log10_scale(scale: float = 1.0) -> Callable:
    """x -> log10(x) / scale."""

    def fn(x: np.ndarray) -> np.ndarray:
        return np.log10(x) / scale

    fn.kind = ("log10", scale)  # type: ignore[attr-defined]
    return fn


def identity() -> Callable:
    """x -> x."""

    def fn(x: np.ndarray) -> np.ndarray:
        return x

    fn.kind = ("identity",)  # type: ignore[attr-defined]
    return fn


def mul_offset(scale: float, offset: float) -> Callable:
    """x -> x / scale + offset."""

    def fn(x: np.ndarray) -> np.ndarray:
        return x / scale + offset

    fn.kind = ("mul_offset", scale, offset)  # type: ignore[attr-defined]
    return fn


def scaled_shift(scale: float, offset: float, post: float) -> Callable:
    """x -> (x / scale + offset) * post."""

    def fn(x: np.ndarray) -> np.ndarray:
        return (x / scale + offset) * post

    fn.kind = ("scaled_shift", scale, offset, post)  # type: ignore
    return fn


class Detector:
    """Base detector: a ``feature_map`` of per-column scalings and the
    geometry's metadata (``xyz``, string and sensor id columns, the path
    of its geometry table)."""

    xyz: List[str] = []
    string_id_column: str = ""
    sensor_id_column: str = ""
    geometry_table_path: str = ""
    _feature_map: Dict[str, Callable] = {}

    def feature_map(self) -> Dict[str, Callable]:
        return self._feature_map

    @property
    def geometry_table(self):
        """The geometry table (a pandas DataFrame), read at first use."""
        if not hasattr(self, "_geometry_table"):
            import pandas as pd

            if not self.geometry_table_path:
                raise ValueError(
                    f"{type(self).__name__} has no geometry_table_path"
                )
            self._geometry_table = pd.read_parquet(self.geometry_table_path)
        return self._geometry_table

    @property
    def string_index_name(self) -> str:
        return self.string_id_column

    @property
    def sensor_position_names(self) -> List[str]:
        return self.xyz

    @property
    def sensor_index_name(self) -> str:
        return self.sensor_id_column

    def __call__(
        self, features: np.ndarray, feature_names: List[str]
    ) -> np.ndarray:
        """Standardise each column (a float32 copy).  A column with no
        registered scaling raises ``KeyError``."""
        fmap = self.feature_map()
        out = np.array(features, dtype=np.float32, copy=True)
        for i, name in enumerate(feature_names):
            if name not in fmap:
                raise KeyError(
                    f"No standardization function for feature {name!r} in "
                    f"{type(self).__name__}"
                )
            out[:, i] = fmap[name](out[:, i])
        return out


_DETECTOR_REGISTRY: Dict[str, type] = {}


def make_detector(
    name: str,
    geometry_dir: str,
    geometry_file: str,
    xyz: List[str],
    string_id: str,
    sensor_id: str,
    fmap: Dict[str, Callable],
    module: str,
    doc: str = "",
) -> type:
    """Create and register a Detector subclass from a scaling table.  The
    class belongs to ``module``, the module that binds its name, so it
    pickles by reference."""
    cls = type(
        name,
        (Detector,),
        {
            "geometry_table_path": os.path.join(geometry_dir, geometry_file),
            "xyz": xyz,
            "string_id_column": string_id,
            "sensor_id_column": sensor_id,
            "_feature_map": fmap,
            "__doc__": doc or f"Detector definition for {name}.",
            "__module__": module,
        },
    )
    _DETECTOR_REGISTRY[name] = cls
    return cls


def get_detector(name: str) -> Detector:
    return _DETECTOR_REGISTRY[name]()


def available_detectors() -> List[str]:
    return sorted(_DETECTOR_REGISTRY)
