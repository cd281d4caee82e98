"""Discovery of IceTray files (counterpart of
``graphnet_tpu/data/filesys.py``): ``.i3`` data files, each paired with
its folder's GCD (geometry, calibration, detector status) file.

Plain Python: only reading the files found needs IceTray.
"""

from __future__ import annotations

import random
import re
from pathlib import Path
from typing import List, Optional, Tuple, Union


def has_extension(filename: str, extensions: List[str]) -> bool:
    """Whether ``filename`` ends in one of ``extensions``."""
    return bool(re.search("(" + "|".join(extensions) + ")$", filename))


def pairwise_shuffle(
    i3_list: List[str], gcd_list: List[str], seed: Optional[int] = None
) -> Tuple[List[str], List[str]]:
    """Shuffle I3 files and their GCD files together (to even out the
    load of conversion workers); the order of ``random.Random(seed)``,
    so a seed pairs the files as the JAX package does."""
    order = list(range(len(i3_list)))
    random.Random(seed).shuffle(order)
    return [i3_list[i] for i in order], [gcd_list[i] for i in order]


def is_gcd_file(filename: str) -> bool:
    """Whether ``filename`` names a GCD file."""
    return bool(re.search("(gcd|geo)", filename.lower())
                or "GeoCalibDetector" in filename)


def is_i3_file(filename: str) -> bool:
    """Whether ``filename`` names a compressed I3 data file (not a GCD
    file)."""
    if is_gcd_file(filename):
        return False
    return bool(re.search(r"(bz2|zst|gz)$", filename))


def find_i3_files(
    directories: Union[str, List[str]],
    gcd_rescue: Optional[str] = None,
    recursive: bool = True,
) -> Tuple[List[str], List[str]]:
    """The I3 files under ``directories``, each paired with its folder's
    GCD file.

    A folder of I3 files holds one GCD file; a folder with none takes
    ``gcd_rescue`` (and raises without it); a folder with two raises.

    Returns:
        ``(i3_files, gcd_files)``, one GCD file an I3 file.
    """
    if isinstance(directories, str):
        directories = [directories]
    i3_files: List[str] = []
    gcd_files: List[str] = []
    for directory in directories:
        root = Path(directory)
        globber = root.rglob if recursive else root.glob
        paths: List[Path] = []
        for pattern in ("*.bz2", "*.zst", "*.gz"):
            paths.extend(globber(pattern))
        for folder in sorted({p.parent for p in paths}):
            folder_files = sorted(str(p) for p in paths if p.parent == folder)
            folder_i3 = [f for f in folder_files if is_i3_file(f)]
            folder_gcd = [f for f in folder_files if is_gcd_file(f)]
            if len(folder_gcd) > 1:
                raise RuntimeError(
                    f"multiple GCD files in {folder}: {folder_gcd}")
            if not folder_gcd:
                if gcd_rescue is None:
                    raise RuntimeError(
                        f"no GCD file in {folder} and no gcd_rescue given")
                folder_gcd = [gcd_rescue]
            i3_files.extend(folder_i3)
            gcd_files.extend(folder_gcd * len(folder_i3))
    return i3_files, gcd_files
