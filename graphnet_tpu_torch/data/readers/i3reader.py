"""I3Reader: physics frames of IceTray ``.i3`` files through filters
and extractors (counterpart of ``graphnet_tpu/data/readers/i3reader.py``).

Finding and pairing files (``find_files``) and filtering frames
(``_skip_frame``) are plain Python; decoding ``.i3`` files
(``__call__``) needs IceTray.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Union

from graphnet_tpu_torch.data.extractors.icecube import I3Extractor
from graphnet_tpu_torch.data.filesys import find_i3_files
from graphnet_tpu_torch.data.i3_filters import I3Filter, NullSplitI3Filter
from graphnet_tpu_torch.data.readers.reader import GraphNeTFileReader
from graphnet_tpu_torch.utils.imports import has_icecube_package

# decode failures in a row after which a file is given up
MAX_CONSECUTIVE_FAILURES = 100


@dataclass(frozen=True)
class I3FileSet:
    """An ``.i3`` data file and its GCD file."""

    i3_file: str
    gcd_file: str


class I3Reader(GraphNeTFileReader):
    """Pops the physics frames of I3 files, drops those a filter rejects
    and applies the extractors to the rest."""

    _accepted_file_extensions = [".bz2", ".zst", ".gz"]
    _accepted_extractors = [I3Extractor]

    def __init__(
        self,
        gcd_rescue: str,
        i3_filters: Union[I3Filter, List[I3Filter], None] = None,
        icetray_verbose: int = 0,
    ):
        """Args:
        gcd_rescue: the GCD file of folders that hold I3 files and no
            GCD file of their own.
        i3_filters: frame filters; ``NullSplitI3Filter`` by default.
        icetray_verbose: IceTray's log verbosity; 0 silences its logger.
        """
        super().__init__()
        assert isinstance(gcd_rescue, str)
        if has_icecube_package() and icetray_verbose == 0:
            from icecube import icetray  # pyright: ignore

            icetray.I3Logger.global_logger = icetray.I3NullLogger()
        if i3_filters is None:
            i3_filters = [NullSplitI3Filter()]
        self._gcd_rescue = gcd_rescue
        self._i3filters = (
            i3_filters if isinstance(i3_filters, list) else [i3_filters])

    def __call__(self, file_path: I3FileSet) -> List[Dict[str, Any]]:
        """One dict ``{extractor name: columns}`` a kept physics frame of
        ``file_path.i3_file``.  A frame whose decoding raises an error
        that names ``I3`` is skipped; after ``MAX_CONSECUTIVE_FAILURES``
        in a row the rest of the file is given up."""
        from icecube import dataio  # pyright: ignore

        for extractor in self._extractors:
            extractor.set_gcd(
                i3_file=file_path.i3_file, gcd_file=file_path.gcd_file)
        io = dataio.I3File(file_path.i3_file, "r")
        data = []
        consecutive_failures = 0
        while io.more():
            try:
                frame = io.pop_physics()
                consecutive_failures = 0
            except Exception as e:
                if "I3" in str(e):
                    # a stream that fails without advancing would spin
                    consecutive_failures += 1
                    if consecutive_failures > MAX_CONSECUTIVE_FAILURES:
                        self.warning(
                            f"abandoning {file_path.i3_file} after "
                            "repeated frame decode failures")
                        break
                    continue
                raise
            if self._skip_frame(frame):
                continue
            results = [extractor(frame) for extractor in self._extractors]
            data.append(dict(zip(self.extractor_names, results)))
        return data

    def find_files(self, path: Union[str, List[str]]) -> List[I3FileSet]:
        """The I3 files under ``path`` (recursively), each with its GCD
        file."""
        i3_files, gcd_files = find_i3_files(path, self._gcd_rescue)
        assert len(i3_files) == len(gcd_files)
        return [I3FileSet(i3, gcd) for i3, gcd in zip(i3_files, gcd_files)]

    def _skip_frame(self, frame) -> bool:
        """Whether a filter rejects ``frame``."""
        return any(not f(frame) for f in self._i3filters)
