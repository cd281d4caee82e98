"""Frame filters of the I3 conversion (counterpart of
``graphnet_tpu/data/i3_filters.py``).

A filter reads a frame through IceTray's frame interface
(``frame.Has``, ``key in frame``, ``frame[key]``) only, so any object
with that interface can be filtered; decoding ``.i3`` files needs
IceTray.
"""

from __future__ import annotations

from typing import List

from graphnet_tpu_torch.utils.logging import Logger


class I3Filter(Logger):
    """A frame filter: ``filter(frame)`` is whether the frame is kept."""

    def _keep_frame(self, frame) -> bool:
        raise NotImplementedError

    def __call__(self, frame) -> bool:
        keep = self._keep_frame(frame)
        if not isinstance(keep, bool):
            raise TypeError(
                f"expected _keep_frame to return bool, got {type(keep)}")
        return keep


class NullSplitI3Filter(I3Filter):
    """Drops the frames of the ``NullSplit`` sub-event stream."""

    def _keep_frame(self, frame) -> bool:
        if frame.Has("I3EventHeader"):
            if frame["I3EventHeader"].sub_event_stream == "NullSplit":
                return False
        return True


class SubEventStreamI3Filter(I3Filter):
    """Keeps only the frames of the named sub-event streams (and frames
    without an event header)."""

    def __init__(self, selection: List[str]):
        super().__init__()
        self._selection = list(selection)

    def _keep_frame(self, frame) -> bool:
        if frame.Has("I3EventHeader"):
            if frame["I3EventHeader"].sub_event_stream not in self._selection:
                return False
        return True


class I3FilterMask(I3Filter):
    """Keeps the frames that pass the named entries of their
    ``FilterMask``: any of them (``filter_any``) or all.  Entries that a
    frame's mask lacks are left out with a warning; a frame with no mask,
    or none of the entries, is kept."""

    def __init__(self, filter_names: List[str], filter_any: bool = True):
        super().__init__()
        self._filter_names = list(filter_names)
        self._filter_any = filter_any

    def _keep_frame(self, frame) -> bool:
        if "FilterMask" not in frame:
            self.warning_once(
                "FilterMask not found in frame; filter not applied.")
            return True
        mask = frame["FilterMask"]
        flags = []
        for name in self._filter_names:
            if name not in mask:
                self.warning_once(
                    f"FilterMask {name} not found in frame; skipping.")
                continue
            flags.append(bool(mask[name].condition_passed))
        if not flags:
            self.warning_once(
                "none of the FilterMask filters found in frame; "
                "filters not applied.")
            return True
        return any(flags) if self._filter_any else all(flags)
