"""The IceTray stand-in of the port's tests: this directory holds an
``icecube`` package and an ``I3Tray`` module (see ``icecube/__init__.py``)
and ``i3_standin_frames``, which makes frames and files for them.  The
``icetray`` fixture puts the directory on ``sys.path`` for one test and
takes the stand-in's modules out of ``sys.modules`` after it, so that
IceTray is absent again for every other test of the process."""

import sys
from pathlib import Path

import pytest

STANDIN = Path(__file__).resolve().parent
MODULES = ("icecube", "I3Tray", "i3_standin_frames")


@pytest.fixture
def icetray(monkeypatch):
    """The stand-in importable for one test; yields ``i3_standin_frames``."""
    monkeypatch.syspath_prepend(str(STANDIN))
    yield __import__("i3_standin_frames")
    for name in list(sys.modules):
        if name.split(".")[0] in MODULES:
            del sys.modules[name]
