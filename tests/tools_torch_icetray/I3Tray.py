"""Stand-in ``I3Tray``: a chain of an ``"I3Reader"`` (its
``FilenameList`` read in order), Python functions, called on physics
frames only (a frame a function returns ``False`` for is dropped), and
an ``"I3Writer"`` (its ``Filename``), which writes every frame that
reaches it but the geometry, calibration and detector-status ones."""

from icecube import dataio


class I3Tray:
    def __init__(self):
        self._modules = []

    def Add(self, module, name=None, **kwargs):
        self._modules.append((module, kwargs))

    def Execute(self):
        (reader, rkw), chain = self._modules[0], self._modules[1:]
        assert reader == "I3Reader", reader
        frames = []
        for path in rkw["FilenameList"]:
            f = dataio.I3File(path)
            while f.more():
                frames.append(f.pop_frame())
        writers = {i: dataio.I3File(kw["Filename"], "w")
                   for i, (module, kw) in enumerate(chain)
                   if module == "I3Writer"}
        for frame in frames:
            for i, (module, kw) in enumerate(chain):
                if i in writers:
                    if frame.Stop not in ("G", "C", "D"):
                        writers[i].push(frame)
                elif frame.Stop == "P" and module(frame) is False:
                    break
        for w in writers.values():
            w.close()

    def Finish(self):
        pass
