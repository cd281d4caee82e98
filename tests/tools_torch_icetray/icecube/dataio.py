"""Stand-in ``icecube.dataio``: ``I3File`` over the stand-in's files
(a pickled list of frames).  A frame whose ``Stop`` is ``"X"`` stands
for one that does not decode: ``pop_physics`` raises at it without
moving on, as a corrupt stream does."""

import pickle


class I3File:
    def __init__(self, path, mode="r"):
        self._path, self._mode = str(path), mode
        self._pos = 0
        if mode == "r":
            with open(self._path, "rb") as f:
                self._frames = pickle.load(f)
        else:
            self._frames = []

    def more(self):
        return self._pos < len(self._frames)

    def pop_frame(self):
        frame = self._frames[self._pos]
        self._pos += 1
        return frame

    def pop_physics(self):
        while self.more():
            if self._frames[self._pos].Stop == "X":
                raise RuntimeError("I3File: frame does not decode")
            frame = self.pop_frame()
            if frame.Stop == "P":
                return frame
        raise RuntimeError("I3File: no physics frame left")

    def push(self, frame):
        self._frames.append(frame)

    def close(self):
        if self._mode == "w":
            with open(self._path, "wb") as f:
                pickle.dump(self._frames, f)
