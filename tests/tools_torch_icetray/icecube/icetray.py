"""Stand-in ``icecube.icetray``: the logger switch, ``OMKey`` and
``I3Frame``."""


class I3NullLogger:
    pass


class I3Logger:
    global_logger = None


class OMKey(tuple):
    """(string, om, pmt), indexable as IceTray's."""

    def __new__(cls, string, om, pmt=0):
        return super().__new__(cls, (int(string), int(om), int(pmt)))

    def __getnewargs__(self):
        return tuple(self)

    string = property(lambda self: self[0])
    om = property(lambda self: self[1])
    pmt = property(lambda self: self[2])

    def __repr__(self):
        return f"OMKey({self[0]}, {self[1]}, {self[2]})"


class I3Frame:
    """A frame: a stop (its stream) and named objects."""

    Geometry, Calibration, DetectorStatus = "G", "C", "D"
    DAQ, Physics = "Q", "P"

    def __init__(self, stop="P"):
        self.Stop = stop
        self._items = {}

    def Has(self, key):
        return key in self._items

    def __contains__(self, key):
        return key in self._items

    def __getitem__(self, key):
        return self._items[key]

    def __setitem__(self, key, value):
        if key in self._items:
            raise RuntimeError(f"I3Frame already holds {key!r}")
        self._items[key] = value

    Put = __setitem__

    def Delete(self, key):
        del self._items[key]

    def keys(self):
        return list(self._items)

    def items(self):
        return list(self._items.items())

    def __eq__(self, other):
        return (type(other) is I3Frame and self.Stop == other.Stop
                and self._items == other._items)

    def __repr__(self):
        return f"I3Frame({self.Stop!r}, {sorted(self._items)})"
