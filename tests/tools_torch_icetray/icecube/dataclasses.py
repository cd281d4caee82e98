"""Stand-in ``icecube.dataclasses``: the frame objects the extractors
and the deployment modules read and write.  The pulse flag values are
the stand-in's own."""


class _Record:
    """Attributes from keywords; equal when of one type with equal
    attributes."""

    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)

    def __eq__(self, other):
        return type(other) is type(self) and vars(other) == vars(self)

    def __repr__(self):
        return f"{type(self).__name__}({vars(self)})"


class I3Double(_Record):
    def __init__(self, value=0.0):
        super().__init__(value=float(value))


class I3Bool(_Record):
    def __init__(self, value=False):
        super().__init__(value=bool(value))


class I3Position(_Record):
    def __init__(self, x=0.0, y=0.0, z=0.0):
        super().__init__(x=float(x), y=float(y), z=float(z))


class I3Direction(_Record):
    def __init__(self, zenith=0.0, azimuth=0.0):
        super().__init__(zenith=float(zenith), azimuth=float(azimuth))


class I3Orientation(_Record):
    """A sensor's axis, ``x, y, z``."""

    def __init__(self, x=0.0, y=0.0, z=1.0):
        super().__init__(x=float(x), y=float(y), z=float(z))


class I3OMGeo(_Record):
    def __init__(self, position, orientation, area, omtype):
        super().__init__(position=position, orientation=orientation,
                         area=float(area), omtype=omtype)


class I3Geometry(_Record):
    def __init__(self, omgeo):
        super().__init__(omgeo=dict(omgeo))


class I3DOMCalibration(_Record):
    def __init__(self, relative_dom_eff):
        super().__init__(relative_dom_eff=float(relative_dom_eff))


class I3Calibration(_Record):
    def __init__(self, dom_cal):
        super().__init__(dom_cal=dict(dom_cal))


class I3RecoPulse(_Record):
    class PulseFlags:
        LC = 2
        ATWD = 4
        FADC = 8

    def __init__(self, charge=0.0, time=0.0, width=0.0, flags=0):
        super().__init__(charge=float(charge), time=float(time),
                         width=float(width), flags=int(flags))


class vector_I3RecoPulse(list):
    pass


class I3RecoPulseSeriesMap(dict):
    """OMKey -> pulses, in the order the keys were put in."""

    @staticmethod
    def from_frame(frame, key):
        return frame[key]


class I3EventHeader(_Record):
    def __init__(self, sub_event_stream="InIceSplit", run_id=0, event_id=0):
        super().__init__(sub_event_stream=sub_event_stream, run_id=run_id,
                         event_id=event_id)


class I3FilterResult(_Record):
    def __init__(self, condition_passed=False):
        super().__init__(condition_passed=bool(condition_passed))


class I3Particle(_Record):
    def __init__(self, energy=0.0, pos=None, dir=None, time=0.0,
                 pdg_encoding=0, speed=0.0, length=0.0):
        super().__init__(energy=float(energy), pos=pos or I3Position(),
                         dir=dir or I3Direction(), time=float(time),
                         pdg_encoding=int(pdg_encoding), speed=float(speed),
                         length=float(length))


class I3MCTree(list):
    """Particles, the primaries first (``n_primaries`` of them)."""

    def __init__(self, particles=(), n_primaries=1):
        super().__init__(particles)
        self.n_primaries = n_primaries

    def get_primaries(self):
        return list(self[: self.n_primaries])


class I3MapStringDouble(dict):
    pass


class I3MapStringBool(dict):
    pass
