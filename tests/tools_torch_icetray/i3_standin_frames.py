"""Frames and files of the IceTray stand-in (``icecube`` in this
directory), made from a seed: an IceCube-Upgrade-shaped GCD (sensor
keys, positions, axes, areas and types, relative efficiencies with some
sensors left uncalibrated) and physics frames with a pulse map and the
objects every IceTray extractor reads.  Importable where this
directory is on ``sys.path``."""

import pickle

import numpy as np
from icecube import dataclasses as dc
from icecube.icetray import I3Frame, OMKey

PULSEMAP = "SplitInIcePulses"
# sensor types of the IceCube Upgrade (IceCube DOM, mDOM, D-Egg)
OM_TYPES = (20, 110, 130)


def fake_gcd(rng, positions):
    """G, C and D frames for sensors at ``positions`` (``[n, 3]``), and
    the sensors' keys in that order: 60 a string, a PMT number each;
    every 17th sensor has no calibration entry."""
    keys, omgeo, dom_cal = [], {}, {}
    for j, (x, y, z) in enumerate(np.asarray(positions, np.float64)):
        key = OMKey(1 + j // 60, 1 + j % 60, int(rng.integers(0, 20)))
        axis = rng.normal(0.0, 0.5, 3)
        omgeo[key] = dc.I3OMGeo(
            dc.I3Position(x, y, z), dc.I3Orientation(*axis),
            area=float(rng.choice([0.0284, 0.0444, 0.0491])),
            omtype=int(rng.choice(OM_TYPES)))
        if j % 17:
            dom_cal[key] = dc.I3DOMCalibration(float(rng.choice([1.0, 1.35])))
        keys.append(key)
    g, c, d = I3Frame(I3Frame.Geometry), I3Frame(I3Frame.Calibration), \
        I3Frame(I3Frame.DetectorStatus)
    g["I3Geometry"] = dc.I3Geometry(omgeo)
    c["I3Calibration"] = dc.I3Calibration(dom_cal)
    return [g, c, d], keys


def pulse_map(rng, keys, doms, times, charges):
    """The pulses on sensors ``keys[doms[i]]`` at ``times`` with
    ``charges``: by sensor key, each sensor's in time order."""
    by_key = {}
    for d, t, q in zip(doms, times, charges):
        by_key.setdefault(keys[int(d)], []).append(dc.I3RecoPulse(
            charge=q, time=t, width=float(rng.choice([1.0, 4.0, 8.0])),
            flags=int(rng.choice([0, 2, 4, 6]))))
    out = dc.I3RecoPulseSeriesMap()
    for key in sorted(by_key):
        out[key] = dc.vector_I3RecoPulse(sorted(by_key[key],
                                                key=lambda p: p.time))
    return out


def _particle(rng, energy=None):
    return dc.I3Particle(
        energy=float(energy if energy is not None else 10 ** rng.uniform(0, 3)),
        pos=dc.I3Position(*rng.normal(0.0, 200.0, 3)),
        dir=dc.I3Direction(rng.uniform(0, np.pi), rng.uniform(0, 2 * np.pi)),
        time=float(rng.uniform(9e3, 1.1e4)),
        pdg_encoding=int(rng.choice([-14, -12, 12, 14, 16])),
        speed=0.299792458, length=float(rng.uniform(0, 500)))


def physics_frame(rng, keys, doms, times, charges, stream="InIceSplit",
                  truth=True):
    """A physics frame: the pulse map ``PULSEMAP`` (:func:`pulse_map`),
    an event header of ``stream``, a filter mask, and with ``truth`` the
    Monte-Carlo tree and weights, the QUESO selection flags, the
    reconstructions and labels the extractors read (each drawn from
    ``rng``)."""
    frame = I3Frame(I3Frame.Physics)
    pulses = pulse_map(rng, keys, doms, times, charges)
    frame[PULSEMAP] = pulses
    frame["I3EventHeader"] = dc.I3EventHeader(stream)
    frame["FilterMask"] = {
        name: dc.I3FilterResult(bool(rng.integers(0, 2)))
        for name in ("MuonFilter_13", "CascadeFilter_13", "DeepCoreFilter_13")}
    if not truth:
        return frame
    frame["I3MCTree"] = dc.I3MCTree([_particle(rng), _particle(rng)])
    frame["I3MCWeightDict"] = dc.I3MapStringDouble(
        InteractionType=float(rng.choice([1.0, 2.0])),
        BjorkenY=float(rng.uniform()), OneWeight=float(rng.uniform(1, 1e3)),
        NEvents=float(rng.integers(1, 1e4)), GENIEWeight=float(rng.uniform()))
    for key in ("QuesoL3_Bool", "QuesoL4_Bool"):
        frame[key] = dc.I3Bool(bool(rng.integers(0, 2)))
    frame["retro_crs_prefit__median__neutrino"] = _particle(rng)
    frame["SplineMPEIC"] = _particle(rng)
    frame["TUM_dnn_energy_hive"] = dc.I3Double(rng.uniform(1, 1e3))
    frame["DNNCascadeAnalysis_version_001_p00"] = dc.I3MapStringDouble(
        {k: float(v) for k, v in zip(
            ("angErr", "angErr_uncorrected", "dec", "dpsi", "energy", "event",
             "ra", "run", "subevent", "time", "trueDec", "trueE", "trueRa",
             "true_azi", "true_zen", "zen", "azi", "logE"),
            rng.uniform(0, 3, 18))})
    frame["classification"] = dc.I3Double(float(rng.integers(0, 4)))
    frame[PULSEMAP + "_truth"] = {
        key: [int(rng.integers(0, 2)) for _ in p] for key, p in pulses.items()}
    return frame


def random_frames(rng, keys, lengths, streams=("InIceSplit",)):
    """Physics frames of ``lengths`` pulses on random sensors of ``keys``
    (times 1e4 - 1.3e4 ns, gamma charges), their streams drawn from
    ``streams``, each after a DAQ frame."""
    frames = []
    for n in lengths:
        frames.append(I3Frame(I3Frame.DAQ))
        frames.append(physics_frame(
            rng, keys, rng.integers(0, len(keys), n),
            rng.uniform(1e4, 1.3e4, n), rng.gamma(2.0, 1.0, n) + 0.1,
            stream=str(rng.choice(streams))))
    return frames


def write_i3(path, frames):
    """A stand-in ``.i3`` file: the frames, pickled."""
    with open(path, "wb") as f:
        pickle.dump(list(frames), f)


def read_i3(path):
    with open(path, "rb") as f:
        return pickle.load(f)
