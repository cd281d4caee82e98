"""The port's IceTray half against the JAX package's on the CPU, through
the test stand-in for IceTray (``tests/tools_torch_icetray``): file
discovery, frame filters, every extractor, ``I3Reader``, the I3
converters, ``I3InferenceModule`` and ``I3PulseCleanerModule`` on a
narrow QUESO-shaped DynEdge, and ``I3Deployer`` with two spawned
workers.  Both packages get the same frames, made from a numpy seed.

The stand-in is importable as ``icecube`` only inside the ``icetray``
fixture: outside it, IceTray is absent, as on every host here."""

import copy
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax

import graphnet_tpu.utils.config as jconfig
from graphnet_tpu.data import filesys as jfilesys
from graphnet_tpu.data import i3_filters as jfilters
from graphnet_tpu.data import pre_configured as jpre
from graphnet_tpu.data.extractors import icecube as jext
from graphnet_tpu.data.readers import i3reader as jreader
from graphnet_tpu.deployment import icecube as jdeploy
from graphnet_tpu.deployment.deployment_module import (
    DeploymentModule as JaxDeploymentModule,
)
from graphnet_tpu.utils.imports import has_icecube_package as jax_has_icecube
import graphnet_tpu_torch.data.dataconverter as tdc
from graphnet_tpu_torch.data import filesys as tfilesys
from graphnet_tpu_torch.data import i3_filters as tfilters
from graphnet_tpu_torch.data import pre_configured as tpre
from graphnet_tpu_torch.data.extractors import icecube as text
from graphnet_tpu_torch.data.readers import i3reader as treader
from graphnet_tpu_torch.deployment import icecube as tdeploy
from graphnet_tpu_torch.utils import config as tconfig
from graphnet_tpu_torch.utils.imports import has_icecube_package
from tests.test_torch_dataconverter import (
    _files,
    assert_same_parquet,
    assert_same_sqlite,
)
from tests.tools_torch_icetray import STANDIN, icetray  # noqa: F401

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
QUESO = ROOT / "configs" / "models" / "zoo" / "queso"
NARROW = dict(dynedge_layer_sizes=[[16, 32], [24, 32]],
              post_processing_layer_sizes=[24, 16], readout_layer_sizes=[8])
LENGTHS = (0, 1, 9, 30, 64)


def _gcd_and_frames(F, seed=0, n_sensors=40, lengths=LENGTHS,
                    streams=("InIceSplit",)):
    rng = np.random.default_rng(seed)
    gcd, keys = F.fake_gcd(rng, rng.normal(0.0, 150.0, (n_sensors, 3)))
    return gcd, keys, F.random_frames(rng, keys, lengths, streams)


def _tree(tmp_path, F, seed=0):
    """Two folders of stand-in files: ``a`` with its own GCD file, ``b``
    without (the rescue GCD's)."""
    gcd, keys, _ = _gcd_and_frames(F, seed)
    rng = np.random.default_rng(seed + 1)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    F.write_i3(tmp_path / "a" / "GeoCalibDetectorStatus_a.i3.gz", gcd)
    rescue = tmp_path / "rescue_gcd.i3.gz"
    F.write_i3(rescue, gcd)
    for name, lengths in (("a/run1.i3.bz2", (5, 0, 12)),
                          ("a/run2.i3.zst", (3,)), ("b/run3.i3.gz", (7, 20))):
        F.write_i3(tmp_path / name, F.random_frames(
            rng, keys, lengths, ("InIceSplit", "NullSplit")))
    return str(tmp_path), str(rescue)


# --- file discovery ---------------------------------------------------------


@pytest.mark.parametrize("name", [
    "GeoCalibDetectorStatus_2020.i3.gz", "somefile_gcd.i3.zst",
    "oscNext_genie_run1.i3.bz2", "readme.txt", "run_GEO.i3.gz", "x.i3"])
def test_file_kinds_match_jax(name):
    assert tfilesys.is_gcd_file(name) == jfilesys.is_gcd_file(name)
    assert tfilesys.is_i3_file(name) == jfilesys.is_i3_file(name)
    for ext in (["bz2", "zst", "gz"], [".i3"], ["txt"]):
        assert (tfilesys.has_extension(name, ext)
                == jfilesys.has_extension(name, ext))


def test_find_and_shuffle_match_jax(tmp_path, icetray):
    root, rescue = _tree(tmp_path, icetray)
    got = tfilesys.find_i3_files(root, gcd_rescue=rescue)
    assert got == jfilesys.find_i3_files(root, gcd_rescue=rescue)
    assert len(got[0]) == 3 and got[1][-1] == rescue
    assert (tfilesys.find_i3_files(root + "/a", recursive=False)
            == jfilesys.find_i3_files(root + "/a", recursive=False))
    for seed in (0, 7):
        assert (tfilesys.pairwise_shuffle(*got, seed=seed)
                == jfilesys.pairwise_shuffle(*got, seed=seed))
    i3 = [f"f{i}.i3.gz" for i in range(10)]
    gcd = [f"g{i}.i3.gz" for i in range(10)]
    shuffled = tfilesys.pairwise_shuffle(i3, gcd, seed=7)
    assert shuffled == jfilesys.pairwise_shuffle(i3, gcd, seed=7)
    assert shuffled[0] != i3
    with pytest.raises(RuntimeError, match="no GCD"):
        tfilesys.find_i3_files(root + "/b")
    F = icetray
    F.write_i3(tmp_path / "a" / "second_gcd.i3.gz", [])
    with pytest.raises(RuntimeError, match="multiple GCD files"):
        tfilesys.find_i3_files(root, gcd_rescue=rescue)
    with pytest.raises(RuntimeError, match="multiple GCD files"):
        jfilesys.find_i3_files(root, gcd_rescue=rescue)


# --- filters ----------------------------------------------------------------


FILTERS = {
    "null_split": lambda m: m.NullSplitI3Filter(),
    "sub_event_stream": lambda m: m.SubEventStreamI3Filter(["InIceSplit"]),
    "mask_any": lambda m: m.I3FilterMask(["MuonFilter_13", "CascadeFilter_13"]),
    "mask_all": lambda m: m.I3FilterMask(
        ["MuonFilter_13", "CascadeFilter_13"], filter_any=False),
    "mask_partly_missing": lambda m: m.I3FilterMask(
        ["DeepCoreFilter_13", "NotThere"], filter_any=False),
    "mask_missing": lambda m: m.I3FilterMask(["NotThere"]),
}


@pytest.mark.parametrize("kind", FILTERS)
def test_filters_match_jax(kind, icetray):
    _, _, frames = _gcd_and_frames(
        icetray, lengths=(3,) * 24, streams=("InIceSplit", "NullSplit", "Other"))
    frames = [f for f in frames if f.Stop == "P"] + [type(frames[0])()]
    port, jax_ = FILTERS[kind](tfilters), FILTERS[kind](jfilters)
    got = [port(f) for f in frames]
    assert got == [jax_(f) for f in frames]
    assert all(isinstance(k, bool) for k in got)
    if kind in ("null_split", "sub_event_stream", "mask_any", "mask_all"):
        assert 0 < sum(got) < len(got)
    if kind.startswith("mask_"):
        assert got[-1]  # a frame without a FilterMask is kept
        # each warning once: a missing entry, none found, no mask
        assert port._warned == jax_._warned
        assert len(port._warned) == {"mask_partly_missing": 2,
                                     "mask_missing": 3}.get(kind, 1)


def test_filter_must_return_bool():
    for m in (tfilters, jfilters):
        class Bad(m.I3Filter):
            def _keep_frame(self, frame):
                return 1

        with pytest.raises(TypeError, match="bool"):
            Bad()(None)


# --- extractors -------------------------------------------------------------


EXTRACTORS = {
    "IceCube86": lambda m: m.I3FeatureExtractorIceCube86("SplitInIcePulses"),
    "DeepCore": lambda m: m.I3FeatureExtractorIceCubeDeepCore("SplitInIcePulses"),
    "Upgrade": lambda m: m.I3FeatureExtractorIceCubeUpgrade("SplitInIcePulses"),
    "NoiseTruthFlag": lambda m: m.I3PulseNoiseTruthFlagIceCubeUpgrade(
        "SplitInIcePulses"),
    "missing_pulsemap": lambda m: m.I3FeatureExtractorIceCubeUpgrade("NotThere"),
    "Retro": lambda m: m.I3RetroExtractor(),
    "SplineMPEIC": lambda m: m.I3SplineMPEICExtractor(),
    "TUM": lambda m: m.I3TUMExtractor(),
    "Particle": lambda m: m.I3ParticleExtractor("SplineMPEIC"),
    "FrameObject": lambda m: m.I3FrameObjectExtractor(
        "I3EventHeader", {"run": "run_id", "stream": "sub_event_stream"}),
    "QUESO": lambda m: m.I3QUESOExtractor(),
    "Generic": lambda m: m.I3GenericExtractor(exclude_keys=["FilterMask"]),
    "Generic_keys": lambda m: m.I3GenericExtractor(
        keys=["SplineMPEIC", "I3MCTree", "NotThere"]),
    "Truth": lambda m: m.I3TruthExtractor(),
    "GalacticPlaneHybridReco": lambda m: m.I3GalacticPlaneHybridRecoExtractor(),
    "NTMuonLabel": lambda m: m.I3NTMuonLabelExtractor(),
    "PISA": lambda m: m.I3PISAExtractor(),
}


@pytest.mark.parametrize("kind", EXTRACTORS)
def test_extractors_match_jax(kind, icetray, tmp_path):
    """Each extractor of both packages on the same frames (a GCD from
    the stand-in file; frames of 0-64 pulses, one without truth), the
    same columns and values."""
    gcd, _, frames = _gcd_and_frames(icetray)
    path = tmp_path / "gcd.i3.gz"
    icetray.write_i3(path, gcd)
    frames = [f for f in frames if f.Stop == "P"]
    frames.append(type(frames[0])())  # an empty frame
    port, jax_ = EXTRACTORS[kind](text), EXTRACTORS[kind](jext)
    assert port.name == jax_.name
    for e in (port, jax_):
        e.set_gcd(i3_file=str(path), gcd_file=str(path))
    outs = [port(f) for f in frames]
    assert outs == [jax_(f) for f in frames]
    assert any(outs)
    if kind == "Upgrade":
        out = outs[-2]
        assert len(out) == 16 and len(out["dom_x"]) == LENGTHS[-1]
        assert set(out["hlc"]) <= {0, 1} and -1.0 in out["rde"]


def test_frame_helpers_and_combined_extractor(icetray, tmp_path):
    gcd, _, frames = _gcd_and_frames(icetray, lengths=(4, 2))
    frames = [f for f in frames if f.Stop == "P"]
    bare = type(frames[0])()
    for f in frames + [bare]:
        assert text.frame_is_montecarlo(f) == jext.frame_is_montecarlo(f)
        assert text.frame_is_noise(f) == jext.frame_is_noise(f)
    assert text.frame_is_noise(bare) and not text.frame_is_noise(frames[0])
    from graphnet_tpu.data.extractors.extractor import (
        CombinedExtractor as JaxCombined,
    )
    from graphnet_tpu_torch.data.extractors.extractor import CombinedExtractor

    path = tmp_path / "gcd.i3.gz"
    icetray.write_i3(path, gcd)
    got, exp = (C([m.I3FeatureExtractorIceCube86("SplitInIcePulses"),
                   m.I3FeatureExtractorIceCubeUpgrade("SplitInIcePulses")],
                  "pulses") for C, m in ((CombinedExtractor, text),
                                         (JaxCombined, jext)))
    got.set_gcd(str(path))
    exp.set_gcd(str(path))
    assert [got(f) for f in frames] == [exp(f) for f in frames]


# --- reader -----------------------------------------------------------------


def _reader(m_reader, m_ext, m_filters, rescue, filters=None):
    reader = m_reader.I3Reader(gcd_rescue=rescue, i3_filters=filters)
    reader.set_extractors([m_ext.I3FeatureExtractorIceCubeUpgrade(
        "SplitInIcePulses"), m_ext.I3TruthExtractor()])
    return reader


def test_reader_matches_jax(tmp_path, icetray):
    """Both readers over the same stand-in files: the same file sets, the
    same dicts (NullSplit frames dropped by default); a subevent filter;
    a stream that stops decoding is given up after 100 failures in a
    row, as in the JAX package."""
    from icecube import icetray as standin

    root, rescue = _tree(tmp_path, icetray)
    port = _reader(treader, text, tfilters, rescue)
    jax_ = _reader(jreader, jext, jfilters, rescue)
    assert isinstance(standin.I3Logger.global_logger, standin.I3NullLogger)
    assert port.accepted_file_extensions == jax_.accepted_file_extensions
    sets = port.find_files(root)
    assert [(s.i3_file, s.gcd_file) for s in sets] == [
        (s.i3_file, s.gcd_file) for s in jax_.find_files(root)]
    n = 0
    for s in sets:
        got = port(s)
        assert got == jax_(jreader.I3FileSet(s.i3_file, s.gcd_file))
        n += len(got)
        assert all(set(d) == {"SplitInIcePulses", "truth"} for d in got)
    assert 0 < n < 6  # NullSplit frames dropped
    both = [tfilters.NullSplitI3Filter(),
            tfilters.SubEventStreamI3Filter(["InIceSplit"])]
    sub = _reader(treader, text, tfilters, rescue, both)
    other = _gcd_and_frames(icetray, lengths=(1,), streams=("Other",))[2][1]
    assert sub._skip_frame(other) and not port._skip_frame(other)
    # a frame that does not decode: the frames before it, then give up
    frames = icetray.read_i3(sets[0].i3_file)
    broken = type(frames[0])("X")
    path = tmp_path / "a" / "broken.i3.gz"
    icetray.write_i3(path, frames[:2] + [broken] + frames[2:])
    got = port(treader.I3FileSet(str(path), sets[0].gcd_file))
    assert got == jax_(jreader.I3FileSet(str(path), sets[0].gcd_file))
    assert len(got) == (frames[1]["I3EventHeader"].sub_event_stream
                        != "NullSplit")


# --- converters -------------------------------------------------------------


@pytest.mark.parametrize("backend", ["sqlite", "parquet"])
def test_converters_match_jax(backend, tmp_path, icetray):
    """``I3ToSQLiteConverter`` / ``I3ToParquetConverter`` of both packages
    over the same stand-in files: the same files and tables, ``event_no``
    included; then the merged outputs."""
    (tmp_path / "raw").mkdir()
    root, rescue = _tree(tmp_path / "raw", icetray)
    name = "I3ToSQLiteConverter" if backend == "sqlite" else "I3ToParquetConverter"
    outs = {}
    for tag, pre, ext in (("port", tpre, text), ("jax", jpre, jext)):
        outdir = tmp_path / tag
        converter = getattr(pre, name)(
            gcd_rescue=rescue, outdir=str(outdir),
            extractors=[ext.I3FeatureExtractorIceCubeUpgrade("SplitInIcePulses"),
                        ext.I3TruthExtractor(), ext.I3QUESOExtractor()])
        converter(root)
        converter.merge_files()
        outs[tag] = outdir
    files = _files(outs["port"])
    assert files and files == _files(outs["jax"])
    assert any("merged" in f for f in files)
    for f in files:
        got, exp = outs["port"] / f, outs["jax"] / f
        if f.endswith(".db"):
            assert_same_sqlite(got, exp)
        elif f.endswith(".parquet"):
            assert_same_parquet(got, exp)


def test_converter_pipeline_without_icetray(tmp_path):
    """Without IceTray the converters build their pipeline; reading an
    ``.i3`` file is what needs it."""
    assert not has_icecube_package() and not jax_has_icecube()
    rescue = tmp_path / "gcd.i3.gz"
    rescue.write_bytes(b"g")
    for cls in (tpre.I3ToSQLiteConverter, tpre.I3ToParquetConverter):
        conv = cls(gcd_rescue=str(rescue), extractors=[text.I3PISAExtractor()],
                   outdir=str(tmp_path / "out"))
        assert conv._file_reader.extractor_names == ["pisa_dependencies"]
        with pytest.raises(TypeError, match="not supported"):
            cls(gcd_rescue=str(rescue), outdir=str(tmp_path),
                extractors=[tdc.Extractor("x")])


# --- deployment -------------------------------------------------------------


def _queso_files(tmp_path, name, seed=5):
    """The zoo file ``name`` with a narrow DynEdge and random JAX-layout
    weights for it: ``(model.yml, state_dict.pkl, graph_definition.yml)``."""
    from graphnet_tpu.batch import make_batch as jax_make_batch

    with open(QUESO / name / "model.yml") as f:
        d = yaml.safe_load(f)
    args = d["arguments"]["backbone"]["__model__"]["arguments"]
    args.update(copy.deepcopy(NARROW))
    yml, pkl = tmp_path / "model.yml", tmp_path / "state_dict.pkl"
    yml.write_text(yaml.safe_dump(d, sort_keys=False))
    jmodel = jconfig.load_model(str(yml))
    batch = jax_make_batch([np.zeros((4, 14), np.float32)], length=16)
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.5
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    params = jax.tree_util.tree_map(
        draw, jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch))
    head = params["params"]["tasks_0"]["affine"]
    head["kernel"] = head["kernel"] * 1e-2
    with open(pkl, "wb") as f:
        pickle.dump(params, f)
    return str(yml), str(pkl), str(QUESO / name / "graph_definition.yml")


def _queso_extractor(m):
    """The Upgrade extractor with exactly the QUESO graph definition's
    columns, in its order (what the JAX module can serve)."""
    names = yaml.safe_load((QUESO / "total_neutrino_energy" /
                            "graph_definition.yml").read_text())[
        "arguments"]["input_feature_names"]

    class QUESOColumns(m.I3FeatureExtractorIceCubeUpgrade):
        def __call__(self, frame):
            out = super().__call__(frame)
            return {k: out[k] for k in names}

    return QUESOColumns("SplitInIcePulses")


def _served_frames(F, gcd_path, seed=3):
    rng = np.random.default_rng(seed)
    gcd, keys = F.fake_gcd(rng, rng.normal(0.0, 150.0, (40, 3)))
    F.write_i3(gcd_path, gcd)
    frames = F.random_frames(rng, keys, LENGTHS)
    return [f for f in frames if f.Stop == "P"]


def test_inference_module_matches_jax(tmp_path, icetray):
    """``I3InferenceModule`` of both packages on the same frames: the
    ``I3Double``s within rtol 1e-5 (fp32); the port's module with the
    whole Upgrade extractor (it takes the graph definition's columns by
    name) the same bits; the JAX module with it raises, as its graph
    definition refuses 16 columns (a known divergence)."""
    yml, pkl, gd_path = _queso_files(tmp_path, "total_neutrino_energy")
    gcd = tmp_path / "gcd.i3.gz"
    frames = _served_frames(icetray, gcd)
    common = dict(model_config=yml, state_dict=pkl, gcd_file=str(gcd),
                  model_name="queso")
    port = tdeploy.I3InferenceModule(
        pulsemap_extractor=_queso_extractor(text), device="cpu", **common)
    port.set_graph_definition(tconfig.load_model(gd_path))
    jax_ = jdeploy.I3InferenceModule(
        pulsemap_extractor=_queso_extractor(jext), **common)
    jax_.set_graph_definition(jconfig.load_model(gd_path))
    whole = tdeploy.I3InferenceModule(
        pulsemap_extractor=text.I3FeatureExtractorIceCubeUpgrade(
            "SplitInIcePulses"), device="cpu", **common)
    whole.set_graph_definition(tconfig.load_model(gd_path))
    col = f"queso_{port.prediction_columns[0]}"
    got, exp, full = [], [], []
    for frame in frames:
        a, b, c = (copy.deepcopy(frame) for _ in range(3))
        assert port(a) is True and jax_(b) is True and whole(c) is True
        got.append(a[col].value)
        exp.append(b[col].value)
        full.append(c[col].value)
    assert np.isnan(got[0]) and np.isnan(exp[0])  # the 0-pulse frame
    assert np.isfinite(got[1:]).all() and len(set(got[1:])) == len(got) - 1
    np.testing.assert_allclose(got, exp, rtol=1e-5)
    assert np.array_equal(got, full, equal_nan=True)
    jwhole = jdeploy.I3InferenceModule(
        pulsemap_extractor=jext.I3FeatureExtractorIceCubeUpgrade(
            "SplitInIcePulses"), **common)
    jwhole.set_graph_definition(jconfig.load_model(gd_path))
    with pytest.raises(AssertionError, match="Expected features"):
        jwhole(copy.deepcopy(frames[2]))


def test_pulse_cleaner_matches_jax(tmp_path, icetray):
    """The port's ``I3PulseCleanerModule`` against the JAX package's
    ``DeploymentModule([event])[0][:, 0] > threshold`` on the same events:
    the same probabilities (rtol 1e-5) and the same kept pulses, written
    as ``{pulsemap}_{model_name}_cleaned``.  The JAX cleaner itself
    raises ``TypeError`` on the same frame (it indexes the node-level
    list as an array): the known divergence."""
    yml, pkl, gd_path = _queso_files(tmp_path, "SplitInIcePulses_cleaner")
    gcd = tmp_path / "gcd.i3.gz"
    frames = _served_frames(icetray, gcd)
    jgd = jconfig.load_model(gd_path)
    jmodule = JaxDeploymentModule(yml, pkl)
    extractor = _queso_extractor(jext)
    extractor.set_gcd(str(gcd), str(gcd))
    names = list(jgd._input_feature_names)
    common = dict(model_config=yml, state_dict=pkl, gcd_file=str(gcd),
                  model_name="queso")
    probs = [jmodule([jgd(np.stack([np.asarray(v, np.float64) for v in
                                    extractor(f).values()], axis=1),
                          names)])[0][:, 0] for f in frames[1:]]
    threshold = float(np.median(np.concatenate(probs)))
    port = tdeploy.I3PulseCleanerModule(
        pulsemap="SplitInIcePulses", threshold=threshold,
        pulsemap_extractor=text.I3FeatureExtractorIceCubeUpgrade(
            "SplitInIcePulses"), device="cpu", **common)
    port.set_graph_definition(tconfig.load_model(gd_path))
    key = "SplitInIcePulses_queso_cleaned"
    kept_total = 0
    for frame, p in zip(frames, [np.zeros(0)] + probs):
        np.testing.assert_allclose(port.probabilities(frame)[:, 0], p,
                                   rtol=1e-5, atol=1e-7)
        out = copy.deepcopy(frame)
        assert port(out) is True
        flat = [(k, q) for k, ps in frame["SplitInIcePulses"].items()
                for q in ps]
        keep = p > threshold
        exp = {}
        for (k, q), kk in zip(flat, keep):
            if kk:
                exp.setdefault(k, []).append(q)
        assert {k: list(v) for k, v in out[key].items()} == exp
        kept_total += int(keep.sum())
    assert 0 < kept_total < sum(len(p) for p in probs)
    jcleaner = jdeploy.I3PulseCleanerModule(
        pulsemap="SplitInIcePulses", threshold=threshold,
        pulsemap_extractor=_queso_extractor(jext), **common)
    jcleaner.set_graph_definition(jgd)
    with pytest.raises(TypeError):
        jcleaner(copy.deepcopy(frames[2]))


def test_modules_pickle_as_their_arguments(tmp_path, icetray):
    yml, pkl, gd_path = _queso_files(tmp_path, "SplitInIcePulses_cleaner")
    gcd = tmp_path / "gcd.i3.gz"
    frames = _served_frames(icetray, gcd)
    module = tdeploy.I3PulseCleanerModule(
        pulsemap="SplitInIcePulses", threshold=0.3,
        pulsemap_extractor=text.I3FeatureExtractorIceCubeUpgrade(
            "SplitInIcePulses"),
        model_config=yml, state_dict=pkl, gcd_file=str(gcd),
        prediction_columns=["p_noise"], model_name="m", device="cpu")
    module.set_graph_definition(tconfig.load_model(gd_path))
    copy_ = pickle.loads(pickle.dumps(module))
    assert type(copy_) is tdeploy.I3PulseCleanerModule
    assert copy_ is not module and copy_.model is not module.model
    for attr in ("_pulsemap", "_threshold", "_model_name", "_gcd_file",
                 "prediction_columns"):
        assert getattr(copy_, attr) == getattr(module, attr), attr
    assert copy_.device == module.device
    assert copy_._graph_definition._input_feature_names == (
        module._graph_definition._input_feature_names)
    np.testing.assert_array_equal(copy_.probabilities(frames[3]),
                                  module.probabilities(frames[3]))


def test_deployer_two_workers_equal_one(tmp_path, icetray, monkeypatch):
    """``I3Deployer`` with two spawned workers (each rebuilds the
    modules from their files; the stand-in reaches them through
    ``sys.path``) writes the same frames as one process."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yml, pkl, gd_path = _queso_files(tmp_path, "total_neutrino_energy")
    F = icetray
    rng = np.random.default_rng(11)
    gcd, keys = F.fake_gcd(rng, rng.normal(0.0, 150.0, (40, 3)))
    gcd_path = str(tmp_path / "gcd.i3.gz")
    F.write_i3(gcd_path, gcd)
    module = tdeploy.I3InferenceModule(
        pulsemap_extractor=text.I3FeatureExtractorIceCubeUpgrade(
            "SplitInIcePulses"), model_config=yml, state_dict=pkl,
        gcd_file=gcd_path, model_name="queso", device="cpu")
    module.set_graph_definition(tconfig.load_model(gd_path))
    written = {}
    threads = torch.get_num_threads()
    for n in (1, 2):
        files = []
        for i in range(4):
            path = tmp_path / f"w{n}" / f"run{i}.i3.gz"
            path.parent.mkdir(exist_ok=True)
            F.write_i3(path, F.random_frames(np.random.default_rng(i), keys,
                                             (0, 5, 17)[: 1 + i % 3] + (9,)))
            files.append(str(path))
        torch.set_num_threads(1)
        try:
            tdeploy.I3Deployer([module], gcd_file=gcd_path, n_workers=n).run(files)
        finally:
            torch.set_num_threads(threads)
        written[n] = [Path(f.replace(".i3", "_graphnet_tpu.i3")).read_bytes()
                      for f in files]
    # the same bytes: the same frames, NaN answers of 0-pulse frames too
    assert written[1] == written[2]
    frames = [f for w in written[1] for f in pickle.loads(w) if f.Stop == "P"]
    assert len(frames) == 2 + 3 + 4 + 2
    values = [f[f"queso_{module.prediction_columns[0]}"].value for f in frames]
    assert np.isfinite(values).sum() == len(frames) - 4  # a 0-pulse one a file


def test_without_icetray_the_modules_raise(tmp_path):
    """Without IceTray, serving a frame and processing files raise
    ``ImportError`` in both packages; the modules still build."""
    assert not has_icecube_package()
    yml, pkl, gd_path = _queso_files(tmp_path, "total_neutrino_energy")
    common = dict(model_config=yml, state_dict=pkl, gcd_file="gcd.i3.gz")
    port = tdeploy.I3InferenceModule(
        pulsemap_extractor=text.I3FeatureExtractorIceCubeUpgrade("P"),
        device="cpu", **common)
    jax_ = jdeploy.I3InferenceModule(
        pulsemap_extractor=jext.I3FeatureExtractorIceCubeUpgrade("P"), **common)
    cleaner = tdeploy.I3PulseCleanerModule(
        pulsemap="P", pulsemap_extractor=text.I3FeatureExtractorIceCubeUpgrade(
            "P"), device="cpu", **common)
    for m in (port, jax_, cleaner):
        with pytest.raises(ImportError, match="icetray"):
            m(object())
    for deployer in (tdeploy.I3Deployer([port], "gcd.i3.gz"),
                     jdeploy.I3Deployer([jax_], "gcd.i3.gz")):
        with pytest.raises(ImportError, match="icetray"):
            deployer._process_files(["run.i3.gz"])
    with pytest.raises(ImportError, match="icecube"):
        treader.I3Reader(gcd_rescue="gcd.i3.gz")(
            treader.I3FileSet("run.i3.gz", "gcd.i3.gz"))


def test_stand_in_seen_alike_at_import(tmp_path):
    """With the stand-in on the path before either package's extractors
    are imported (as in a spawned worker), both bind it at import and
    extract alike; without it neither sees IceTray."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(STANDIN)!r})
        import numpy as np
        from graphnet_tpu.data.extractors import icecube as j
        from graphnet_tpu_torch.data.extractors import icecube as t
        import icecube.dataclasses, i3_standin_frames as F
        assert j.dataclasses is t.dataclasses is icecube.dataclasses
        rng = np.random.default_rng(0)
        gcd, keys = F.fake_gcd(rng, rng.normal(0, 100, (20, 3)))
        F.write_i3("gcd.i3.gz", gcd)
        frames = F.random_frames(rng, keys, (4, 0, 9))
        outs = []
        for m in (t, j):
            e = m.I3FeatureExtractorIceCubeUpgrade(F.PULSEMAP)
            e.set_gcd("gcd.i3.gz")
            outs.append([e(f) for f in frames if f.Stop == "P"])
        assert outs[0] == outs[1] and len(outs[0][2]["dom_x"]) == 9
        print("ok")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = str(ROOT)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, env=env,
                         cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
    assert not has_icecube_package() and not jax_has_icecube()

