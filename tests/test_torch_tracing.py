"""The port's spans (``graphnet_tpu_torch/utils/tracing.py``) on the CPU:
none entered while no profiler records; under a ``torch.profiler``
session each layer's spans nested as documented; and a request's
answers the same with a profiler recording as without."""

import json

import numpy as np
import pytest
import torch

from graphnet_tpu_torch.data.dataloader import DataLoader, collate_events
from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.graphs.graph_definition import Event
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils import tracing

torch.set_num_threads(2)

FEATURES = ["sensor_pos_x", "sensor_pos_y", "sensor_pos_z", "t"]
ROWS = {
    "trainer": ("graphnet.trainer.step",
                {"graphnet.trainer.h2d", "graphnet.trainer.forward",
                 "graphnet.trainer.backward", "graphnet.trainer.optimizer"}),
    "loader": ("graphnet.loader.batch",
               {"graphnet.loader.fetch", "graphnet.loader.collate"}),
    "deploy": ("graphnet.deploy.request",
               {"graphnet.deploy.collate", "graphnet.deploy.pad",
                "graphnet.deploy.h2d", "graphnet.deploy.forward",
                "graphnet.deploy.d2h"}),
}


def _events(seed, lengths):
    rng = np.random.default_rng(seed)
    return [Event(x=(rng.standard_normal((n, 4)) * [50, 50, 50, 5]
                     ).astype(np.float32),
                  features=FEATURES,
                  labels={"total_energy": float(rng.uniform(10, 1000))})
            for n in lengths]


def _model():
    return StandardModel(
        DynEdge(nb_inputs=4, dynedge_layer_sizes=((16, 32), (24, 32)),
                post_processing_layer_sizes=(24, 16), readout_layer_sizes=(8,)),
        [EnergyReconstruction(hidden_size=8, loss_function=tlf.LogCoshLoss(),
                              target_labels=("total_energy",),
                              transform_prediction_and_target=torch.log10)],
        device="cpu", seed=3)


def _drive(row):
    """One train step, one loader epoch or two requests; the loader's
    consumer runs inside a ``consumer`` range of its own."""
    if row == "trainer":
        Trainer(_model()).train_step(collate_events(_events(1, [5, 9, 12, 7])))
    elif row == "loader":
        for batch in DataLoader(_events(2, [5, 9, 12, 7, 30, 3]),
                                batch_size=2, buckets=(16, 32)):
            with torch.profiler.record_function("consumer"):
                batch.x.sum()
    else:
        module = DeploymentModule(_model(), _model().state_dict(), device="cpu")
        module(_events(3, [5, 9, 12]))
        module(_events(4, [30, 0]))


@pytest.mark.parametrize("row", sorted(ROWS))
def test_no_range_entered_without_a_profiler(row, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert tracing.span("graphnet.x") is tracing.span("graphnet.y")
    _drive(row)
    assert [n for n in entered if n != "consumer"] == []


def _ranges(tmp_path, row):
    """``[(start, end, name)]`` of the user ranges of a profiled drive."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _drive(row)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") == "user_annotation"
                  and (e["name"].startswith("graphnet.")
                       or e["name"] == "consumer"))


@pytest.mark.parametrize("row", sorted(ROWS))
def test_spans_nest_under_a_profiler(row, tmp_path):
    top, parts = ROWS[row]
    ranges = _ranges(tmp_path, row)
    program = [r for r in ranges if r[2].startswith("graphnet.")]
    assert all("#" not in name for _, _, name in program)
    assert {name for _, _, name in program} == {top} | parts
    outer = [r for r in program if r[2] == top]
    assert len(outer) == {"trainer": 1, "loader": 3, "deploy": 2}[row]
    for s, e, name in program:
        if name != top:
            assert any(os_ <= s and e <= oe for os_, oe, _ in outer), name
    if row == "loader":
        # each batch is built, and its span closed, before it is consumed
        consumers = [r for r in ranges if r[2] == "consumer"]
        assert len(consumers) == 3
        for (_, end, _), (start, _, _) in zip(outer, consumers):
            assert end <= start
        for s, e, _ in program:
            assert all(e <= cs or s >= ce for cs, ce, _ in consumers)


def test_a_request_answers_the_same_under_a_profiler():
    """The deployment's spans change no answer: the same requests give
    the same predictions with a profiler recording and without."""
    module = DeploymentModule(_model(), _model().state_dict(), device="cpu")
    requests = [_events(5, [5, 9, 12]), _events(6, [30, 0]), _events(7, [3]),
                _events(8, [0]), _events(9, [300, 17, 2, 40, 64])]
    plain = [module(events) for events in requests]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        traced = [module(events) for events in requests]
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
