"""The port Trainer's state, averaging and logging against the JAX
Trainer on the CPU: SWA and EMA ``fit``; a resumed run equal, bit for
bit, to an unbroken one (EMA and dropout on); the ``best`` and ``last``
checkpoints; the JSON-lines logger's records; the profile and the
progress bar."""

import json
import sys
import types

import numpy as np
import pytest
import torch

import jax

from graphnet_tpu.training.callbacks import JSONLinesLogger as JaxJSONLinesLogger
from graphnet_tpu.training.trainer import Trainer as JaxTrainer
from graphnet_tpu_torch.models.gnn.convnet import ConvNet
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.training.callbacks import JSONLinesLogger
from graphnet_tpu_torch.training.trainer import Trainer
from tests.test_torch_training import (
    _assert_params_close,
    _batches,
    _jax_model,
    _port_model,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("averaging", ["swa", "ema"])
def test_averaged_fit_matches_jax(averaging):
    """Two epochs of three ragged batches with a validation loader and
    SWA or EMA (decay 0.9, so the average moves): the losses and the
    averaged parameters swapped in at the end within 1e-4."""
    jtrain, ttrain = _batches(8, [4, 5, 4])
    jval, tval = _batches(9, [3, 4])
    jtrainer = JaxTrainer(_jax_model(), learning_rate=1e-2,
                          averaging=averaging, ema_decay=0.9)
    jtrainer.init(jtrain[0])
    params0 = jax.device_get(jtrainer.state.params)
    j_hist = jtrainer.fit(jtrain, jval, max_epochs=2)
    model = _port_model(params0)
    trainer = Trainer(model, learning_rate=1e-2, averaging=averaging,
                      ema_decay=0.9)
    hist = trainer.fit(ttrain, tval, max_epochs=2)
    assert trainer._avg_count == (6 if averaging == "swa" else 1)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], j_hist[key], rtol=1e-4,
                                   err_msg=key)
    _assert_params_close(model, jtrainer.state.params, 1e-4, 1e-5)


def _dropout_model():
    """A narrow ConvNet with its dropout on, from a fixed seed."""
    return StandardModel(
        ConvNet(nb_inputs=4, nb_outputs_=6, nb_intermediate=8,
                dropout_ratio=0.3, deterministic=False),
        [EnergyReconstruction(hidden_size=6, loss_function=tlf.LogCoshLoss(),
                              target_labels=("total_energy",),
                              transform_prediction_and_target=torch.log10)],
        device="cpu", seed=5)


def _state(trainer):
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            {k: v.clone() for k, v in trainer._avg.items()},
            trainer.step)


def test_resume_equals_an_unbroken_run(tmp_path):
    """``fit`` for 2 epochs against 1 epoch and then ``resume=True`` for
    1 more in a new Trainer and model, with EMA and dropout on: the same
    losses, parameters, average and step, bit for bit; ``last`` and
    ``best`` written."""
    _, train = _batches(3, [4, 5, 4])
    _, val = _batches(4, [3])
    whole = Trainer(_dropout_model(), learning_rate=1e-2, averaging="ema",
                    ema_decay=0.8, checkpoint_dir=str(tmp_path / "whole"))
    h_whole = whole.fit(train, val, max_epochs=2)
    assert (tmp_path / "whole" / "last").exists()
    assert (tmp_path / "whole" / "best").exists()

    first = Trainer(_dropout_model(), learning_rate=1e-2, averaging="ema",
                    ema_decay=0.8, checkpoint_dir=str(tmp_path / "cut"))
    first.fit(train, val, max_epochs=2, early_stopping_patience=0)
    assert first.step == 3  # stopped after one epoch
    second = Trainer(_dropout_model(), learning_rate=1e-2, averaging="ema",
                     ema_decay=0.8, checkpoint_dir=str(tmp_path / "cut"))
    h_second = second.fit(train, val, max_epochs=2, resume=True)
    assert h_second["train_loss"] == h_whole["train_loss"][1:]
    assert h_second["val_loss"] == h_whole["val_loss"][1:]
    p_whole, avg_whole, step_whole = _state(whole)
    p_second, avg_second, step_second = _state(second)
    assert step_whole == step_second == 6
    for name, value in p_whole.items():
        assert torch.equal(value, p_second[name]), name
    for name, value in avg_whole.items():
        assert torch.equal(value, avg_second[name]), name


def test_checkpoints_round_trip(tmp_path):
    """``save_checkpoint`` / ``load_checkpoint`` and ``save_train_state``
    / ``load_train_state``; a train state of another optimizer refuses
    to load."""
    _, train = _batches(3, [4, 5])
    trainer = Trainer(_dropout_model(), learning_rate=1e-2, averaging="swa")
    trainer.fit(train, max_epochs=1)
    path = str(tmp_path / "params")
    trainer.save_checkpoint(path)
    other = Trainer(_dropout_model())
    other.load_checkpoint(path)
    for (n, a), (_, b) in zip(trainer.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), n
    state = str(tmp_path / "state")
    trainer.save_train_state(state, epoch=4)
    again = Trainer(_dropout_model(), learning_rate=1e-2, averaging="swa")
    assert again.load_train_state(state) == 4
    assert again.step == trainer.step == 2 and again._avg_count == 2
    sgd = Trainer(_dropout_model(), optimizer=lambda p: torch.optim.SGD(
        p, lr=0.1))
    with pytest.raises(RuntimeError, match="optimizer configuration"):
        sgd.load_train_state(state)


def test_jsonlines_records_match_jax_keys(tmp_path):
    """The JSON-lines logger through ``fit`` (step records at the log
    interval, epoch records with validation): the same keys as the JAX
    Trainer's records, per record, and the epoch losses of the history;
    ``resume=True`` appends."""
    jtrain, ttrain = _batches(8, [4, 5, 4])
    jval, tval = _batches(9, [3, 4])
    jlog = JaxJSONLinesLogger(str(tmp_path / "jax.jsonl"))
    jtrainer = JaxTrainer(_jax_model(), learning_rate=1e-2, metric_logger=jlog)
    jtrainer.init(jtrain[0])
    params0 = jax.device_get(jtrainer.state.params)
    jtrainer.fit(jtrain, jval, max_epochs=2, log_every_n_steps=2)
    log = JSONLinesLogger(str(tmp_path / "port" / "m.jsonl"))
    trainer = Trainer(_port_model(params0), learning_rate=1e-2,
                      metric_logger=log)
    hist = trainer.fit(ttrain, tval, max_epochs=2, log_every_n_steps=2)
    got, exp = log.read(), jlog.read()
    assert [sorted(r) for r in got] == [sorted(r) for r in exp]
    assert [r["step"] for r in got] == [r["step"] for r in exp]
    epochs = [r for r in got if "val_loss" in r]
    assert [r["train_loss"] for r in epochs] == hist["train_loss"]
    assert [r["val_loss"] for r in epochs] == hist["val_loss"]
    log2 = JSONLinesLogger(log.path, resume=True)
    log2.log_metrics({"train_loss": 1.0}, step=99)
    assert len(log2.read()) == len(got) + 1
    assert JSONLinesLogger(log.path).read() == []


def test_wandb_style_logger_profile_and_progress_bar(tmp_path, monkeypatch):
    """A ``.log``-only logger gets the metrics; ``profile_dir`` gets a
    trace of the first epoch; ``progress_bar`` wraps each epoch's
    batches in tqdm (a stand-in module here)."""
    _, train = _batches(3, [4, 5])
    calls, bars = [], []

    class Wandb:
        def log(self, metrics, step=None):
            calls.append((dict(metrics), step))

    class Bar:
        def __init__(self, iterable, **kw):
            self.iterable, self.kw = iterable, kw
            bars.append(self)

        def __iter__(self):
            return iter(self.iterable)

        def set_postfix(self, **kw):
            self.postfix = kw

    auto = types.ModuleType("tqdm.auto")
    auto.tqdm = Bar
    monkeypatch.setitem(sys.modules, "tqdm.auto", auto)
    trainer = Trainer(_dropout_model(), metric_logger=Wandb(),
                      progress_bar=True)
    trainer.fit(train, max_epochs=2, log_every_n_steps=1,
                profile_dir=str(tmp_path / "profile"))
    assert [s for _, s in calls] == [1, 2, 2, 3, 4, 4]
    assert set(calls[2][0]) == {"train_loss", "events_per_s", "lr"}
    assert [b.kw["desc"] for b in bars] == ["epoch 0", "epoch 1"]
    assert all("train_loss" in b.postfix for b in bars)
    with open(tmp_path / "profile" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
