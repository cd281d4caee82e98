"""Two-process scenarios of the port's ``Trainer(mesh=...)`` on the CPU
(gloo), for ``tests/test_torch_parallel_graph.py``: a spawned worker
runs this module, so it imports the port, numpy and torch only.

    python tests/tools_torch_parallel.py RANK NPROC INIT OUT DATA SCENARIO...

Each scenario writes ``OUT/<scenario>.rank<RANK>.pt``.  ``DATA`` holds
what the test process made: ``batches.pt`` (global training and
validation batches) and ``store/`` (a materialized store).
"""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from graphnet_tpu_torch.parallel import dryrun  # noqa: E402
from graphnet_tpu_torch.parallel.distributed import init_distributed  # noqa: E402
from graphnet_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from graphnet_tpu_torch.training.trainer import Trainer  # noqa: E402


def full_params(trainer):
    return {k: v.detach().clone() for k, v in trainer._full_state().items()}


def fit_shards(data, out):
    """fit over MaterializedLoader process shards, validation on global
    batches, predictions of this process's validation events."""
    from graphnet_tpu_torch.data.materialized import MaterializedLoader

    rank = torch.distributed.get_rank()
    loader = MaterializedLoader(os.path.join(data, "store"), shuffle=False,
                                process_index=rank, process_count=2,
                                device="cpu")
    batches = torch.load(os.path.join(data, "batches.pt"), weights_only=False)
    trainer = Trainer(dryrun.build_model("dynedge", "cpu", "narrow"),
                      mesh=make_mesh(2, 1, "cpu"))
    hist = trainer.fit(loader, batches["val"], max_epochs=2)
    return dict(hist=hist, params=full_params(trainer),
                predict=trainer.predict(batches["val"]))


def predict_rows(data, out):
    """predict of ragged global batches (padding dropped)."""
    batches = torch.load(os.path.join(data, "batches.pt"), weights_only=False)
    trainer = Trainer(dryrun.build_model("dynedge", "cpu", "narrow"),
                      mesh=make_mesh(2, 1, "cpu"))
    return dict(predict=trainer.predict(batches["ragged"]))


def resume(mode, data, out):
    """fit 2 epochs with checkpoints, resume to 4 in a new Trainer; and 4
    epochs unbroken."""
    batches = torch.load(os.path.join(data, "batches.pt"), weights_only=False)["train"]
    ckpt = os.path.join(out, f"ckpt_{mode}")

    def trainer(**kw):
        return Trainer(dryrun.build_model("dynedge", "cpu", "narrow"),
                       mesh=make_mesh(2, 1, "cpu"), param_sharding=mode,
                       fsdp_min_size=2**10, **kw)

    # a constant rate: the default schedule depends on max_epochs
    fit = dict(use_default_schedule=False)
    first = trainer(checkpoint_dir=ckpt).fit(batches, max_epochs=2, **fit)
    again = trainer(checkpoint_dir=ckpt)
    hist = again.fit(batches, max_epochs=4, resume=True, **fit)
    whole = trainer()
    whole_hist = whole.fit(batches, max_epochs=4, **fit)
    return dict(first=first, hist=hist, whole_hist=whole_hist,
                params=full_params(again), whole_params=full_params(whole),
                files=sorted(os.listdir(os.path.join(ckpt, "last"))))


def dropout_dp(data, out):
    """One DP step of a TITO with dropout: the masks over the batch are
    this process's rows of the global draw."""
    batches = torch.load(os.path.join(data, "batches.pt"), weights_only=False)
    model = dropout_model()
    trainer = Trainer(model, mesh=make_mesh(2, 1, "cpu"))
    loss = trainer._mean_over_processes(trainer.train_step(batches["train"][0]))
    grads = trainer._full_state({n: p.grad for n, p in model.named_parameters()})
    return dict(loss=float(loss), grads={k: v.clone() for k, v in grads.items()})


def clip_fsdp(data, out):
    """One FSDP step with the global gradient norm clipped: the norm over
    the sharded and the replicated gradients."""
    batches = torch.load(os.path.join(data, "batches.pt"), weights_only=False)
    trainer = Trainer(dryrun.build_model("dynedge", "cpu", "narrow"),
                      mesh=make_mesh(2, 1, "cpu"), param_sharding="fsdp",
                      fsdp_min_size=2**10, clip_grad_norm=0.5)
    trainer.train_step(batches["train"][0])
    return dict(params=full_params(trainer))


def dropout_model():
    from graphnet_tpu_torch.models.gnn.dynedge_kaggle_tito import DynEdgeTITO
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import (
        DirectionReconstructionWithKappa,
    )
    from graphnet_tpu_torch.training.loss_functions import VonMisesFisher3DLoss

    backbone = DynEdgeTITO(nb_inputs=4, dropout_rate=0.1, deterministic=False,
                           **dryrun.NARROW_TITO)
    return StandardModel(backbone, [DirectionReconstructionWithKappa(
        hidden_size=backbone.nb_outputs, loss_function=VonMisesFisher3DLoss(),
        target_labels=("direction",))], device="cpu")


SCENARIOS = {
    "fit_shards": fit_shards,
    "predict_rows": predict_rows,
    "resume_replicated": lambda d, o: resume("replicated", d, o),
    "resume_fsdp": lambda d, o: resume("fsdp", d, o),
    "dropout_dp": dropout_dp,
    "clip_fsdp": clip_fsdp,
}


def main(argv):
    rank, nproc, init, out, data, *scenarios = argv
    torch.set_num_threads(1)
    init_distributed(init, int(nproc), int(rank), device="cpu", timeout_s=120)
    for name in scenarios:
        result = SCENARIOS[name](data, out)
        torch.save(result, os.path.join(out, f"{name}.rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
