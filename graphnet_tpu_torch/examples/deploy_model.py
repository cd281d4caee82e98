"""Deploy a trained model: ``model.yml`` + ``state_dict.pkl`` ->
``DeploymentModule`` -> raw events, then the same model exported and
served without model code (counterpart of
``examples/06_deployment/01_deploy_model.py``).

    python -m graphnet_tpu_torch.examples.deploy_model --model-dir DIR
    python -m graphnet_tpu_torch.examples.deploy_model --device cpu

Where ``--model-dir`` holds no ``model.yml`` and ``state_dict.pkl`` the
training example (:mod:`graphnet_tpu_torch.examples.train_dynedge`)
writes them there first.  The module serves events of the bundled SQLite
database; ``export_serving`` writes an artifact to ``--model-dir/
serving`` (one ``torch.export`` program per (batch, length), traced on
``--device``), ``ExportedModel`` serves it, and the largest difference
between the two is printed.  Everything runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
from graphnet_tpu_torch.deployment.export import ExportedModel
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.graphs import KNNGraph


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Serve a trained model on raw events, live and from an "
        "exported artifact",
    )
    parser.add_argument(
        "--model-dir",
        default=os.path.join(tempfile.gettempdir(), "deploy_example"),
    )
    parser.add_argument("--max-epochs", type=int, default=1,
                        help="epochs of the training run when the model "
                        "directory holds no model")
    parser.add_argument(
        "--device", default="cuda", help="cuda (default) or cpu"
    )
    return parser.parse_args(argv)


def main(argv=None) -> float:
    """Run the example; returns the largest difference between the live
    module's answers and the artifact's."""
    args = parse_args(argv)
    ds = SQLiteDataset(
        path=EXAMPLE_SQLITE_DATA,
        graph_definition=KNNGraph(detector=Prometheus()),
        pulsemaps="total",
        features=FEATURES.PROMETHEUS,
        truth=TRUTH.PROMETHEUS,
        truth_table="mc_truth",
    )
    config_path = os.path.join(args.model_dir, "model.yml")
    weights_path = os.path.join(args.model_dir, "state_dict.pkl")
    if not (os.path.exists(config_path) and os.path.exists(weights_path)):
        # train an energy regressor to have something to deploy
        from graphnet_tpu_torch.examples import train_dynedge

        train_dynedge.main([
            "--device", args.device, "--max-epochs", str(args.max_epochs),
            "--output", args.model_dir,
        ])

    module = DeploymentModule(config_path, weights_path, device=args.device)
    events = [ds[i] for i in range(8)]
    preds = module(events)
    truth = [e.labels["total_energy"] for e in events]
    for p, t in zip(preds[:, 0], truth):
        print(f"predicted energy {p:10.2f}   true {float(t):10.2f}")

    # the artifact: the inference forward exported per (batch, length),
    # served with no model code (deployment/export.py)
    export_dir = os.path.join(args.model_dir, "serving")
    module.export_serving(export_dir, batch_sizes=(1, 8), lengths=(128,))
    served = ExportedModel(export_dir)
    diff = float(np.nanmax(np.abs(served(events) - preds)))
    print(f"artifact on {served.device}: max |diff| to the live module {diff}")
    return diff


if __name__ == "__main__":
    main()
