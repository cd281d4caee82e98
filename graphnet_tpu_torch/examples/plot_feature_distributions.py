"""Plot each node feature's distribution in a configured dataset
(counterpart of ``examples/01_data/05_plot_feature_distributions.py``).

    python -m graphnet_tpu_torch.examples.plot_feature_distributions [--output F.png]

Loads the bundled dataset through its dataset config
(``configs/datasets/training_example_data_sqlite.yml``), stacks the
standardised node features of every event, logs the NaN and inf counts
and writes one log-scale histogram a feature.  matplotlib is imported
inside ``main``.  Returns the feature matrix.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from graphnet_tpu_torch.constants import CONFIG_DIR
from graphnet_tpu_torch.utils.config import load_dataset
from graphnet_tpu_torch.utils.logging import Logger


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Plot feature distributions in the example dataset.")
    parser.add_argument("--output", default=os.path.join(
        tempfile.gettempdir(), "feature_distribution_preprocessed.png"))
    return parser.parse_args(argv)


def main(argv=None) -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg")  # no display
    import matplotlib.pyplot as plt

    args = parse_args(argv)
    logger = Logger()
    dataset = load_dataset(os.path.join(
        CONFIG_DIR, "datasets", "training_example_data_sqlite.yml"))
    if isinstance(dataset, dict):  # {selection name: Dataset}
        name, dataset = sorted(dataset.items())[0]
        logger.info(f"using selection {name!r}")

    features = dataset._features
    x = np.concatenate([np.asarray(dataset[i].x) for i in range(len(dataset))],
                       axis=0)
    logger.info(f"feature matrix: {x.shape}")
    logger.info(f"Number of NaNs: {int(np.sum(np.isnan(x)))}")
    logger.info(f"Number of infs: {int(np.sum(np.isinf(x)))}")

    nb = x.shape[1]
    dim = int(np.ceil(np.sqrt(nb)))
    fig, axes = plt.subplots(dim, dim, figsize=(dim * 4, dim * 4))
    for ix, ax in enumerate(np.ravel(axes)[:nb]):
        ax.hist(x[:, ix], bins=50, color="orange")
        ax.set_xlabel(f"x{ix}: {features[ix] if ix < len(features) else 'N/A'}")
        ax.set_yscale("log")
    fig.tight_layout()
    fig.savefig(args.output)
    plt.close(fig)
    logger.info(f"Figure written to {args.output}")
    return x


if __name__ == "__main__":
    main()
