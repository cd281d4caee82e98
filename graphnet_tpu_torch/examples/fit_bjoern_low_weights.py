"""Fit BjoernLow per-event weights on the bundled Prometheus database: a
uniform spectrum below a threshold, ``1 / (1 + alpha (x - x_low))``
above (counterpart of ``examples/02_weights/02_fit_bjoern_low_weights.py``).

    python -m graphnet_tpu_torch.examples.fit_bjoern_low_weights

The weights are written as the table ``bjoern_low_weight`` into a copy
of the database (``--output``, a temporary file by default).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.examples.common import copy_database, print_table
from graphnet_tpu_torch.training.weight_fitting import BjoernLow


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Fit BjoernLow weights")
    parser.add_argument("--path", default=EXAMPLE_SQLITE_DATA)
    parser.add_argument("--output", default=None,
                        help="the database copy to write (default: a "
                        "temporary file)")
    return parser.parse_args(argv)


def main(argv=None) -> Dict[str, np.ndarray]:
    args = parse_args(argv)
    db = copy_database(args.path, args.output)
    fitter = BjoernLow(db, truth_table="mc_truth")
    weights = fitter.fit(
        bins=np.arange(0, 5, 0.1),
        variable="injection_energy",
        transform=np.log10,
        x_low=1.5,
        alpha=0.05,
        add_to_database=True,
        weight_name="bjoern_low_weight",
    )
    print_table(weights)
    print(f"weights written to table 'bjoern_low_weight' in {db}")
    return weights


if __name__ == "__main__":
    main()
