"""Fit per-event weights that flatten the energy spectrum of the bundled
Prometheus database (counterpart of
``examples/02_weights/01_fit_uniform_weights.py``).

    python -m graphnet_tpu_torch.examples.fit_uniform_weights

The weights are written as a new table into a copy of the database
(``--output``, a temporary file by default), never into the original.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.examples.common import copy_database, print_table
from graphnet_tpu_torch.training.weight_fitting import Uniform


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Fit uniform weights")
    parser.add_argument("--path", default=EXAMPLE_SQLITE_DATA)
    parser.add_argument("--output", default=None,
                        help="the database copy to write (default: a "
                        "temporary file)")
    return parser.parse_args(argv)


def main(argv=None) -> Dict[str, np.ndarray]:
    args = parse_args(argv)
    db = copy_database(args.path, args.output)
    fitter = Uniform(db, truth_table="mc_truth")
    weights = fitter.fit(
        bins=np.arange(0, 5, 0.1),
        variable="injection_energy",
        transform=np.log10,
        add_to_database=True,
    )
    print_table(weights)
    print(f"weights written to table {fitter._weight_name!r} in {db}")
    return weights


if __name__ == "__main__":
    main()
