"""Convert raw Prometheus simulation files to SQLite (counterpart of
``examples/05_prometheus/01_convert_prometheus.py``).

    python -m graphnet_tpu_torch.examples.convert_prometheus [--input DIR] [--output DIR]

The bundled ``data/tests/prometheus`` by default, into a new temporary
directory; one database a Parquet file, with its ``mc_truth`` and
``photons`` tables.  Needs pandas and pyarrow.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from graphnet_tpu_torch.constants import DATA_DIR
from graphnet_tpu_torch.data.dataconverter import DataConverter
from graphnet_tpu_torch.data.extractors.prometheus import (
    PrometheusFeatureExtractor,
    PrometheusTruthExtractor,
)
from graphnet_tpu_torch.data.readers.prometheus_reader import PrometheusReader
from graphnet_tpu_torch.data.writers.sqlite_writer import SQLiteWriter


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Convert Prometheus Parquet files to SQLite.")
    parser.add_argument("--input", default=os.path.join(DATA_DIR, "tests",
                                                        "prometheus"))
    parser.add_argument("--output", default=None,
                        help="output directory (default: a new temporary one)")
    parser.add_argument("--num-workers", type=int, default=1)
    return parser.parse_args(argv)


def main(argv=None) -> str:
    """Returns the output directory."""
    args = parse_args(argv)
    outdir = args.output or tempfile.mkdtemp(prefix="prometheus_sqlite_")
    converter = DataConverter(
        file_reader=PrometheusReader(),
        save_method=SQLiteWriter(),
        outdir=outdir,
        extractors=[PrometheusTruthExtractor(), PrometheusFeatureExtractor()],
        num_workers=args.num_workers,
    )
    converter(args.input)
    print(f"converted to {outdir}: {os.listdir(outdir)}")
    return outdir


if __name__ == "__main__":
    main()
