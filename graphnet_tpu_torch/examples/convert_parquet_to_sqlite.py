"""Convert the package's chunked Parquet format to SQLite (counterpart
of ``examples/01_data/03_convert_parquet_to_sqlite.py``), then count the
events of the converted database.

    python -m graphnet_tpu_torch.examples.convert_parquet_to_sqlite [--output DIR]

``--output`` is a new temporary directory by default; the merged
database is ``<output>/merged/merged.db``.  Needs pandas and pyarrow.
"""

from __future__ import annotations

import argparse
import os
import sqlite3
import tempfile

from graphnet_tpu_torch.constants import EXAMPLE_PARQUET_DATA
from graphnet_tpu_torch.data.pre_configured import ParquetToSQLiteConverter


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Convert the bundled Parquet dataset to SQLite.")
    parser.add_argument("--input", default=EXAMPLE_PARQUET_DATA)
    parser.add_argument("--output", default=None,
                        help="output directory (default: a new temporary one)")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    """Returns the merged database's path."""
    args = parse_args(argv)
    outdir = args.output or tempfile.mkdtemp(prefix="parquet_to_sqlite_")
    ParquetToSQLiteConverter(parquet_path=args.input, sqlite_path=outdir,
                             tables=["mc_truth", "total"], num_workers=1).run()
    merged = os.path.join(outdir, "merged")
    dbs = [f for f in os.listdir(merged) if f.endswith(".db")]
    print(f"converted parquet -> {merged}: {dbs}")
    with sqlite3.connect(os.path.join(merged, dbs[0])) as con:
        n = con.execute("SELECT COUNT(DISTINCT event_no) FROM mc_truth")
        print("events in converted DB:", n.fetchone()[0])
    return os.path.join(merged, dbs[0])


if __name__ == "__main__":
    main()
