"""Convert LiquidO h5 files to SQLite (counterpart of
``examples/04_liquido/01_convert_h5.py``).

    python -m graphnet_tpu_torch.examples.convert_h5 [--input DIR] [--output DIR]

The bundled ``data/tests/liquid-o`` by default, into a new temporary
directory; one database an h5 file, with its ``HitData`` and
``TruthData`` tables.  Needs pandas and h5py.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from graphnet_tpu_torch.constants import DATA_DIR
from graphnet_tpu_torch.data.dataconverter import DataConverter
from graphnet_tpu_torch.data.extractors.liquido import (
    H5HitExtractor,
    H5TruthExtractor,
)
from graphnet_tpu_torch.data.readers.liquido_reader import LiquidOReader
from graphnet_tpu_torch.data.writers.sqlite_writer import SQLiteWriter


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Convert LiquidO h5 to SQLite.")
    parser.add_argument("--input", default=os.path.join(DATA_DIR, "tests",
                                                        "liquid-o"))
    parser.add_argument("--output", default=None,
                        help="output directory (default: a new temporary one)")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    """Returns the output directory."""
    args = parse_args(argv)
    outdir = args.output or tempfile.mkdtemp(prefix="liquido_sqlite_")
    converter = DataConverter(
        file_reader=LiquidOReader(),
        save_method=SQLiteWriter(),
        outdir=outdir,
        extractors=[H5HitExtractor(), H5TruthExtractor()],
    )
    converter(args.input)
    print(f"converted to {outdir}: {os.listdir(outdir)}")
    return outdir


if __name__ == "__main__":
    main()
