"""Convert IceTray ``.i3`` files to SQLite or Parquet (counterpart of
``examples/07_icetray/01_convert_i3_files.py``).

    python -m graphnet_tpu_torch.examples.convert_i3_files [sqlite|parquet] \\
        --input-dir DIR --gcd-rescue GCD [--outdir DIR] [--num-workers N]

The pulses of ``SRTInIcePulses`` (``I3FeatureExtractorIceCube86``) and
the Monte-Carlo truth (``I3TruthExtractor``) of every physics frame,
through ``I3ToSQLiteConverter`` or ``I3ToParquetConverter``, then merged
into ``<outdir>/merged``.  Decoding ``.i3`` files needs IceTray: without
it the example says so and returns.  The conversion runs on the host.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional

from graphnet_tpu_torch.utils.imports import has_icecube_package


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Convert I3 files to SQLite or Parquet")
    parser.add_argument("backend", nargs="?", default="sqlite",
                        choices=["sqlite", "parquet"])
    parser.add_argument("--input-dir", default=None)
    parser.add_argument("--gcd-rescue", default=None)
    parser.add_argument("--outdir", default=None,
                        help="output directory (default: a new temporary one)")
    parser.add_argument("--num-workers", type=int, default=1)
    return parser.parse_args(argv)


def main(argv=None) -> Optional[str]:
    """Returns the output directory, or None without IceTray."""
    args = parse_args(argv)
    if not has_icecube_package():
        print(
            "icetray is not installed: this example needs the IceCube "
            "software stack to decode .i3 files.\n"
            "The pipeline it drives (I3ToSQLiteConverter / "
            "I3ToParquetConverter, I3Reader, I3FeatureExtractorIceCube86, "
            "I3TruthExtractor) is in graphnet_tpu_torch/data; "
            "tests/test_torch_i3.py runs it on a stand-in for IceTray.")
        return None
    if not (args.input_dir and args.gcd_rescue):
        raise SystemExit("--input-dir and --gcd-rescue are required")

    from graphnet_tpu_torch.data.extractors.icecube import (
        I3FeatureExtractorIceCube86,
        I3TruthExtractor,
    )
    from graphnet_tpu_torch.data.pre_configured import (
        I3ToParquetConverter,
        I3ToSQLiteConverter,
    )

    cls = I3ToSQLiteConverter if args.backend == "sqlite" else I3ToParquetConverter
    outdir = args.outdir or tempfile.mkdtemp(prefix="i3_converted_")
    converter = cls(
        gcd_rescue=args.gcd_rescue,
        extractors=[I3FeatureExtractorIceCube86("SRTInIcePulses"),
                    I3TruthExtractor()],
        outdir=outdir,
        num_workers=args.num_workers,
    )
    converter(args.input_dir)
    converter.merge_files()
    print(f"converted to {outdir}")
    return outdir


if __name__ == "__main__":
    main()
