"""Serve a trained model inside an I3Tray chain (counterpart of
``examples/07_icetray/02_deploy_i3_modules.py``).

    python -m graphnet_tpu_torch.examples.deploy_i3_modules \\
        --input-dir DIR --gcd-file GCD --state-dict PKL [--pulsemap NAME] \\
        [--device cpu]

The pretrained zoo's ``queso/total_neutrino_energy`` (its ``model.yml``
and ``graph_definition.yml``, the weights from ``--state-dict``: a
JAX-layout ``state_dict.pkl`` as ``utils.config.save_model`` or
``utils.weight_port`` write it) through ``I3InferenceModule`` and
``I3Deployer`` over the ``.i3`` files of ``--input-dir``: each physics
frame gets an ``I3Double`` of the energy, each file a copy
``<name>_graphnet_tpu.i3...`` beside it.  On the GPU unless ``--device
cpu``.  Reading ``.i3`` frames needs IceTray: without it the example
says so and returns.
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from typing import List, Optional

from graphnet_tpu_torch.constants import PRETRAINED_MODEL_DIR
from graphnet_tpu_torch.utils.imports import has_icecube_package

ZOO_MODEL = os.path.join(PRETRAINED_MODEL_DIR, "queso", "total_neutrino_energy")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Run model inference over .i3 files via I3Tray")
    parser.add_argument("--input-dir", default=None)
    parser.add_argument("--gcd-file", default=None)
    parser.add_argument("--state-dict", default=None,
                        help="the zoo model's weights (a JAX-layout "
                        "state_dict.pkl; see graphnet_tpu_torch.utils."
                        "weight_port for GraphNeT checkpoints)")
    parser.add_argument("--pulsemap", default="SplitInIcePulses")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> Optional[List[str]]:
    """Returns the files written, or None without IceTray."""
    args = parse_args(argv)
    model_config = os.path.join(ZOO_MODEL, "model.yml")
    print(f"zoo config: {model_config}")
    if not has_icecube_package():
        print(
            "icetray is not installed: this example needs the IceCube "
            "software stack to read .i3 frames.\n"
            "The chain it drives (I3InferenceModule -> I3Deployer -> "
            "I3Tray reader and writer) is graphnet_tpu_torch/deployment/"
            "icecube.py; tests/test_torch_i3.py runs it on a stand-in for "
            "IceTray.")
        return None
    if not (args.input_dir and args.gcd_file and args.state_dict):
        raise SystemExit("--input-dir, --gcd-file and --state-dict are required")

    from graphnet_tpu_torch.data.extractors.icecube import (
        I3FeatureExtractorIceCubeUpgrade,
    )
    from graphnet_tpu_torch.deployment.icecube import (
        I3Deployer,
        I3InferenceModule,
    )
    from graphnet_tpu_torch.utils.config import load_model

    module = I3InferenceModule(
        pulsemap_extractor=I3FeatureExtractorIceCubeUpgrade(
            pulsemap=args.pulsemap),
        model_config=model_config,
        state_dict=args.state_dict,
        gcd_file=args.gcd_file,
        prediction_columns=["energy"],
        model_name="graphnet_tpu_deployment_example",
        device=args.device,
    )
    module.set_graph_definition(
        load_model(os.path.join(ZOO_MODEL, "graph_definition.yml")))
    input_files = sorted(glob(os.path.join(args.input_dir, "*.i3*")))
    I3Deployer(modules=[module], gcd_file=args.gcd_file, n_workers=1).run(
        input_files)
    written = [f.replace(".i3", "_graphnet_tpu.i3") for f in input_files]
    print(f"wrote {len(written)} files: {written}")
    return written


if __name__ == "__main__":
    main()
