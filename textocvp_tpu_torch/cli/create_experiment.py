"""Create a decomposition experiment (01).

    python -m textocvp_tpu_torch.cli.create_experiment -d DIR [--name NAME] \\
        --model_name {SAVi,ExtendedDINOSAUR} --dataset_name {CATER_Easy,...}

The experiment goes at ``DIR/NAME``, or at ``DIR`` without ``--name``; a
relative ``DIR`` that does not exist goes under ``$TEXTOCVP_EXPERIMENTS``.
It holds ``experiment_params.json`` (the registered configs over the
defaults, the file a user edits) and empty ``models/``, ``plots/`` and
``tboard_logs/``. The choices are the registered configs, those under
``$TEXTOCVP_CONFIGS`` too.
"""

from __future__ import annotations

import argparse
import os

from textocvp_tpu_torch.cli import resolve_exp_dir
from textocvp_tpu_torch.core.config import get_available_configs


def create_experiment_args(argv=None):
    parser = argparse.ArgumentParser(description="Create a decomposition experiment")
    parser.add_argument("-d", "--exp_directory", required=True,
                        help="Directory for the new experiment")
    parser.add_argument("--name", default=None,
                        help="Experiment name; the experiment goes at EXP_DIRECTORY/NAME")
    parser.add_argument("--model_name", required=True, choices=get_available_configs("models"))
    parser.add_argument("--dataset_name", required=True,
                        choices=get_available_configs("datasets"))
    args = parser.parse_args(argv)
    args.exp_directory = resolve_exp_dir(args.exp_directory)
    if args.name:
        args.exp_directory = os.path.join(args.exp_directory, args.name)
    return args


def main(argv=None):
    args = create_experiment_args(argv)
    from textocvp_tpu_torch.core.experiment import Experiment

    exp = Experiment.create(args.exp_directory, args.model_name, args.dataset_name)
    print(f"Created experiment at {exp.exp_path}")
    print(f"  model: {args.model_name}  dataset: {args.dataset_name}")
    return exp


if __name__ == "__main__":
    main()
