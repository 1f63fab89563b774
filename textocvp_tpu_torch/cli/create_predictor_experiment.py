"""Create a predictor experiment nested in a decomposition experiment (01).

    python -m textocvp_tpu_torch.cli.create_predictor_experiment -d EXP \\
        --name_pred_exp NAME --predictor_name {TextOCVP_T5,...} [--skip_ckpt_check]

The experiment goes at ``EXP/predictors/NAME`` (``--name`` is the same
option). Its params are the parent's with the predictor config merged in.
The parent must hold a checkpoint in its ``models/`` unless
``--skip_ckpt_check``.
"""

from __future__ import annotations

import argparse

from textocvp_tpu_torch.cli import resolve_exp_dir
from textocvp_tpu_torch.core.config import get_available_configs


def create_predictor_experiment_args(argv=None):
    parser = argparse.ArgumentParser(description="Create a nested predictor experiment")
    parser.add_argument("-d", "--exp_directory", required=True,
                        help="Parent decomposition experiment directory")
    parser.add_argument("--name_pred_exp", "--name", dest="name_pred_exp", required=True,
                        help="Name of the new predictor experiment")
    parser.add_argument("--predictor_name", required=True,
                        choices=get_available_configs("predictors"))
    parser.add_argument("--skip_ckpt_check", action="store_true",
                        help="Create it although the parent has no checkpoint")
    args = parser.parse_args(argv)
    args.exp_directory = resolve_exp_dir(args.exp_directory)
    return args


def main(argv=None):
    args = create_predictor_experiment_args(argv)
    from textocvp_tpu_torch.core.experiment import Experiment

    exp = Experiment.create_predictor(args.exp_directory, args.name_pred_exp,
                                      args.predictor_name,
                                      require_parent_ckpt=not args.skip_ckpt_check)
    print(f"Created predictor experiment at {exp.exp_path}")
    return exp


if __name__ == "__main__":
    main()
