"""Train a slot predictor with a frozen decomposition model (04; TextOCVP_T5
on CATER SAVi or CLIPort ExtendedDINOSAUR).

    python -m textocvp_tpu_torch.cli.train_predictor -d EXP --name_pred_exp P
        --decomp_ckpt C [--checkpoint C] [--resume_training] [--device cuda]

``EXP`` is the decomposition experiment, whose ``models/<decomp_ckpt>.pt``
holds the frozen decomposition model; the predictor experiment is ``EXP/predictors/P``
(its ``experiment_params.json``), and its checkpoints land in
``EXP/predictors/P/models/*.pt``. ``--checkpoint`` starts the predictor from
``models/<C>.pt`` of the predictor experiment; with ``--resume_training`` its
optimizer state, epoch and step too. The device is ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

from textocvp_tpu_torch.cli import resolve_exp_dir
from textocvp_tpu_torch.core.logger import print_


def train_predictor_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a slot predictor")
    parser.add_argument("-d", "--exp_directory", required=True,
                        help="Parent decomposition experiment directory")
    parser.add_argument("--name_pred_exp", required=True)
    parser.add_argument("--decomp_ckpt", required=True,
                        help="Checkpoint of the frozen decomposition model")
    parser.add_argument("--checkpoint", default=None, help="Predictor checkpoint to load")
    parser.add_argument("--resume_training", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    args.exp_directory = resolve_exp_dir(args.exp_directory)
    return args


def main(argv=None):
    args = train_predictor_args(argv)
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    exp_path = os.path.join(args.exp_directory, "predictors", args.name_pred_exp)
    trainer = PredictorTrainer(exp_path, decomp_ckpt=args.decomp_ckpt,
                               checkpoint=args.checkpoint,
                               resume_training=args.resume_training, device=args.device)
    trainer.load_data()
    trainer.setup_model()
    print_("Starting predictor training loop")
    trainer.training_loop()
    return trainer


if __name__ == "__main__":
    main()
