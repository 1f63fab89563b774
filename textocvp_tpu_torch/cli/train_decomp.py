"""Train a decomposition model (02; SAVi or ExtendedDINOSAUR).

    python -m textocvp_tpu_torch.cli.train_decomp -d EXP [--checkpoint C]
        [--resume_training] [--device cuda]

``EXP`` holds ``experiment_params.json``; checkpoints land in
``EXP/models/*.pt``. ``--checkpoint`` starts from ``models/<C>.pt``;
with ``--resume_training`` its optimizer state, epoch and step too. The
device is ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from textocvp_tpu_torch.cli import resolve_exp_dir
from textocvp_tpu_torch.core.logger import print_


def train_decomp_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a decomposition model")
    parser.add_argument("-d", "--exp_directory", required=True)
    parser.add_argument("--checkpoint", default=None, help="Checkpoint to load (warm start)")
    parser.add_argument("--resume_training", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    args.exp_directory = resolve_exp_dir(args.exp_directory)
    return args


def main(argv=None):
    args = train_decomp_args(argv)
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    trainer = DecompTrainer(args.exp_directory, checkpoint=args.checkpoint,
                            resume_training=args.resume_training, device=args.device)
    trainer.load_data()
    trainer.setup_model()
    print_("Starting training loop")
    trainer.training_loop()
    return trainer


if __name__ == "__main__":
    main()
