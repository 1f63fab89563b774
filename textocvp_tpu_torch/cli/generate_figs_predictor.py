"""Qualitative figures and GIFs of a predictor (06b).

    python -m textocvp_tpu_torch.cli.generate_figs_predictor -d EXP --name_pred_exp P \\
        --decomp_ckpt C --pred_ckpt C [--num_seed 1] [--num_preds 19] [--num_seqs 10] \\
        [--device cuda]

Checkpoints are ``models/<ckpt>.pt`` in the decomposition experiment (``-d``)
and in its predictor experiment (``predictors/<P>``). For each of the first
``num_seqs`` test sequences the figures land in
``predictors/<P>/plots/figs_pred_<ckpt>_NumPreds=<p>/sequence_<i>_psnr=..._lpips=.../``
(``train/fig_generation.py::PredictorFigGenerator``).
"""

from __future__ import annotations

import argparse

from textocvp_tpu_torch.cli import resolve_exp_dir


def generate_figs_predictor_args(argv=None):
    parser = argparse.ArgumentParser(description="Generate prediction figures and GIFs")
    parser.add_argument("-d", "--exp_directory", required=True)
    parser.add_argument("--name_pred_exp", required=True)
    parser.add_argument("--decomp_ckpt", required=True)
    parser.add_argument("--pred_ckpt", required=True)
    parser.add_argument("--num_seed", type=int, default=None)
    parser.add_argument("--num_preds", type=int, default=None)
    parser.add_argument("--num_seqs", type=int, default=10)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    args.exp_directory = resolve_exp_dir(args.exp_directory)
    return args


def main(argv=None):
    """Returns the generator (``out_dir``, ``sequence_metrics``)."""
    args = generate_figs_predictor_args(argv)
    from textocvp_tpu_torch.train.fig_generation import PredictorFigGenerator

    gen = PredictorFigGenerator(
        args.exp_directory, args.name_pred_exp, decomp_ckpt=args.decomp_ckpt,
        pred_ckpt=args.pred_ckpt, num_seed=args.num_seed, num_preds=args.num_preds,
        num_seqs=args.num_seqs, device=args.device)
    gen.load_data()
    gen.load_models()
    gen.generate_figs()
    return gen


if __name__ == "__main__":
    main()
