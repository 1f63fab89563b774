"""Qualitative figures of a decomposition model (06a).

    python -m textocvp_tpu_torch.cli.generate_figs_decomp -d EXP --decomp_ckpt C \\
        [--num_seqs 10] [--device cuda]

The checkpoint is ``EXP/models/<C>.pt``. For each of the first ``num_seqs``
test sequences the figures land in ``EXP/plots/figs_<C>/sequence_<i>/``
(``train/fig_generation.py::DecompFigGenerator``).
"""

from __future__ import annotations

import argparse

from textocvp_tpu_torch.cli import resolve_exp_dir


def generate_figs_decomp_args(argv=None):
    parser = argparse.ArgumentParser(description="Generate decomposition figures")
    parser.add_argument("-d", "--exp_directory", required=True)
    parser.add_argument("--decomp_ckpt", required=True)
    parser.add_argument("--num_seqs", type=int, default=10)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    args.exp_directory = resolve_exp_dir(args.exp_directory)
    return args


def main(argv=None):
    """Returns the generator (its ``out_dir`` holds the figures)."""
    args = generate_figs_decomp_args(argv)
    from textocvp_tpu_torch.train.fig_generation import DecompFigGenerator

    gen = DecompFigGenerator(args.exp_directory, checkpoint=args.decomp_ckpt,
                             num_seqs=args.num_seqs, device=args.device)
    gen.load_data()
    gen.load_model()
    gen.generate_figs()
    return gen


if __name__ == "__main__":
    main()
