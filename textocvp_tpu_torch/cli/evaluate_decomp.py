"""Evaluate a decomposition checkpoint on whole-sequence reconstruction (03).

    python -m textocvp_tpu_torch.cli.evaluate_decomp -d EXP --decomp_ckpt C \\
        [--results_name NAME] [--batch_size 64] [--device cuda]

The checkpoint is ``EXP/models/<C>.pt`` (a training checkpoint, a bare state
dict, or an imported one: ``cli/import_torch_checkpoint.py``). The metrics
land in ``EXP/results/<NAME>/results.json``, by default ``NAME =
eval_decomp_<C>``.

Under ``torchrun --nproc_per_node N`` (or the ``TEXTOCVP_*`` environment)
it runs on the mesh of ``tpu.mesh_axes`` (``parallel/``).
"""

from __future__ import annotations

import argparse

from textocvp_tpu_torch.cli import resolve_exp_dir


def evaluate_decomp_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a decomposition checkpoint")
    parser.add_argument("-d", "--exp_directory", required=True)
    parser.add_argument("--decomp_ckpt", required=True)
    parser.add_argument("--results_name", default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    args.exp_directory = resolve_exp_dir(args.exp_directory)
    return args


def main(argv=None):
    args = evaluate_decomp_args(argv)
    from textocvp_tpu_torch.parallel.distributed import maybe_initialize_distributed

    maybe_initialize_distributed()  # under torchrun or the TEXTOCVP_* environment
    from textocvp_tpu_torch.train.evaluator import DecompEvaluator

    evaluator = DecompEvaluator(args.exp_directory, args.decomp_ckpt,
                                batch_size=args.batch_size, results_name=args.results_name,
                                device=args.device)
    evaluator.load_data()
    evaluator.load_model()
    evaluator.evaluate()
    return 0


if __name__ == "__main__":
    main()
