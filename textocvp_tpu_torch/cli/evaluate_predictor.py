"""Evaluate a predictor checkpoint on the video-prediction protocol (05).

    python -m textocvp_tpu_torch.cli.evaluate_predictor -d EXP --name_pred_exp P \\
        --decomp_ckpt C --pred_ckpt C [--num_seed 1] [--num_preds 19] \\
        [--batch_size 64] [--results_name NAME] [--device cuda]

Checkpoints are ``models/<ckpt>.pt`` (training checkpoints or bare state
dicts) in the decomposition experiment (``-d``) and in its predictor
experiment (``predictors/<P>``).
The metrics land in ``predictors/<P>/results/<NAME>/results.json``, by
default ``NAME = eval_pred_<pred_ckpt>_NumSeed=<c>_NumPreds=<p>``.

Under ``torchrun --nproc_per_node N`` (or the ``TEXTOCVP_*`` environment)
it runs on the mesh of ``tpu.mesh_axes`` (``parallel/``).
"""

from __future__ import annotations

import argparse

from textocvp_tpu_torch.cli import resolve_exp_dir


def evaluate_predictor_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a predictor checkpoint")
    parser.add_argument("-d", "--exp_directory", required=True)
    parser.add_argument("--name_pred_exp", required=True)
    parser.add_argument("--decomp_ckpt", required=True)
    parser.add_argument("--pred_ckpt", required=True)
    parser.add_argument("--results_name", default=None)
    parser.add_argument("--num_seed", type=int, default=None)
    parser.add_argument("--num_preds", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    args.exp_directory = resolve_exp_dir(args.exp_directory)
    return args


def main(argv=None):
    args = evaluate_predictor_args(argv)
    from textocvp_tpu_torch.parallel.distributed import maybe_initialize_distributed

    maybe_initialize_distributed()  # under torchrun or the TEXTOCVP_* environment
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    evaluator = PredictorEvaluator(
        args.exp_directory, args.name_pred_exp, decomp_ckpt=args.decomp_ckpt,
        pred_ckpt=args.pred_ckpt, num_seed=args.num_seed, num_preds=args.num_preds,
        batch_size=args.batch_size, results_name=args.results_name, device=args.device)
    evaluator.load_data()
    evaluator.load_models()
    evaluator.evaluate()
    return 0


if __name__ == "__main__":
    main()
