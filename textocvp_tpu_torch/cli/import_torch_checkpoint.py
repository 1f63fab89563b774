"""Import a checkpoint the port did not write into an experiment's ``models/``.

    python -m textocvp_tpu_torch.cli.import_torch_checkpoint -d EXP \\
        --kind {decomp,predictor} (--torch_ckpt X.pth | --jax_ckpt X.msgpack) \\
        [--output_name NAME]

``--torch_ckpt`` is a checkpoint of the reference (``SAVi_CATER.pth``,
``TextOCVP_CATER.pth``, ...), ``--jax_ckpt`` one of the JAX package
(``models/<name>.msgpack``). The model is the one the experiment's params
describe: its decomposition model (``decomp``) or, for a predictor
experiment (``EXP/predictors/P``), its predictor. The result is the port's
``models/<NAME>.pt`` (default: the file's stem) as ``{params, opt_state: {},
epoch: 0, step: 0}``, after a strict load into the experiment's model. The
03 and 05 evaluators, the service and the
trainers' ``--checkpoint`` read.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from textocvp_tpu_torch.cli import resolve_exp_dir


def import_args(argv=None):
    parser = argparse.ArgumentParser(description="Import a .pth or .msgpack checkpoint")
    parser.add_argument("-d", "--exp_directory", required=True,
                        help="Experiment whose params describe the model")
    parser.add_argument("--kind", required=True, choices=["decomp", "predictor"])
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--torch_ckpt", help="A reference .pth checkpoint")
    source.add_argument("--jax_ckpt", help="A JAX package .msgpack checkpoint")
    parser.add_argument("--output_name", default=None,
                        help="Checkpoint name in models/ (default: the file's stem)")
    args = parser.parse_args(argv)
    args.exp_directory = resolve_exp_dir(args.exp_directory)
    return args


def main(argv=None):
    args = import_args(argv)
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.models.factory import setup_model, setup_predictor
    from textocvp_tpu_torch.train.checkpoints import from_jax_checkpoint, save_checkpoint
    from textocvp_tpu_torch.train.torch_import import import_checkpoint, jax_kind

    exp = Experiment(args.exp_directory)
    if args.torch_ckpt:
        source = args.torch_ckpt
        params = import_checkpoint(source, exp.params, args.kind)
    else:
        source = args.jax_ckpt
        params = from_jax_checkpoint(source, jax_kind(exp.params, args.kind))
    # strictly: a file of another model fails here, not at its first use
    (setup_model if args.kind == "decomp" else setup_predictor)(exp.params).load_state_dict(params)
    path = save_checkpoint(exp.checkpoint_path(args.output_name or Path(source).stem),
                           {"params": params, "opt_state": {}, "epoch": 0, "step": 0})
    print(f"Imported {source} -> {path}")
    return path


if __name__ == "__main__":
    main()
