"""Serve a trained predictor experiment over HTTP on the card.

    python -m textocvp_tpu_torch.cli.serve -d EXP --name_pred_exp P \\
        --decomp_ckpt C --pred_ckpt C [--device cuda]

Checkpoints are ``models/<ckpt>.pt`` torch state dicts in the decomposition
experiment (``-d``) and in its predictor experiment (``predictors/<P>``).
"""

from __future__ import annotations

import argparse
import logging
import os


def serve_args(argv=None):
    parser = argparse.ArgumentParser(description="Serve text-conditioned video prediction over HTTP")
    parser.add_argument("-d", "--exp_directory", required=True)
    parser.add_argument("--name_pred_exp", required=True)
    parser.add_argument("--decomp_ckpt", required=True)
    parser.add_argument("--pred_ckpt", required=True)
    parser.add_argument("--num_seed", type=int, default=None)
    parser.add_argument("--num_preds", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=8,
                        help="service batch (requests are padded to it)")
    parser.add_argument("--max_tokens", type=int, default=24)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--wire_dtype", default="float32", choices=["float32", "uint8"],
                        help="uint8 ships context frames to the device as uint8 and "
                             "normalizes there; float inputs snap to the 1/255 grid")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    if not os.path.isabs(args.exp_directory) and not os.path.exists(args.exp_directory):
        root = os.environ.get("TEXTOCVP_EXPERIMENTS", os.path.join(os.getcwd(), "experiments"))
        args.exp_directory = os.path.join(root, args.exp_directory)
    return args


def main(argv=None):
    args = serve_args(argv)
    from textocvp_tpu_torch.serve import PredictionService, serve

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    service = PredictionService(
        args.exp_directory, args.name_pred_exp,
        decomp_ckpt=args.decomp_ckpt, pred_ckpt=args.pred_ckpt,
        num_seed=args.num_seed, num_preds=args.num_preds,
        batch_size=args.batch_size, max_tokens=args.max_tokens,
        wire_dtype=args.wire_dtype, device=args.device)
    httpd = serve(service, host=args.host, port=args.port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    main()
