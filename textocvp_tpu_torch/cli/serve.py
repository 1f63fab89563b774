"""Serve a trained predictor experiment over HTTP on the card.

    python -m textocvp_tpu_torch.cli.serve -d EXP --name_pred_exp P \\
        --decomp_ckpt C --pred_ckpt C [--dynamic_batch_ms 20 [--pipeline_depth 2]] \\
        [--device cuda]

Checkpoints are ``models/<ckpt>.pt`` (training checkpoints or bare state
dicts) in the decomposition experiment (``-d``) and in its predictor
experiment (``predictors/<P>``).
"""

from __future__ import annotations

import argparse
import logging

from textocvp_tpu_torch.cli import resolve_exp_dir


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
    parser.add_argument("--dynamic_batch_ms", type=float, default=None,
                        help="coalesce concurrent requests into shared "
                             "device batches, waiting at most this many ms "
                             "to fill a batch (off by default)")
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="dispatcher threads for dynamic batching: 2 "
                             "packs batch N+1 while N runs on-device "
                             "(lower p95), 1 dispatches serially")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    args.exp_directory = resolve_exp_dir(args.exp_directory)
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
    httpd = serve(service, host=args.host, port=args.port,
                  dynamic_batch_ms=args.dynamic_batch_ms, pipeline_depth=args.pipeline_depth)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if httpd.batcher is not None:
            httpd.batcher.close()
    return 0


if __name__ == "__main__":
    main()
