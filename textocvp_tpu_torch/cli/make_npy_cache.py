"""Pre-decode a dataset into uint8 ``.npy`` arrays at the training size
(the port's counterpart of ``scripts/make_npy_cache.py``).

    # CATER: frame directories (or mp4, where imageio has ffmpeg) -> one .npy
    # a video and the split's annotations rewritten to name them
    python -m textocvp_tpu_torch.cli.make_npy_cache --root DATA/cater \\
        --mode easy --split test --img-size 64 [--num-frames 20] [--out OUT]

    # CLIPort: each episode's color/ PNGs -> color_cache_<size>.npy beside
    # its task_description.txt
    python -m textocvp_tpu_torch.cli.make_npy_cache --dataset cliport \\
        --root DATA/cliport --split test --img-size 336x336 [--out OUT]

The frames go through the port's own ``data/datasets.py`` (its PNG decode
and PIL-exact resize), so a cache is bit-identical to the one the JAX
package's script writes from the same files, and the datasets read it in
place of the frames: point ``dataset.root`` at ``OUT`` (default
``<root>_npy<size>``). ``--out`` equal to ``--root`` writes the CLIPort
caches into the episodes themselves.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from textocvp_tpu_torch.core.logger import print_
from textocvp_tpu_torch.data.datasets import (
    _load_image_resized,
    _read_video,
    _resize_frames,
    _size_token,
    _video_length,
)


def _parse_size(s):
    """'336' -> 336 (the shorter side); '336x448' -> [336, 448] (exact)."""
    if isinstance(s, int):
        return s
    if "x" in s:
        return [int(v) for v in s.split("x")]
    return int(s)


def _save_atomic(path: str, arr: np.ndarray):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:  # np.save(path) would add .npy to tmp
        np.save(f, arr)
    os.replace(tmp, path)


def cache_cater(args) -> int:
    sz = tuple(args.img_size) if isinstance(args.img_size, (list, tuple)) else (
        args.img_size, args.img_size)
    src_dir = os.path.join(args.root, args.mode)
    out_root = args.out or f"{args.root.rstrip('/')}_npy{_size_token(args.img_size)}"
    out_dir = os.path.join(out_root, args.mode)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(src_dir, f"{args.split}_explicit.json")) as f:
        annotations = json.load(f)
    new_ann = {}
    for key, ann in annotations.items():
        video_path = os.path.join(src_dir, ann["video"])
        n = _video_length(video_path)
        if args.num_frames:
            n = min(args.num_frames + 1, n)  # fixed-start clips read frames [1, num_frames]
        frames = _read_video(video_path, np.arange(n), size=sz)
        if frames.shape[1:3] != sz:
            frames = _resize_frames(frames, sz)
        out_name = os.path.splitext(os.path.basename(ann["video"]))[0] + ".npy"
        _save_atomic(os.path.join(out_dir, out_name),
                     np.round(np.clip(frames, 0, 1) * 255).astype(np.uint8))
        new_ann[key] = {**ann, "video": out_name}
        if len(new_ann) % 100 == 0:
            print_(f"  cached {len(new_ann)}/{len(annotations)}")
    with open(os.path.join(out_dir, f"{args.split}_explicit.json"), "w") as f:
        json.dump(new_ann, f)
    print_(f"Wrote {len(new_ann)} cached videos to {out_dir}. Point the dataset root at "
           f"{out_root} to use the cache.")
    return 0


def cache_cliport(args) -> int:
    src_dir = os.path.join(args.root, args.split)
    if not os.path.isdir(src_dir):
        raise FileNotFoundError(f"{src_dir} does not exist")
    token = _size_token(args.img_size)
    out_root = args.out or f"{args.root.rstrip('/')}_npy{token}"
    out_dir = os.path.join(out_root, args.split)
    episodes = sorted(e for e in os.listdir(src_dir) if e.startswith("episode"))
    done = 0
    for episode in episodes:
        color_dir = os.path.join(src_dir, episode, "color")
        frame_files = sorted(os.listdir(color_dir)) if os.path.isdir(color_dir) else []
        if not frame_files:
            print_(f"  {episode}: no frames in color/, skipped")
            continue
        ep_out = os.path.join(out_dir, episode)
        os.makedirs(ep_out, exist_ok=True)
        desc = os.path.join(src_dir, episode, "task_description.txt")
        desc_out = os.path.join(ep_out, "task_description.txt")
        if os.path.exists(desc) and os.path.abspath(desc) != os.path.abspath(desc_out):
            shutil.copyfile(desc, desc_out)
        frames = [_load_image_resized(
            os.path.join(color_dir, f"{f.split('_')[0]}_color.png"), args.img_size)
            for f in frame_files]
        _save_atomic(os.path.join(ep_out, f"color_cache_{token}.npy"),
                     np.round(np.clip(np.stack(frames), 0, 1) * 255).astype(np.uint8))
        done += 1
        if done % 50 == 0:
            print_(f"  cached {done}/{len(episodes)}")
    print_(f"Wrote {done} cached episodes to {out_dir} (color_cache_{token}.npy). Point the "
           f"dataset root at {out_root} to use the cache.")
    return 0


def make_npy_cache_args(argv=None):
    ap = argparse.ArgumentParser(description="Pre-decode a dataset into uint8 .npy caches")
    ap.add_argument("--dataset", default="cater", choices=["cater", "cliport"])
    ap.add_argument("--root", required=True,
                    help="dataset root (cater: holds <mode>/; cliport: holds <split>/episode*)")
    ap.add_argument("--mode", default="easy", choices=["easy", "hard"], help="cater only")
    ap.add_argument("--split", default="train")
    ap.add_argument("--img-size", type=_parse_size, default=64,
                    help="an int N (cater: N x N; cliport: the shorter side) or HxW, exact "
                         "(the CLIPort config's 336x336)")
    ap.add_argument("--out", default=None, help="output root (default <root>_npy<img-size>)")
    ap.add_argument("--num-frames", type=int, default=None,
                    help="cater only: cache N + 1 frames, enough for clips of N from the fixed "
                         "start at frame 1 (default: every frame)")
    return ap.parse_args(argv)


def main(argv=None):
    args = make_npy_cache_args(argv)
    return cache_cliport(args) if args.dataset == "cliport" else cache_cater(args)


if __name__ == "__main__":
    raise SystemExit(main())
