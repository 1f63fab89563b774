"""
06 figures of the port (counterpart of ``textocvp_tpu/train/fig_generation.py``;
reference 06_generate_figs_decomp_model.py and 06_generate_figs_predictor.py),
drawn by ``viz/figures.py`` with PIL.

:class:`DecompFigGenerator` (06a), per test sequence, under
``plots/figs_<ckpt>/sequence_<i>/``: the reconstructions (``recons.png``,
``recons.gif``; not for a features-only decoder), the objects and masks
(``objects.png``, ``masks.png``) and the segmentation overlays
(``segmentation.png``). SAVi's masks are (T, S, H, W, 1) with decoded
objects; ExtendedDINOSAUR's are patch alphas (T, S, 1, gh, gw), its objects
the frames masked at 96 px (``viz.process_objs_masks_dinosaur``).

:class:`PredictorFigGenerator` (06b), per test sequence, under
``plots/figs_pred_<ckpt>_NumPreds=<p>/sequence_<i>_psnr=<.2f>_lpips=<.3f>/``:
``qual_eval_rgb.png``, ``aligned_slots.png``, ``masks_GIF_masks.gif``,
``overlay_GIF.gif``, ``gt_obj_<k>.gif`` a slot, ``gt_GIF_frames.gif``,
``pred_GIF_frames.gif`` and ``prompt.txt``. The seed frames are decomposed
once and decoded (the JAX ``decode_seed``), the rollout runs from those
slots, and its predicted slots are decoded whole, once, for both the
prediction metrics and the objects (the JAX ``decode_full``).

Both run at batch 1 on the device under ``inference_mode``. Each sequence
draws its slot noise from the evaluator's generator, seeded 14 (torch
cannot reproduce ``fold_in(PRNGKey(14), i)``), unless the per-sequence
methods get ``initial_slots``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from textocvp_tpu_torch.core.logger import print_
from textocvp_tpu_torch.data.wire import as_float_video
from textocvp_tpu_torch.train.evaluator import DecompEvaluator, PredictorEvaluator
from textocvp_tpu_torch.viz import figures as viz


def _host(out: dict, keys, first: bool) -> dict:
    """The device tensors of ``out`` named in ``keys`` as float32 numpy
    arrays, of the first batch row when ``first``."""
    return {k: (out[k][0] if first else out[k]).float().cpu().numpy()
            for k in keys if out.get(k) is not None}


class DecompFigGenerator(DecompEvaluator):
    """Figure generation for decomposition models (batch_size=1 sequences)."""

    # feature-only decoders (reconstruct_images=false) still produce
    # masks/objects figures; only the recons panels are skipped.
    requires_image_reconstruction = False

    def __init__(self, exp_path, checkpoint: str, num_seqs: int = 10, device="cuda"):
        super().__init__(exp_path, checkpoint, batch_size=1, metrics=("psnr",), device=device)
        self.num_seqs = num_seqs
        self.out_dir = self.exp.plots_dir / f"figs_{checkpoint}"

    @torch.inference_mode()
    def decompose_decoded(self, videos, initial_slots=None) -> dict:
        """The model's whole-sequence forward with decoding on videos (B, T, H,
        W, 3) on the device (the JAX ``model.apply(variables, videos)``)."""
        out = self.model.decompose(
            videos, initial_slots=None if initial_slots is None else initial_slots.to(self.device),
            generator=self.generator)
        out.update(self.model.decoded(out["slot_history"]))
        return out

    def sequence_figs(self, i: int, videos, initial_slots=None):
        """The figures of test sequence ``i`` (``videos`` (1, T, H, W, 3) from
        the loader) -> its directory."""
        out = _host(self.decompose_decoded(self.to_device(videos), initial_slots),
                    ("recons_imgs", "recons_objs", "masks"), first=True)
        seq_dir = self.out_dir / f"sequence_{i:02d}"
        gt = as_float_video(np.asarray(videos)[0])
        if "recons_imgs" in out:
            recons = np.clip(out["recons_imgs"], 0, 1)
            viz.visualize_recons(gt, recons, savepath=seq_dir / "recons.png")
            viz.make_gif(recons, seq_dir / "recons.gif", n_seed=len(recons))
        masks = out.get("masks")
        if masks is not None and masks.shape[-1] == 1:  # SAVi (T, S, H, W, 1)
            objs = np.clip(out["recons_objs"] * masks, 0, 1)
            viz.visualize_decomp(objs, savepath=seq_dir / "objects.png")
            viz.visualize_decomp(masks, savepath=seq_dir / "masks.png")
            overlays = np.stack([
                viz.overlay_segmentations(gt[t], masks[t]) for t in range(gt.shape[0])
            ])
            viz.visualize_sequence(overlays, savepath=seq_dir / "segmentation.png")
        elif masks is not None:  # DINOSAUR (T, S, 1, gh, gw) patch alphas
            objs, masks_up, frames_tiny = viz.process_objs_masks_dinosaur(
                gt, masks, out_size=96, return_all=True)
            viz.visualize_decomp(objs, savepath=seq_dir / "objects.png")
            viz.visualize_decomp(masks_up[..., None], savepath=seq_dir / "masks.png")
            onehot = viz.idx_to_one_hot(np.argmax(masks_up, axis=1),
                                        num_classes=masks_up.shape[1])
            overlays = np.stack([
                viz.overlay_segmentations(frames_tiny[t], onehot[t])
                for t in range(gt.shape[0])
            ])
            viz.visualize_sequence(overlays, savepath=seq_dir / "segmentation.png")
        print_(f"Saved figures for sequence {i} -> {seq_dir}")
        return seq_dir

    def generate_figs(self):
        for i, (videos, _) in enumerate(self.test_loader):
            if i >= self.num_seqs:
                break
            self.sequence_figs(i, videos)
        return self.out_dir


class PredictorFigGenerator(PredictorEvaluator):
    """Figure/GIF generation for predictors (batch_size=1 sequences).
    ``sequence_metrics`` holds each sequence's mean PSNR and LPIPS, the
    numbers in its directory's name."""

    def __init__(self, exp_path, name_pred_exp, decomp_ckpt, pred_ckpt,
                 num_seed: Optional[int] = None, num_preds: Optional[int] = None,
                 num_seqs: int = 10, device="cuda"):
        super().__init__(exp_path, name_pred_exp, decomp_ckpt, pred_ckpt,
                         num_seed=num_seed, num_preds=num_preds, batch_size=1,
                         metrics=("psnr", "lpips"), device=device)
        self.num_seqs = num_seqs
        self.out_dir = self.exp.plots_dir / f"figs_pred_{pred_ckpt}_NumPreds={self.num_preds}"
        self.sequence_metrics = []

    @torch.inference_mode()
    def rollout(self, videos, text: dict, initial_slots=None):
        """One batch on the device: the seed frames decomposed and decoded,
        the rollout from their slots, every predicted frame decoded, and the
        metrics -> (seed decode (B, c, ...), predicted decode (B * p, ...),
        predictions (B, p, H, W, 3) clipped to [0, 1], {metric: (B, p)})."""
        c, p = self.num_context, self.num_preds
        b = videos.shape[0]
        init = (self.model.slot_initializer(b, self.generator) if initial_slots is None
                else initial_slots.to(self.device))
        slots = self.model.decompose(videos[:, :c], initial_slots=init)["slot_history"]
        seed_dec = self.model.decoded(slots)
        pred_slots = self.predictor(slots, num_preds=p, teacher_force=False, **text)
        pred_dec = self.model.decode(pred_slots.reshape(b * p, *pred_slots.shape[2:]))
        imgs = pred_dec["recons_imgs"]
        pred_imgs = imgs.reshape(b, p, *imgs.shape[1:]).clamp(0.0, 1.0)
        return seed_dec, pred_dec, pred_imgs, self.metrics_stage(pred_imgs, videos)

    @staticmethod
    def _objs_masks(frames, objs, masks):
        """Normalize SAVi / DINOSAUR mask layouts to per-object crops
        (T, S, h, w, C), spatial masks (T, S, h, w) and matching frames.
        SAVi: masks (T, S, H, W, 1) + decoded per-object RGB. DINOSAUR:
        masks (T, S, 1, gh, gw) patch-grid alphas, objects built by masking
        the frames at 96px (reference 06_generate_figs_predictor.py:160-171)."""
        if masks is None:
            return None, None, frames
        masks = np.asarray(masks)
        if masks.shape[-1] == 1:  # SAVi
            objs = np.asarray(objs) * masks
            return objs, masks[..., 0], frames
        return viz.process_objs_masks_dinosaur(frames, masks, out_size=96,
                                               return_all=True)

    def sequence_figs(self, i: int, videos, info: dict, initial_slots=None):
        """The figures of test sequence ``i`` (``videos`` (1, T, H, W, 3) and
        ``info`` from the loader) -> (its directory, {"psnr", "lpips"})."""
        c, p = self.num_context, self.num_preds
        seed_dec, pred_dec, pred_imgs, vals = self.rollout(*self.to_device(videos, info),
                                                           initial_slots)
        metrics = {"psnr": vals["psnr"].mean().item(),
                   "lpips": vals["lpips"].mean().item() if "lpips" in vals else 0.0}
        seq_dir = self.out_dir / (
            f"sequence_{i:02d}_psnr={metrics['psnr']:.2f}_lpips={metrics['lpips']:.3f}")
        seq_dir.mkdir(parents=True, exist_ok=True)

        gt = np.clip(as_float_video(np.asarray(videos)[0]), 0, 1)
        preds = np.clip(pred_imgs[0].cpu().numpy(), 0, 1)
        seed_dec = _host(seed_dec, ("recons_objs", "masks"), first=True)
        pred_dec = _host(pred_dec, ("recons", "masks"), first=False)

        # qualitative panel (reference qual_eval_rgb.png)
        viz.visualize_qualitative_eval(
            gt[:c], gt[c : c + p], preds, savepath=seq_dir / "qual_eval_rgb.png"
        )

        # per-object decompositions of seed + predicted frames
        seed_objs, seed_masks, seed_frames = self._objs_masks(
            gt[:c], seed_dec.get("recons_objs"), seed_dec.get("masks"))
        pred_objs, pred_masks, pred_frames = self._objs_masks(
            preds, pred_dec.get("recons"), pred_dec.get("masks"))

        if seed_objs is not None and pred_objs is not None:
            # aligned slots: green seed / red pred borders per object
            # (reference 06_generate_figs_predictor.py:181-187)
            all_objs = np.concatenate([
                viz.add_border(seed_objs, viz.GREEN, pad=2),
                viz.add_border(pred_objs, viz.RED, pad=2),
            ], axis=0)  # (c+p, S, h, w, C)
            viz.visualize_aligned_slots(all_objs, savepath=seq_dir / "aligned_slots.png")

            # segmentation GIFs (masks -> categorical -> RGB; overlay)
            all_masks = np.concatenate([seed_masks, pred_masks], axis=0)
            cat = np.argmax(all_masks, axis=1)  # (c+p, h, w)
            masks_vis = viz.COLORS[cat % len(viz.COLORS)]
            onehot = viz.idx_to_one_hot(cat, num_classes=all_masks.shape[1])
            frames_overlay = np.concatenate([seed_frames, pred_frames], axis=0)
            overlay = np.stack([
                viz.overlay_segmentations(frames_overlay[t], onehot[t])
                for t in range(c + p)
            ])
            viz.make_gif(masks_vis, seq_dir / "masks_GIF_masks.gif", n_seed=c)
            viz.make_gif(overlay, seq_dir / "overlay_GIF.gif", n_seed=c)

            # per-object GIFs (reference :243-252)
            for obj_id in range(all_objs.shape[1]):
                viz.make_gif(all_objs[:, obj_id], seq_dir / f"gt_obj_{obj_id + 1}.gif",
                             n_seed=c, use_border=False)

        # sequence GIFs (reference :221-239: GT all-green, pred seed/pred)
        viz.make_gif(gt[: c + p], seq_dir / "gt_GIF_frames.gif", n_seed=c + p)
        viz.make_gif(np.concatenate([gt[:c], preds], axis=0),
                     seq_dir / "pred_GIF_frames.gif", n_seed=c)

        caption = info.get("caption", [""])[0]
        with open(seq_dir / "prompt.txt", "w") as f:
            f.write(str(caption) + "\n")
        print_(f"Saved prediction figures for sequence {i} -> {seq_dir}")
        return seq_dir, metrics

    def generate_figs(self):
        self.sequence_metrics = []
        for i, (videos, info) in enumerate(self.test_loader):
            if i >= self.num_seqs:
                break
            self.sequence_metrics.append(self.sequence_figs(i, videos, info)[1])
        return self.out_dir
