"""
Evaluation metrics of the port: PSNR, SSIM and LPIPS, computed on the
device (counterpart of ``textocvp_tpu/train/metrics.py``).

Every metric takes NHWC video tensors (B, F, H, W, C) in [0, 1] and returns
framewise values (B, F) in float32; :class:`MetricTracker` accumulates them
on the host and writes the ``results.json`` format of the JAX package.

* PSNR: -10 log10(mse) over (H, W, C) per frame, value range 1, the mse
  clamped at 1e-10.
* SSIM: Gaussian window 11, sigma 1.5, k1 = 0.01, k2 = 0.03, VALID padding,
  per-channel maps averaged over space and channels; one grouped separable
  blur over the stacked [x, y, x^2, y^2, xy], as the JAX package does.
* LPIPS: AlexNet features (the LPIPS v0.1 scaling layer, unit-normalized
  channel activations at the 5 ReLU taps, learned per-channel weights,
  spatial mean, sum over layers). Weights load from a local ``.npz``
  (``TEXTOCVP_LPIPS_WEIGHTS``, the JAX package's layout: HWIO kernels);
  without one a deterministic random head is used and the results say
  ``lpips.comparable: false``.

The convolutions run through ``F.conv2d``; on the card the caller turns TF32
off (``torch.backends.cudnn.allow_tf32 = False``), as the evaluator does.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------- PSNR


def psnr(preds, targets, value_range: float = 1.0):
    """Framewise PSNR: (B, F, H, W, C) -> (B, F)."""
    mse = torch.mean(torch.square(preds.float() - targets.float()), dim=(-3, -2, -1))
    return 10.0 * torch.log10(value_range ** 2 / torch.clamp(mse, min=1e-10))


# --------------------------------------------------------------------------- SSIM


def _gaussian_kernel(window_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(window_size, dtype=np.float64) - (window_size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_valid(x, kernel1d):
    """Separable VALID filter of every channel of NCHW ``x``: rows, then columns."""
    c = x.shape[1]
    k = kernel1d.shape[0]
    x = F.conv2d(x, kernel1d.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, kernel1d.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(preds, targets, window_size: int = 11, sigma: float = 1.5,
         value_range: float = 1.0, k1: float = 0.01, k2: float = 0.03):
    """Framewise SSIM: (B, F, H, W, C) -> (B, F)."""
    b, f = preds.shape[:2]
    x = preds.reshape(b * f, *preds.shape[2:]).float().permute(0, 3, 1, 2)
    y = targets.reshape(b * f, *targets.shape[2:]).float().permute(0, 3, 1, 2)
    kernel = torch.from_numpy(_gaussian_kernel(window_size, sigma)).to(x.device)
    c1 = (k1 * value_range) ** 2
    c2 = (k2 * value_range) ** 2
    c = x.shape[1]
    mu = _filter2d_valid(torch.cat([x, y, x * x, y * y, x * y], dim=1), kernel)
    mu_x, mu_y, mu_xx, mu_yy, mu_xy = (mu[:, i * c:(i + 1) * c] for i in range(5))
    var_x = mu_xx - mu_x ** 2
    var_y = mu_yy - mu_y ** 2
    cov_xy = mu_xy - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * cov_xy + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2))
    return ssim_map.mean(dim=(1, 2, 3)).reshape(b, f)


# --------------------------------------------------------------------------- LPIPS

# LPIPS v0.1 input scaling (lpips.ScalingLayer)
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)

# AlexNet feature extractor: (out_channels, kernel, stride, padding, pre_pool)
_ALEX_LAYERS = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]


def _default_lpips_weights(seed: int = 14) -> dict:
    """Deterministic random AlexNet + linear head (HWIO kernels), NOT
    pretrained: it keeps the pipeline runnable without a weight file. The
    same numpy draws as the JAX package's."""
    rng = np.random.default_rng(seed)
    params = {}
    in_ch = 3
    for i, (out_ch, k, _, _, _) in enumerate(_ALEX_LAYERS):
        fan_in = in_ch * k * k
        params[f"conv{i}_kernel"] = (
            rng.standard_normal((k, k, in_ch, out_ch)) / np.sqrt(fan_in)).astype(np.float32)
        params[f"conv{i}_bias"] = np.zeros((out_ch,), dtype=np.float32)
        params[f"lin{i}"] = np.abs(rng.standard_normal((out_ch,)).astype(np.float32)) / out_ch
        in_ch = out_ch
    return params


def load_lpips_weights(path: Optional[str] = None) -> tuple[dict, bool]:
    """LPIPS weights from an ``.npz`` (``path`` or ``TEXTOCVP_LPIPS_WEIGHTS``),
    else the deterministic random head. Returns (params, pretrained)."""
    path = path or os.environ.get("TEXTOCVP_LPIPS_WEIGHTS", "")
    if path and os.path.exists(path):
        data = np.load(path)
        return {k: data[k] for k in data.files}, True
    return _default_lpips_weights(), False


class LPIPS:
    """Framewise LPIPS (B, F, H, W, C) -> (B, F) with weights held on ``device``
    (conv kernels OIHW, converted once from the HWIO ``.npz`` layout)."""

    def __init__(self, weights: dict, device="cpu"):
        self.device = torch.device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self.kernels = [t(weights[f"conv{i}_kernel"]).permute(3, 2, 0, 1).contiguous()
                        for i in range(len(_ALEX_LAYERS))]
        self.biases = [t(weights[f"conv{i}_bias"]) for i in range(len(_ALEX_LAYERS))]
        self.lins = [t(weights[f"lin{i}"]) for i in range(len(_ALEX_LAYERS))]
        self.shift = t(_LPIPS_SHIFT).reshape(1, 3, 1, 1)
        self.scale = t(_LPIPS_SCALE).reshape(1, 3, 1, 1)

    def _features(self, x):
        feats = []
        for i, (_, _, stride, pad, pre_pool) in enumerate(_ALEX_LAYERS):
            if pre_pool:
                x = F.max_pool2d(x, kernel_size=3, stride=2)
            x = F.relu(F.conv2d(x, self.kernels[i], self.biases[i], stride=stride, padding=pad))
            feats.append(x)
        return feats

    def __call__(self, preds, targets):
        b, f = preds.shape[:2]
        x = preds.reshape(b * f, *preds.shape[2:]).float().permute(0, 3, 1, 2)
        y = targets.reshape(b * f, *targets.shape[2:]).float().permute(0, 3, 1, 2)
        # AlexNet's stride-4 conv and two pools need >= 32 px; smaller frames
        # are resized up (bilinear, half-pixel centres), as the JAX package does
        h, w = x.shape[-2:]
        if h < 32 or w < 32:
            size = (max(32, h), max(32, w))
            x = F.interpolate(x, size=size, mode="bilinear", align_corners=False)
            y = F.interpolate(y, size=size, mode="bilinear", align_corners=False)
        x = (2 * x - 1 - self.shift) / self.scale
        y = (2 * y - 1 - self.shift) / self.scale
        total = 0.0
        for i, (a, c) in enumerate(zip(self._features(x), self._features(y))):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            c = c / torch.sqrt(torch.sum(c * c, dim=1, keepdim=True) + 1e-10)
            d = torch.square(a - c) * self.lins[i].reshape(1, -1, 1, 1)
            total = total + d.sum(dim=1).mean(dim=(1, 2))
        return total.reshape(b, f)


# ---------------------------------------------------------------- MetricTracker


class MetricTracker:
    """Accumulate framewise metric values on the host and aggregate mean and
    per-frame results; ``to_json`` is the JAX package's results.json shape."""

    METRICS = ("psnr", "ssim", "lpips")

    def __init__(self, metrics=("psnr", "ssim", "lpips"), lpips_weights: Optional[dict] = None,
                 lpips_pretrained: Optional[bool] = None, device="cpu"):
        for m in metrics:
            if m not in self.METRICS:
                raise NameError(f"Unknown metric {m!r}. Use one of {self.METRICS}")
        self.metrics = tuple(metrics)
        self._lpips = None
        self.lpips_comparable = None
        if "lpips" in metrics:
            if lpips_weights is None:
                lpips_weights, pretrained = load_lpips_weights()
            else:
                # explicit weights are trusted unless the caller says otherwise
                pretrained = True if lpips_pretrained is None else lpips_pretrained
            self.lpips_comparable = bool(pretrained)
            self._lpips = LPIPS(lpips_weights, device)
            if not self.lpips_comparable:
                warnings.warn(
                    "LPIPS is using the deterministic RANDOM AlexNet fallback: values are "
                    "NOT comparable to pretrained LPIPS. Point TEXTOCVP_LPIPS_WEIGHTS at an "
                    ".npz of real weights; results.json carries 'lpips': {'comparable': false}.",
                    stacklevel=2)
        self.reset()

    def reset(self):
        self.values = {m: [] for m in self.metrics}
        self.results = {}

    def compute(self, preds, targets) -> dict:
        """Framewise metrics of one batch, on the tensors' device."""
        out = {}
        if "psnr" in self.metrics:
            out["psnr"] = psnr(preds, targets)
        if "ssim" in self.metrics:
            out["ssim"] = ssim(preds, targets)
        if "lpips" in self.metrics:
            out["lpips"] = self._lpips(preds, targets)
        return out

    def accumulate(self, preds=None, targets=None, precomputed: Optional[dict] = None):
        vals = precomputed if precomputed is not None else self.compute(preds, targets)
        for m in self.metrics:
            v = vals[m]
            self.values[m].append(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                  else np.asarray(v))

    def aggregate(self) -> dict:
        for m in self.metrics:
            if not self.values[m]:
                continue
            all_vals = np.concatenate(self.values[m], axis=0)  # (N, F)
            self.results[m] = {
                "mean": float(all_vals.mean()),
                "framewise": [float(v) for v in all_vals.mean(axis=0)],
            }
        return self.results

    def summary(self) -> dict:
        if not self.results:
            self.aggregate()
        return self.results

    def to_json(self) -> dict:
        res = {}
        for m, v in self.summary().items():
            res[m] = {"mean": round(v["mean"], 5),
                      "framewise": [round(x, 5) for x in v["framewise"]]}
        if "lpips" in res and self.lpips_comparable is not None:
            res["lpips"]["comparable"] = self.lpips_comparable
        return res
