"""
Figures and GIFs of the port (counterpart of ``textocvp_tpu/viz/figures.py``),
drawn with PIL alone: the card's machine has neither matplotlib nor imageio.

The array helpers (``COLORS``, ``add_border``, ``GREEN`` / ``RED``,
``masks_to_rgb``, ``overlay_segmentations``, ``idx_to_one_hot``,
``process_objs_masks_dinosaur``) are copies of the JAX package's and give
the same arrays bit for bit.

Each ``visualize_*`` draws the JAX figure's grid of panels, the same rows and
columns in the same order, on a white RGB canvas. A panel is its array
quantised to uint8 (``data/wire.py::to_uint8_frames``) and upscaled by a
whole factor, nearest. One-channel panels go through matplotlib's ``gray``
between ``vmin`` and ``vmax``, the reconstruction error through ``magma``
(``viz/magma.py``) normalised to its own min and max, as ``imshow`` maps
them. Titles and labels use ``ImageFont.load_default()``. Each returns a
:class:`Figure`, the canvas with each panel's box, so that a reader can take
every panel back out of the PNG (:func:`panel_pixels`). ``make_gif`` hands
PIL's GIF writer what ``imageio.mimsave`` hands it. Without PIL every
drawing function raises ``ImportError`` naming it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from textocvp_tpu_torch.data.wire import to_uint8_frames
from textocvp_tpu_torch.viz.magma import MAGMA

# distinct colors for segmentation overlays (reference CONFIG.py:76-80 uses
# named webcolors; RGB triplets here to avoid the webcolors dependency)
COLORS = np.array([
    (255, 255, 255), (0, 0, 255), (0, 128, 0), (128, 128, 0), (255, 0, 0),
    (255, 255, 0), (128, 0, 128), (255, 165, 0), (0, 255, 255), (165, 42, 42),
    (255, 192, 203), (255, 140, 0), (218, 165, 32), (148, 0, 211), (0, 255, 127),
    (0, 255, 255), (65, 105, 225), (0, 0, 128), (34, 139, 34), (221, 160, 221),
    (255, 0, 255), (112, 128, 144), (128, 0, 0), (255, 215, 0), (255, 218, 185),
    (192, 192, 192), (127, 255, 212), (205, 92, 92), (173, 255, 47), (0, 139, 139),
    (244, 164, 96),
], dtype=np.float32) / 255.0

GREEN = np.array([0.0, 0.8, 0.0])
RED = np.array([0.8, 0.0, 0.0])

PANEL_PX = 128                # panels upscale by PANEL_PX // their longer side, at least 1
MARGIN, GAP = 8, 4            # canvas margin and the gap between panels, pixels
WHITE, BLACK = (255, 255, 255), (0, 0, 0)
LINE_RGB = (31, 119, 180)     # matplotlib's first default line colour
GRID_RGB = (235, 235, 235)
METRIC_SIZE = (600, 400)      # the JAX figure's 6 x 4 inches at 100 dpi
_MAGMA = np.array(MAGMA)


def _pil():
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError("textocvp_tpu_torch.viz draws with PIL (Pillow), "
                          "which is not installed") from e
    return Image, ImageDraw, ImageFont


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


@dataclass
class Figure:
    """A drawn figure: the RGB canvas, each panel's box (left, top, right,
    bottom) by (row, column), the panels' upscaling factor, and for
    :func:`visualize_metric` the markers' pixel centres."""
    image: object
    panels: dict
    scale: int
    points: list = field(default_factory=list)

    def save(self, savepath):
        Path(savepath).parent.mkdir(parents=True, exist_ok=True)
        self.image.save(savepath)


def panel_pixels(image, box, scale: int) -> np.ndarray:
    """The uint8 (H, W, 3) array a panel shows: ``box`` of the PIL ``image``
    (e.g. a figure's PNG read back) taken at every ``scale``-th pixel."""
    left, top, right, bottom = box
    return np.asarray(image.convert("RGB"))[top:bottom:scale, left:right:scale]


def _finish(fig: Figure, savepath) -> Figure:
    if savepath is not None:
        fig.save(savepath)
    return fig


def _normalize(x, vmin, vmax) -> np.ndarray:
    """matplotlib's ``Normalize(vmin, vmax)`` in float32; 0 where vmin == vmax."""
    x = np.asarray(x, np.float32)
    lo, hi = np.float32(vmin), np.float32(vmax)
    if hi == lo:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def _lut_index(norm: np.ndarray) -> np.ndarray:
    """A 256-entry colormap's index of normalised values, as
    ``matplotlib.colors.Colormap.__call__`` takes it (NaN to entry 0)."""
    xa = np.nan_to_num(norm, nan=0.0) * np.float32(256)
    xa[xa == 256] = 255
    return np.clip(xa.astype(np.int64), 0, 255)


def _gray(x, vmin=0.0, vmax=1.0) -> np.ndarray:
    """(H, W) -> uint8 (H, W, 3) through ``gray`` (entry i is i / 255)."""
    idx = _lut_index(_normalize(x, vmin, vmax)).astype(np.uint8)
    return np.repeat(idx[..., None], 3, axis=-1)


def _magma(x) -> np.ndarray:
    """(H, W) -> uint8 (H, W, 3) through ``magma``, normalised to x's own
    min and max."""
    x = np.asarray(x, np.float32)
    return to_uint8_frames(_MAGMA[_lut_index(_normalize(x, x.min(), x.max()))])


def _rgb(img, vmin=0.0, vmax=1.0) -> np.ndarray:
    """A panel's uint8 (H, W, 3): RGB quantised, one channel through gray."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2 or img.shape[-1] == 1:
        return _gray(img.reshape(img.shape[:2]), vmin, vmax)
    return to_uint8_frames(img[..., :3])


def _text_box(draw, font, text):
    left, top, right, bottom = draw.textbbox((0, 0), text, font=font)
    return left, top, right - left, bottom - top


def _text(draw, font, text, x, y, center=False):
    """``text`` with its ink's top at ``y``, its left (or centre) at ``x``."""
    left, top, w, _ = _text_box(draw, font, text)
    draw.text((x - (w // 2 if center else 0) - left, y - top), text, fill=BLACK, font=font)


def _grid(cells, suptitle: Optional[str] = None, cell_titles: Optional[dict] = None,
          row_labels: Optional[Sequence[str]] = None) -> Figure:
    """Rows of uint8 (h, w, 3) panels (None: an empty cell) on a white canvas,
    each upscaled by one whole factor; ``cell_titles`` {(row, col): text}
    above panels, ``row_labels`` left of each row, ``suptitle`` on top."""
    Image, ImageDraw, ImageFont = _pil()
    font = ImageFont.load_default()
    probe = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    line = _text_box(probe, font, "Ag")[3] + 2 * GAP
    panels = [a for row in cells for a in row if a is not None]
    ph, pw = max(a.shape[0] for a in panels), max(a.shape[1] for a in panels)
    scale = max(1, PANEL_PX // max(ph, pw))
    ph, pw = ph * scale, pw * scale
    cell_titles = cell_titles or {}
    titled_rows = {r for r, _ in cell_titles}
    label_w = (max(_text_box(probe, font, t)[2] for t in row_labels) + 2 * GAP
               if row_labels else 0)
    n_cols = max(len(row) for row in cells)
    x0 = MARGIN + label_w
    ys, y = [], MARGIN + (line if suptitle else 0)
    for r in range(len(cells)):
        y += line if r in titled_rows else 0
        ys.append(y)
        y += ph + GAP
    width = max(x0 + n_cols * (pw + GAP) - GAP + MARGIN,
                _text_box(probe, font, suptitle)[2] + 2 * MARGIN if suptitle else 0)
    image = Image.new("RGB", (width, y - GAP + MARGIN), WHITE)
    draw = ImageDraw.Draw(image)
    boxes = {}
    for r, row in enumerate(cells):
        for c, a in enumerate(row):
            if a is None:
                continue
            left = x0 + c * (pw + GAP)
            up = np.repeat(np.repeat(a, scale, axis=0), scale, axis=1)
            image.paste(Image.fromarray(np.ascontiguousarray(up)), (left, ys[r]))
            boxes[(r, c)] = (left, ys[r], left + up.shape[1], ys[r] + up.shape[0])
    for (r, c), title in cell_titles.items():
        _text(draw, font, title, x0 + c * (pw + GAP) + pw // 2, ys[r] - line + GAP, center=True)
    for r, label in enumerate(row_labels or ()):
        _text(draw, font, label, MARGIN, ys[r] + ph // 2 - line // 2 + GAP)
    if suptitle:
        _text(draw, font, suptitle, width // 2, MARGIN, center=True)
    return Figure(image, boxes, scale)


def visualize_sequence(sequence, savepath=None, n_cols: int = 8, titles=None,
                       suptitle: Optional[str] = None) -> Figure:
    """Grid of frames (T, H, W, C) (reference visualizations.py:18-69)."""
    seq = np.clip(_to_numpy(sequence), 0, 1)
    t = seq.shape[0]
    n_cols = min(n_cols, t)
    n_rows = (t + n_cols - 1) // n_cols
    cells = [[_rgb(seq[r * n_cols + c]) if r * n_cols + c < t else None
              for c in range(n_cols)] for r in range(n_rows)]
    cell_titles = ({(i // n_cols, i % n_cols): str(titles[i]) for i in range(min(t, len(titles)))}
                   if titles is not None else None)
    return _finish(_grid(cells, suptitle=suptitle, cell_titles=cell_titles), savepath)


def visualize_recons(imgs, recons, savepath=None, n_cols: int = 8) -> Figure:
    """GT / reconstruction / error rows (reference visualizations.py:73-105);
    the error, the channel mean of |GT - recons|, through magma."""
    imgs = np.clip(_to_numpy(imgs), 0, 1)
    recons = np.clip(_to_numpy(recons), 0, 1)
    t = min(imgs.shape[0], n_cols)
    cells = [[_rgb(imgs[i]) for i in range(t)], [_rgb(recons[i]) for i in range(t)],
             [_magma(np.abs(imgs[i] - recons[i]).mean(-1)) for i in range(t)]]
    return _finish(_grid(cells, cell_titles={(0, 0): "GT", (1, 0): "Recons", (2, 0): "Error"}),
                   savepath)


def visualize_decomp(objs, savepath=None, vmin: float = 0, vmax: float = 1) -> Figure:
    """Objects (T, S, H, W, C) as an objects-x-time grid
    (reference visualizations.py:109-179); one channel through gray."""
    objs = np.clip(_to_numpy(objs), vmin, vmax)
    t, s = objs.shape[:2]
    cells = [[_rgb(objs[j, i], vmin, vmax) for j in range(t)] for i in range(s)]
    return _finish(_grid(cells), savepath)


def add_border(img: np.ndarray, color, pad: int = 2) -> np.ndarray:
    """Colored border around (..., H, W, C) — leading dims are batched
    (reference visualizations.py:247-274)."""
    img = np.asarray(img)
    *lead, h, w, c = img.shape
    out = np.empty((*lead, h + 2 * pad, w + 2 * pad, c), dtype=img.dtype)
    out[...] = np.asarray(color, dtype=img.dtype)
    out[..., pad : pad + h, pad : pad + w, :] = img
    return out


def visualize_qualitative_eval(context, targets, preds, savepath=None) -> Figure:
    """Seed/target/prediction panel with green seed and red pred borders
    (reference visualizations.py:184-243)."""
    context = np.clip(_to_numpy(context), 0, 1)
    targets = np.clip(_to_numpy(targets), 0, 1)
    preds = np.clip(_to_numpy(preds), 0, 1)
    seed = [_rgb(add_border(x, GREEN)) for x in context]
    cells = [seed + [_rgb(add_border(x, GREEN)) for x in targets],
             seed + [_rgb(add_border(x, RED)) for x in preds]]
    return _finish(_grid(cells, row_labels=("GT", "Pred")), savepath)


def masks_to_rgb(masks: np.ndarray) -> np.ndarray:
    """One-hot argmax masks (S, H, W[, 1]) -> RGB segmentation (H, W, 3)
    (reference visualizations.py:355-428)."""
    if masks.ndim == 4:
        masks = masks[..., 0]
    seg = np.argmax(masks, axis=0)  # (H, W)
    return COLORS[seg % len(COLORS)]


def overlay_segmentations(img: np.ndarray, masks: np.ndarray, alpha: float = 0.6) -> np.ndarray:
    """Overlay the RGB segmentation on the image."""
    seg_rgb = masks_to_rgb(masks)
    if seg_rgb.shape[:2] != img.shape[:2]:
        Image = _pil()[0]
        seg_img = Image.fromarray((seg_rgb * 255).astype(np.uint8))
        seg_img = seg_img.resize((img.shape[1], img.shape[0]), Image.NEAREST)
        seg_rgb = np.asarray(seg_img, dtype=np.float32) / 255.0
    return np.clip((1 - alpha) * img + alpha * seg_rgb, 0, 1)


def make_gif(frames, savepath, n_seed: int = 0, upscale: int = 2, fps: int = 4,
             use_border: bool = True):
    """Save (T, H, W, C) frames as a GIF with 2x upscaling and green
    seed / red prediction borders (reference visualizations.py:314-329);
    ``use_border=False`` for per-object GIFs (reference
    06_generate_figs_predictor.py:243-252). Written by PIL with what
    ``imageio.mimsave(savepath, frames, duration=1000 / fps, loop=0)`` passes
    it: every frame, ``duration`` ms each, looping."""
    Image = _pil()[0]
    frames = np.clip(_to_numpy(frames), 0, 1)
    out = []
    for i, frame in enumerate(frames):
        frame = np.repeat(np.repeat(frame, upscale, axis=0), upscale, axis=1)
        if use_border:
            frame = add_border(frame, GREEN if i < n_seed else RED, pad=2 * upscale)
        out.append(Image.fromarray((frame * 255).astype(np.uint8)))
    Path(savepath).parent.mkdir(parents=True, exist_ok=True)
    extra = {"save_all": True, "append_images": out[1:]} if len(out) > 1 else {}
    out[0].save(savepath, format="GIF", duration=1000 / fps, loop=0, **extra)
    return savepath


def idx_to_one_hot(x: np.ndarray, num_classes: Optional[int] = None) -> np.ndarray:
    """Categorical mask indices (..., H, W) -> one-hot masks with a leading
    class axis per element: (..., S, H, W) (reference visualizations.py:355-368)."""
    x = np.asarray(x)
    s = int(num_classes if num_classes is not None else x.max() + 1)
    eye = np.eye(s, dtype=np.float32)
    onehot = eye[x.reshape(-1)].reshape(x.shape + (s,))
    return np.moveaxis(onehot, -1, -3)  # (..., S, H, W)


def visualize_aligned_slots(recons_objs, savepath=None, vmin: float = 0,
                            vmax: float = 1) -> Figure:
    """Aligned per-slot reconstructions (reference visualizations.py:278-310).

    Accepts (S, H, W, C) — one row of slots — or (T, S, H, W, C) — a
    slots-x-time grid with the slot index labeling each row (the aligned-slots
    figure of 06_generate_figs_predictor.py:181-187).
    """
    objs = np.clip(_to_numpy(recons_objs), vmin, vmax)
    if objs.ndim == 4:  # (S, H, W, C) -> single-timestep grid
        objs = objs[None]
    t, s = objs.shape[:2]
    cells = [[_rgb(objs[j, i], vmin, vmax) for j in range(t)] for i in range(s)]
    return _finish(_grid(cells, row_labels=[f"Slot {i}" for i in range(s)]), savepath)


def process_objs_masks_dinosaur(frames, masks, out_size: int = 96,
                                return_all: bool = False):
    """Crop per-object views for DINOSAUR-style models: upsample the patch-grid
    alpha masks to the frame resolution and mask the frames, resized to
    out_size (reference visualizations.py:432-451).

    frames: (T, H, W, C); masks: (T, S, 1, gh, gw). Returns (T, S, out, out, C),
    or ``(objs, masks_up, frames_tiny)`` with masks_up (T, S, out, out) and
    frames_tiny (T, out, out, C) when ``return_all`` (the reference returns all
    three for the segmentation GIFs, 06_generate_figs_predictor.py:160-171).
    """
    Image = _pil()[0]
    frames = _to_numpy(frames)
    masks = _to_numpy(masks)
    t, s = masks.shape[:2]
    c = frames.shape[-1]
    objs = np.zeros((t, s, out_size, out_size, c), dtype=np.float32)
    masks_up = np.zeros((t, s, out_size, out_size), dtype=np.float32)
    frames_tiny = np.zeros((t, out_size, out_size, c), dtype=np.float32)
    for ti in range(t):
        frame = Image.fromarray((np.clip(frames[ti], 0, 1) * 255).astype(np.uint8))
        frame = np.asarray(frame.resize((out_size, out_size), Image.BILINEAR),
                           dtype=np.float32) / 255.0
        frames_tiny[ti] = frame
        for si in range(s):
            m = Image.fromarray((np.clip(masks[ti, si, 0], 0, 1) * 255).astype(np.uint8))
            m = np.asarray(m.resize((out_size, out_size), Image.BILINEAR),
                           dtype=np.float32) / 255.0
            masks_up[ti, si] = m
            objs[ti, si] = frame * m[..., None]
    if return_all:
        return objs, masks_up, frames_tiny
    return objs


def _ticks(lo: float, hi: float, n: int = 5) -> np.ndarray:
    return np.linspace(lo, hi, n) if hi > lo else np.array([lo])


def visualize_metric(values: Sequence[float], savepath=None, title: str = "",
                     start_x: int = 0, xlabel: str = "Frame") -> Figure:
    """Per-frame metric curve (reference visualizations.py:333-351): the
    values against frames ``start_x``, ``start_x`` + 1, ..., a line with a
    marker at each finite value, light grid lines at the ticks, the title
    above and ``xlabel`` below. The plot area is panel (0, 0); the markers'
    centres are ``points``."""
    Image, ImageDraw, ImageFont = _pil()
    font = ImageFont.load_default()
    w, h = METRIC_SIZE
    image = Image.new("RGB", (w, h), WHITE)
    draw = ImageDraw.Draw(image)
    box = (72, 32, w - 20, h - 48)  # left, top, right, bottom of the plot area
    vals = np.asarray(list(values), dtype=np.float64)
    xs = start_x + np.arange(len(vals))
    ok = np.isfinite(vals)
    x_lo, x_hi = (float(xs[0]), float(xs[-1])) if len(xs) else (0.0, 1.0)
    x_pad = 0.05 * (x_hi - x_lo) if x_hi > x_lo else 0.5
    y_lo, y_hi = (float(vals[ok].min()), float(vals[ok].max())) if ok.any() else (0.0, 1.0)
    y_pad = 0.05 * (y_hi - y_lo) if y_hi > y_lo else max(0.5, 0.05 * abs(y_lo))

    def px(x, y):
        fx = (x - x_lo + x_pad) / (x_hi - x_lo + 2 * x_pad)
        fy = (y - y_lo + y_pad) / (y_hi - y_lo + 2 * y_pad)
        return (round(box[0] + fx * (box[2] - box[0])), round(box[3] - fy * (box[3] - box[1])))

    step = max(1, -(-len(xs) // 10))
    for x in xs[::step]:
        gx = px(x, y_lo)[0]
        draw.line([(gx, box[1]), (gx, box[3])], fill=GRID_RGB)
        _text(draw, font, str(int(x)), gx, box[3] + 6, center=True)
    for y in _ticks(y_lo, y_hi):
        gy = px(x_lo, y)[1]
        draw.line([(box[0], gy), (box[2], gy)], fill=GRID_RGB)
        label = f"{y:.4g}"
        _text(draw, font, label, box[0] - 6 - _text_box(draw, font, label)[2], gy - 5)
    draw.rectangle(box, outline=BLACK)
    points, runs = [], [[]]  # the markers; the line's runs between non-finite values
    for x, y, good in zip(xs, vals, ok):
        if good:
            points.append(px(x, y))
            runs[-1].append(points[-1])
        elif runs[-1]:
            runs.append([])
    for run in runs:
        if len(run) > 1:
            draw.line(run, fill=LINE_RGB, width=2)
    for x, y in points:
        draw.ellipse((x - 4, y - 4, x + 4, y + 4), fill=LINE_RGB)
    if title:
        _text(draw, font, title, (box[0] + box[2]) // 2, 10, center=True)
    _text(draw, font, xlabel, (box[0] + box[2]) // 2, box[3] + 24, center=True)
    return _finish(Figure(image, {(0, 0): box}, 1, points), savepath)
