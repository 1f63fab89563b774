"""The port's figures (``textocvp_tpu_torch/viz``, drawn with PIL) against the
JAX package's (matplotlib and imageio), on the CPU.

The array helpers give the JAX package's arrays bit for bit. Each
``visualize_*`` figure is written to a PNG and read back: every panel, taken
at every ``scale``-th pixel of its box, equals the image the JAX figure's
axes at the same row and column show (``AxesImage`` data through its own
norm and colormap, quantised as ``data/wire.py::to_uint8_frames`` does), and
the two grids hold the same panels. ``make_gif`` writes what ``imageio.mimsave``
writes: the same frames, size, duration and loop. The magma table equals
matplotlib's. The port's figures import without matplotlib and imageio, and
without PIL they raise naming it.
"""

import ast
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import matplotlib.cm as cm  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from textocvp_tpu.viz import figures as jax_viz  # noqa: E402
from textocvp_tpu_torch.data.wire import to_uint8_frames  # noqa: E402
from textocvp_tpu_torch.viz import figures as viz  # noqa: E402
from textocvp_tpu_torch.viz.magma import MAGMA  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _rng(seed=0):
    return np.random.default_rng(seed)


def jax_panels(fig) -> dict:
    """{(row, col): uint8 (H, W, 3)} of the images the JAX figure's axes show."""
    out = {}
    for ax in fig.axes:
        if not ax.get_images():
            continue
        im = ax.get_images()[0]
        ss = ax.get_subplotspec()
        data = np.asarray(im.get_array())
        rgb = im.to_rgba(data)[..., :3] if data.ndim == 2 else data[..., :3]
        out[(ss.rowspan.start, ss.colspan.start)] = to_uint8_frames(np.asarray(rgb, np.float64))
    plt.close(fig)
    return out


def port_panels(fig, path) -> dict:
    """{(row, col): uint8 (H, W, 3)} of the port's figure, read back from its PNG."""
    fig.save(path)
    with Image.open(path) as img:
        assert img.size == fig.image.size
        return {rc: viz.panel_pixels(img, box, fig.scale) for rc, box in fig.panels.items()}


def check_same_panels(fig, jax_fig, path):
    ours, ref = port_panels(fig, path), jax_panels(jax_fig)
    assert set(ours) == set(ref)
    for rc in ref:
        np.testing.assert_array_equal(ours[rc], ref[rc], err_msg=str(rc))


# ------------------------------------------------------------------ the array helpers

def test_constants_are_the_jax_packages():
    np.testing.assert_array_equal(viz.COLORS, jax_viz.COLORS)
    assert viz.COLORS.dtype == jax_viz.COLORS.dtype
    np.testing.assert_array_equal(viz.GREEN, jax_viz.GREEN)
    np.testing.assert_array_equal(viz.RED, jax_viz.RED)


def test_the_magma_copy_is_matplotlibs_table():
    assert len(MAGMA) == cm.magma.N == 256
    np.testing.assert_array_equal(np.array(MAGMA), np.array(cm.magma.colors))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_add_border(dtype):
    img = (_rng(1).random((2, 3, 5, 6, 3)) * 200).astype(dtype)
    for color, pad in ((viz.GREEN, 2), (viz.RED, 4), ((1, 2, 3), 1)):
        out, ref = viz.add_border(img, color, pad=pad), jax_viz.add_border(img, color, pad=pad)
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("trailing", [True, False])
def test_masks_to_rgb(trailing):
    masks = _rng(2).random((40, 5, 7) + ((1,) if trailing else ())).astype(np.float32)
    out, ref = viz.masks_to_rgb(masks), jax_viz.masks_to_rgb(masks)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("size", [(12, 12), (9, 15)])
def test_overlay_segmentations(size):
    rng = _rng(3)
    img = rng.random((*size, 3)).astype(np.float32)
    for masks in (rng.random((4, *size, 1)).astype(np.float32),      # same size
                  rng.random((4, 5, 6)).astype(np.float32)):         # NEAREST resize
        for alpha in (0.6, 0.25):
            out = viz.overlay_segmentations(img, masks, alpha=alpha)
            np.testing.assert_array_equal(out, jax_viz.overlay_segmentations(img, masks, alpha))


def test_idx_to_one_hot():
    x = _rng(4).integers(0, 5, (3, 6, 7))
    for n in (None, 5, 8):
        out, ref = viz.idx_to_one_hot(x, n), jax_viz.idx_to_one_hot(x, n)
        assert out.dtype == ref.dtype and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("out_size", [96, 20])
def test_process_objs_masks_dinosaur(out_size):
    rng = _rng(5)
    frames = rng.random((3, 42, 42, 3)).astype(np.float32) * 1.1 - 0.05
    masks = rng.random((3, 4, 1, 3, 3)).astype(np.float32)
    objs = viz.process_objs_masks_dinosaur(frames, masks, out_size=out_size)
    np.testing.assert_array_equal(
        objs, jax_viz.process_objs_masks_dinosaur(frames, masks, out_size=out_size))
    for a, b in zip(viz.process_objs_masks_dinosaur(frames, masks, out_size, return_all=True),
                    jax_viz.process_objs_masks_dinosaur(frames, masks, out_size,
                                                        return_all=True)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ the figures

@pytest.mark.parametrize("t, n_cols", [(3, 8), (10, 4), (8, 8)])
def test_visualize_sequence(tmp_path, t, n_cols):
    seq = _rng(6).random((t, 14, 10, 3)).astype(np.float32) * 1.2 - 0.1
    titles = [f"t={i}" for i in range(t)]
    fig = viz.visualize_sequence(seq, n_cols=n_cols, titles=titles, suptitle="seq")
    jax_fig = jax_viz.visualize_sequence(seq, n_cols=n_cols, titles=titles, suptitle="seq")
    check_same_panels(fig, jax_fig, tmp_path / "seq.png")
    assert fig.scale == 128 // 14


@pytest.mark.parametrize("t", [3, 11])
def test_visualize_recons_with_its_magma_error_row(tmp_path, t):
    rng = _rng(7)
    imgs = rng.random((t, 16, 16, 3)).astype(np.float32)
    recons = np.clip(imgs + 0.2 * rng.standard_normal(imgs.shape).astype(np.float32), -0.1, 1.1)
    recons[0] = imgs[0]  # an error panel of zeros: vmin == vmax
    fig = viz.visualize_recons(imgs, recons)
    check_same_panels(fig, jax_viz.visualize_recons(imgs, recons), tmp_path / "recons.png")
    assert sorted(fig.panels) == [(r, c) for r in range(3) for c in range(min(t, 8))]


@pytest.mark.parametrize("channels, vmin, vmax", [(3, 0, 1), (1, 0, 1), (1, 0.2, 0.7)])
def test_visualize_decomp(tmp_path, channels, vmin, vmax):
    objs = _rng(8).random((4, 3, 12, 12, channels)).astype(np.float32)
    fig = viz.visualize_decomp(objs, vmin=vmin, vmax=vmax)
    jax_fig = jax_viz.visualize_decomp(objs, vmin=vmin, vmax=vmax)
    check_same_panels(fig, jax_fig, tmp_path / "decomp.png")
    assert sorted(fig.panels) == [(r, c) for r in range(3) for c in range(4)]


def test_visualize_qualitative_eval(tmp_path):
    rng = _rng(9)
    ctx, tgt, pred = (rng.random((n, 16, 16, 3)).astype(np.float32) for n in (2, 3, 3))
    fig = viz.visualize_qualitative_eval(ctx, tgt, pred)
    check_same_panels(fig, jax_viz.visualize_qualitative_eval(ctx, tgt, pred),
                      tmp_path / "qual.png")
    assert sorted(fig.panels) == [(r, c) for r in range(2) for c in range(5)]
    # the border colours: green around the seed and the targets, red around predictions
    with Image.open(tmp_path / "qual.png") as img:
        png = np.asarray(img.convert("RGB"))
    assert tuple(png[fig.panels[(1, 0)][1], fig.panels[(1, 0)][0]]) == (0, 204, 0)
    assert tuple(png[fig.panels[(1, 4)][1], fig.panels[(1, 4)][0]]) == (204, 0, 0)


@pytest.mark.parametrize("shape", [(5, 3, 12, 12, 3), (3, 12, 12, 3)])
def test_visualize_aligned_slots(tmp_path, shape):
    objs = _rng(10).random(shape).astype(np.float32)
    fig = viz.visualize_aligned_slots(objs)
    check_same_panels(fig, jax_viz.visualize_aligned_slots(objs), tmp_path / "aligned.png")


@pytest.mark.parametrize("values, start_x", [([20.5, 21.25, 19.0, 22.0], 0),
                                             ([0.31, float("nan"), 0.29], 1),
                                             ([3.0], 4), ([1.0, 1.0, 1.0], 0)])
def test_visualize_metric(tmp_path, values, start_x):
    fig = viz.visualize_metric(values, savepath=tmp_path / "m.png", title="psnr",
                               start_x=start_x)
    jax_fig = jax_viz.visualize_metric(values, title="psnr", start_x=start_x)
    xy = jax_fig.axes[0].lines[0].get_xydata()
    plt.close(jax_fig)
    finite = np.isfinite(xy[:, 1])
    np.testing.assert_array_equal(xy[:, 0], np.arange(start_x, start_x + len(values)))
    assert len(fig.points) == finite.sum()
    with Image.open(tmp_path / "m.png") as img:
        assert img.size == viz.METRIC_SIZE
        png = np.asarray(img.convert("RGB"))
    left, top, right, bottom = fig.panels[(0, 0)]
    xs = [x for x, _ in fig.points]
    assert xs == sorted(xs) and all(left < x < right for x in xs)
    ys = [y for _, y in fig.points]
    assert all(top < y < bottom for y in ys)
    order = np.argsort(xy[finite, 1])  # higher values higher up the canvas
    assert [ys[i] for i in order] == sorted(ys, reverse=True) or len(set(ys)) == 1
    for x, y in fig.points:
        assert tuple(png[y, x]) == viz.LINE_RGB


def test_figures_take_tensors(tmp_path):
    seq = torch.rand((3, 8, 8, 3), generator=torch.Generator().manual_seed(0))
    a = port_panels(viz.visualize_sequence(seq), tmp_path / "t.png")
    b = port_panels(viz.visualize_sequence(seq.numpy()), tmp_path / "n.png")
    for rc in a:
        np.testing.assert_array_equal(a[rc], b[rc])


# ------------------------------------------------------------------ GIFs

def _read_gif(path):
    with Image.open(path) as img:
        info = {"n_frames": img.n_frames, "size": img.size, "loop": img.info.get("loop")}
        frames, durations = [], []
        for i in range(img.n_frames):
            img.seek(i)
            durations.append(img.info.get("duration"))
            frames.append(np.asarray(img.convert("RGB")))
    return info, durations, np.stack(frames)


@pytest.mark.parametrize("n, kwargs", [(5, {"n_seed": 2}), (1, {}),
                                       (4, {"use_border": False, "upscale": 3, "fps": 8}),
                                       (3, {"n_seed": 3})])
def test_make_gif_writes_what_imageio_writes(tmp_path, n, kwargs):
    frames = _rng(11).random((n, 10, 12, 3)).astype(np.float32) * 1.2 - 0.1
    ours = viz.make_gif(frames, tmp_path / "port" / "a.gif", **kwargs)
    ref = jax_viz.make_gif(frames, tmp_path / "jax" / "a.gif", **kwargs)
    (info, durations, decoded), (ref_info, ref_durations, ref_decoded) = (
        _read_gif(ours), _read_gif(ref))
    assert info == ref_info and info["n_frames"] == n and info["loop"] == 0
    # 1000 / fps ms a frame, stored in whole centiseconds
    assert durations == ref_durations == [10 * int(1000 / kwargs.get("fps", 4) / 10)] * n
    np.testing.assert_array_equal(decoded, ref_decoded)


# ------------------------------------------------------------------ what the card's machine lacks

_BLOCK = """
import sys
BLOCKED = {blocked!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
"""


def _run_blocked(blocked, body, tmp_path):
    code = _BLOCK.format(blocked=blocked) + body
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_figures_draw_without_matplotlib_and_imageio(tmp_path):
    body = f"""
import numpy as np
import textocvp_tpu_torch.viz as viz
from textocvp_tpu_torch.train import evaluator, fig_generation
from textocvp_tpu_torch.cli import generate_figs_decomp, generate_figs_predictor
x = np.random.default_rng(0).random((3, 8, 8, 3)).astype(np.float32)
viz.visualize_recons(x, x[::-1], savepath={str(tmp_path / 'r.png')!r})
viz.visualize_metric([1.0, 2.0], savepath={str(tmp_path / 'm.png')!r}, title="psnr")
viz.make_gif(x, {str(tmp_path / 'g.gif')!r}, n_seed=1)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""
    res = _run_blocked(("matplotlib", "imageio", "jax", "textocvp_tpu"), body, tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip() == "ok"
    assert {p.name for p in tmp_path.iterdir()} >= {"r.png", "m.png", "g.gif"}


def test_without_pil_the_figures_raise_naming_it(tmp_path):
    body = """
import numpy as np
import textocvp_tpu_torch.viz as viz
x = np.zeros((2, 4, 4, 3), np.float32)
for draw in (lambda: viz.visualize_sequence(x), lambda: viz.make_gif(x, "a.gif"),
             lambda: viz.visualize_metric([1.0]),
             lambda: viz.process_objs_masks_dinosaur(x, np.zeros((2, 1, 1, 2, 2)))):
    try:
        draw()
    except ImportError as e:
        assert "PIL" in str(e), e
    else:
        raise AssertionError("drew without PIL")
print("ok")
"""
    res = _run_blocked(("PIL",), body, tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("rel", ["textocvp_tpu_torch/viz/figures.py",
                                 "textocvp_tpu_torch/viz/magma.py",
                                 "textocvp_tpu_torch/train/fig_generation.py",
                                 "textocvp_tpu_torch/train/evaluator.py",
                                 "textocvp_tpu_torch/cli/generate_figs_decomp.py",
                                 "textocvp_tpu_torch/cli/generate_figs_predictor.py"])
def test_figure_modules_import_no_matplotlib_or_imageio(rel):
    tree = ast.parse((ROOT / rel).read_text())
    roots = {alias.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
             for alias in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module and node.level == 0}
    assert not roots & {"matplotlib", "imageio"}, rel
