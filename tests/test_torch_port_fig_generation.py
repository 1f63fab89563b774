"""The port's 06 figure generators on the CPU against the JAX package's:
06a (``DecompFigGenerator``) on a tiny SAVi over a CATER ``.npy`` set, and
the two CLIs with ``--device cpu`` (06a on ExtendedDINOSAUR:
``test_torch_port_fig_generation_dinosaur.py``; 06b on TextOCVP_T5:
``test_torch_port_fig_generation_predictor.py``).

Both packages' figure writers (``visualize_*`` and ``make_gif`` of each
``viz/figures.py``) are wrapped to record what they are handed and still
write. Every recorded array agrees within 1e-5 of its largest value, or of
1 where that is smaller (float32 through the tiny models on both sides, sums
in other orders; the unclipped per-slot renders behind ``aligned_slots.png``
and ``gt_obj_<k>.gif`` reach 27 on these random weights), the other arguments
are equal,
and both packages write the same file tree, the names' PSNR and LPIPS
within their printed precision (0.01 dB, 0.001). The models use the
``Learned`` initializer.
"""

import os
import re
import shutil
import warnings
from pathlib import Path

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402
from test_torch_port_decomp_eval import write_experiment  # noqa: E402
from test_torch_port_evaluator import D, S, _perturb, _tiny_params, write_cater_npy  # noqa: E402

from textocvp_tpu.models import setup_predictor as jax_setup_predictor  # noqa: E402
from textocvp_tpu.train import fig_generation as jax_fig_generation  # noqa: E402
from textocvp_tpu.train.checkpoints import save_checkpoint  # noqa: E402
from textocvp_tpu.viz import figures as jax_figures  # noqa: E402
from textocvp_tpu_torch.cli import generate_figs_decomp, generate_figs_predictor  # noqa: E402
from textocvp_tpu_torch.convert import from_jax_params  # noqa: E402
from textocvp_tpu_torch.core.experiment import Experiment  # noqa: E402
from textocvp_tpu_torch.train.fig_generation import DecompFigGenerator  # noqa: E402
from textocvp_tpu_torch.viz import figures as port_figures  # noqa: E402

ATOL = 1e-5
NUM_SEQS = 2
WRITERS = ("visualize_recons", "visualize_decomp", "visualize_sequence",
           "visualize_qualitative_eval", "visualize_aligned_slots", "make_gif")
SEQ_DIR = re.compile(r"sequence_(\d+)(?:_psnr=(-?[\d.]+|nan|inf)_lpips=(-?[\d.]+|nan))?$")


def record(monkeypatch, figures) -> dict:
    """Wrap ``figures``' writers: {(sequence directory, file): (writer,
    arrays, other arguments)}, each writer still writing."""
    calls = {}
    for name in WRITERS:
        def rec(*args, _name=name, _orig=getattr(figures, name), **kwargs):
            path = Path(kwargs["savepath"] if "savepath" in kwargs else args[1])
            arrays = [np.asarray(a, np.float32) for a in args if not isinstance(a, (str, Path))]
            other = {k: v for k, v in kwargs.items() if k != "savepath"}
            calls[(path.parent.name, path.name)] = (_name, arrays, other)
            return _orig(*args, **kwargs)
        monkeypatch.setattr(figures, name, rec)
    return calls


def split_seq_dir(name):
    m = SEQ_DIR.match(name)
    assert m, name
    return int(m.group(1)), (float(m.group(2)), float(m.group(3))) if m.group(2) else None


def tree(root: Path) -> dict:
    """{(sequence index, file): (psnr, lpips) of the name or None} under root."""
    out = {}
    for p in root.rglob("*"):
        if p.is_file():
            i, vals = split_seq_dir(p.parent.name)
            out[(i, p.name)] = vals
    return out


def check_same(jax_calls, jax_root, port_calls, port_root):
    """The same files with the same names (numbers within their printed
    precision), the same writers and arguments, the arrays within ATOL of
    their largest value (at least 1); every
    written PNG and GIF decodes."""
    ours, ref = tree(port_root), tree(jax_root)
    assert set(ours) == set(ref) and ours
    for key, vals in ref.items():
        if vals is not None:
            assert abs(ours[key][0] - vals[0]) <= 0.01 + 1e-9, (key, ours[key], vals)
            assert abs(ours[key][1] - vals[1]) <= 0.001 + 1e-9, (key, ours[key], vals)
    norm = lambda calls: {(split_seq_dir(d)[0], f): v for (d, f), v in calls.items()}  # noqa: E731
    port_calls, jax_calls = norm(port_calls), norm(jax_calls)
    assert set(port_calls) == set(jax_calls) == {k for k in ours if k[1] != "prompt.txt"}
    for key, (name, arrays, other) in jax_calls.items():
        p_name, p_arrays, p_other = port_calls[key]
        assert (p_name, p_other) == (name, other), key
        assert [a.shape for a in p_arrays] == [a.shape for a in arrays], key
        for a, b in zip(p_arrays, arrays):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL * max(1.0, np.abs(b).max()),
                                       err_msg=str(key))
    for p in port_root.rglob("*"):
        if p.suffix in (".png", ".gif"):
            with Image.open(p) as img:
                img.load()


def move_plots(exp_path: Path, dest: Path) -> Path:
    """Move an experiment's ``plots/`` aside (both packages write there)."""
    shutil.move(str(exp_path / "plots"), str(dest))
    return dest


def write_savi_experiment(root: Path) -> Path:
    """Both packages' checkpoints ``ckpt`` of a tiny SAVi and TextOCVP_T5
    (``predictors/tiny_t5``) over five CATER videos of 6 frames (06a
    decomposes 5)."""
    params, pred_params = _tiny_params(write_cater_npy(root / "CATER"))
    params["training"]["batch_size"] = 1
    exp_path = write_experiment(root / "exp", params, "savi", params["dataset"]["img_size"][0],
                                61)
    pred = Experiment(exp_path / "predictors" / "tiny_t5")
    pred.save_params(pred_params)
    pvars = jax_setup_predictor(pred_params).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 1, S, D)),
        caption_tokens=jnp.ones((1, 5), jnp.int32), attn_masks=jnp.ones((1, 5), jnp.int32))
    pparams = _perturb(jax.device_get(pvars["params"]), np.random.default_rng(62))
    save_checkpoint(pred.models_dir, "ckpt", {"params": pparams})
    torch.save(from_jax_params("predictor", pparams), pred.checkpoint_path("ckpt"))
    return exp_path


@pytest.fixture(scope="module")
def savi_exp(tmp_path_factory):
    return write_savi_experiment(tmp_path_factory.mktemp("figs_savi"))


def jax_06a(exp_path, monkeypatch, dest):
    calls = record(monkeypatch, jax_figures)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gen = jax_fig_generation.DecompFigGenerator(exp_path, "ckpt", num_seqs=NUM_SEQS)
        gen.load_data()
        gen.load_model(next(iter(gen.test_loader))[0])
        out_dir = gen.generate_figs()
    assert out_dir == exp_path / "plots" / "figs_ckpt"
    monkeypatch.undo()
    return calls, move_plots(exp_path, dest) / "figs_ckpt"


def check_06a(exp_path, monkeypatch, tmp_path):
    """06a on ``exp_path`` against the JAX generator; its plots removed after."""
    jax_calls, jax_root = jax_06a(exp_path, monkeypatch, tmp_path / "jax_plots")
    calls = record(monkeypatch, port_figures)
    gen = DecompFigGenerator(exp_path, "ckpt", num_seqs=NUM_SEQS, device="cpu")
    assert gen.batch_size == 1 and gen.metric_tracker.metrics == ("psnr",)
    gen.load_data()
    gen.load_model()
    out_dir = gen.generate_figs()
    assert out_dir == exp_path / "plots" / "figs_ckpt"
    names = {"recons.png", "recons.gif", "objects.png", "masks.png", "segmentation.png"}
    assert {f for _, f in tree(out_dir)} == names
    check_same(jax_calls, jax_root, calls, out_dir)
    shutil.rmtree(exp_path / "plots")



def test_06a_matches_the_jax_generator_on_savi(savi_exp, monkeypatch, tmp_path):
    check_06a(savi_exp, monkeypatch, tmp_path)


def split_name(root: Path, i: int) -> str:
    (name,) = [p.name for p in root.iterdir() if p.name.startswith(f"sequence_{i:02d}")]
    return name


def test_the_06_clis_on_the_cpu(savi_exp, capsys):
    gen = generate_figs_decomp.main(["-d", str(savi_exp), "--decomp_ckpt", "ckpt",
                                     "--num_seqs", "1", "--device", "cpu"])
    assert gen.device.type == "cpu" and gen.num_seqs == 1
    assert set(tree(gen.out_dir)) == {(0, f) for f in ("recons.png", "recons.gif", "objects.png",
                                                       "masks.png", "segmentation.png")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pgen = generate_figs_predictor.main(
            ["-d", str(savi_exp), "--name_pred_exp", "tiny_t5", "--decomp_ckpt", "ckpt",
             "--pred_ckpt", "ckpt", "--num_seed", "1", "--num_preds", "2", "--num_seqs", "2",
             "--device", "cpu"])
    assert pgen.out_dir.name == "figs_pred_ckpt_NumPreds=2"
    assert "Saved prediction figures for sequence 1" in capsys.readouterr().out
    seqs = sorted(p.name for p in pgen.out_dir.iterdir())
    assert len(seqs) == len(pgen.sequence_metrics) == 2
    for name, m in zip(seqs, pgen.sequence_metrics):
        assert split_seq_dir(name)[1] == (round(m["psnr"], 2), round(m["lpips"], 3))
    shutil.rmtree(savi_exp / "plots")
    shutil.rmtree(savi_exp / "predictors" / "tiny_t5" / "plots")


def test_the_06_clis_default_to_the_card(savi_exp):
    args = generate_figs_predictor.generate_figs_predictor_args(
        ["-d", str(savi_exp), "--name_pred_exp", "p", "--decomp_ckpt", "c", "--pred_ckpt", "c"])
    assert args.device == "cuda" and args.num_seqs == 10 and args.num_seed is None
    args = generate_figs_decomp.generate_figs_decomp_args(["-d", "x", "--decomp_ckpt", "c"])
    assert args.device == "cuda" and args.num_seqs == 10
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_figs_decomp.main(["-d", str(savi_exp), "--decomp_ckpt", "ckpt"])
