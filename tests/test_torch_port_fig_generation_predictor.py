"""The port's 06b figure generator (``PredictorFigGenerator``) on a tiny
TextOCVP_T5 through a tiny SAVi, against the JAX package's, on the CPU: the
same writers' arrays, arguments and file tree as
``test_torch_port_fig_generation.py`` holds for 06a, the JAX checkpoint's
initial slots handed to the port, and ``prompt.txt`` the sequence's
caption."""

import os
import shutil
import warnings

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402
from test_torch_port_evaluator import S  # noqa: E402
from test_torch_port_fig_generation import (  # noqa: E402
    NUM_SEQS,
    check_same,
    move_plots,
    record,
    split_name,
    tree,
    write_savi_experiment,
)

from textocvp_tpu.train import fig_generation as jax_fig_generation  # noqa: E402
from textocvp_tpu.train.checkpoints import checkpoint_path, load_checkpoint  # noqa: E402
from textocvp_tpu.viz import figures as jax_figures  # noqa: E402
from textocvp_tpu_torch.train.fig_generation import PredictorFigGenerator  # noqa: E402
from textocvp_tpu_torch.viz import figures as port_figures  # noqa: E402

NUM_PREDS = 3


@pytest.fixture(scope="module")
def savi_exp(tmp_path_factory):
    return write_savi_experiment(tmp_path_factory.mktemp("figs_pred"))


def jax_init_slots(exp_path) -> torch.Tensor:
    """The JAX checkpoint's Learned initial slots, (1, S, D)."""
    slots = load_checkpoint(checkpoint_path(exp_path / "models", "ckpt"))["params"][
        "slot_initializer"]["slots"]
    return torch.from_numpy(np.array(slots, np.float32))[None]


def test_06b_matches_the_jax_generator(savi_exp, monkeypatch, tmp_path):
    pred_path = savi_exp / "predictors" / "tiny_t5"
    jax_calls = record(monkeypatch, jax_figures)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_fig_generation.PredictorFigGenerator(
            savi_exp, "tiny_t5", "ckpt", "ckpt", num_seed=1, num_preds=NUM_PREDS,
            num_seqs=NUM_SEQS)
        ref.load_data()
        videos, others = next(iter(ref.test_loader))
        ref.load_models(videos, others)
        ref_dir = ref.generate_figs()
    monkeypatch.undo()
    name = f"figs_pred_ckpt_NumPreds={NUM_PREDS}"
    assert ref_dir == pred_path / "plots" / name
    jax_root = move_plots(pred_path, tmp_path / "jax_plots") / name

    calls = record(monkeypatch, port_figures)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # LPIPS's random AlexNet
        gen = PredictorFigGenerator(savi_exp, "tiny_t5", "ckpt", "ckpt", num_seed=1,
                                    num_preds=NUM_PREDS, num_seqs=NUM_SEQS, device="cpu")
    assert gen.batch_size == 1 and gen.metric_tracker.metrics == ("psnr", "lpips")
    assert gen.out_dir == pred_path / "plots" / name
    gen.load_data()
    gen.load_models()
    init = jax_init_slots(savi_exp)
    for i, (videos, info) in zip(range(NUM_SEQS), gen.test_loader):
        seq_dir, metrics = gen.sequence_figs(i, videos, info, initial_slots=init)
        assert seq_dir.name == (f"sequence_{i:02d}_psnr={metrics['psnr']:.2f}"
                                f"_lpips={metrics['lpips']:.3f}")
        assert (seq_dir / "prompt.txt").read_text() == info["caption"][0] + "\n"
        assert (seq_dir / "prompt.txt").read_text() == (
            jax_root / split_name(jax_root, i) / "prompt.txt").read_text()
    files = {f for _, f in tree(gen.out_dir)}
    assert files == {"qual_eval_rgb.png", "aligned_slots.png", "masks_GIF_masks.gif",
                     "overlay_GIF.gif", "gt_GIF_frames.gif", "pred_GIF_frames.gif",
                     "prompt.txt"} | {f"gt_obj_{k + 1}.gif" for k in range(S)}
    check_same(jax_calls, jax_root, calls, gen.out_dir)
    with Image.open(gen.out_dir / split_name(gen.out_dir, 0) / "pred_GIF_frames.gif") as gif:
        assert gif.n_frames == 1 + NUM_PREDS
    shutil.rmtree(pred_path / "plots")
