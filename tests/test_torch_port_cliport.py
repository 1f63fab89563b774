"""The CLIPort slice of the PyTorch port on the CPU: the port's ``CLIPort``
reader and its loader against the JAX package's on a tiny color-cache set,
and the port's 05 ``PredictorEvaluator`` on a tiny ExtendedDINOSAUR +
TextOCVP_T5 experiment against the JAX ``PredictorEvaluator``, through to
``results.json``.

* The set: three episodes a split (numbers that sort otherwise as text), one
  of the excluded episodes, 12 frames of 42 x 42 in
  ``color_cache_42x42.npy``; pixel (0, 0, 0) of each frame holds its index,
  so a clip's start shows in its items.
* The experiment directory holds both packages' checkpoints of the same
  weights (the JAX init plus noise; the CNN head's BatchNorm statistics
  moved off 0 and 1), the port's carried by ``from_jax_params("dinosaur",
  ..., batch_stats=...)``. The model uses the ``Learned`` initializer, so no
  random draw differs. Both sides tokenize with the hash fallback. Three
  test episodes in batches of 2 leave a ragged last batch. Framewise PSNR,
  SSIM and LPIPS agree within 1e-5: float32 on both sides through the ViT,
  slot attention, a 3-step rollout and the decode, sums in other orders.
  ``results.json`` holds them rounded to five decimals on both sides, so
  the limit is one unit of the fifth decimal (1e-5, with 1e-12 for the
  float64 difference of two such numbers).
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import json
import os
import warnings

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params  # noqa: E402
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params  # noqa: E402
from textocvp_tpu.data.datasets import CLIPort as JaxCLIPort  # noqa: E402
from textocvp_tpu.data.datasets import _size_token as jax_size_token  # noqa: E402
from textocvp_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from textocvp_tpu.data.loader import load_data as jax_load_data  # noqa: E402
from textocvp_tpu.models import setup_model as jax_setup_model  # noqa: E402
from textocvp_tpu.models import setup_predictor as jax_setup_predictor  # noqa: E402
from textocvp_tpu.train.checkpoints import save_checkpoint  # noqa: E402
from textocvp_tpu.train.evaluator import PredictorEvaluator as JaxPredictorEvaluator  # noqa: E402
from textocvp_tpu_torch.convert import from_jax_params  # noqa: E402
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params  # noqa: E402
from textocvp_tpu_torch.core.experiment import Experiment  # noqa: E402
from textocvp_tpu_torch.data import datasets  # noqa: E402
from textocvp_tpu_torch.data.datasets import CLIPort  # noqa: E402
from textocvp_tpu_torch.data.loader import EpochLoader, load_data  # noqa: E402
from textocvp_tpu_torch.data.vocabularies import CLIPORT_VOCAB, CLIPORT_VOCAB_TEST  # noqa: E402
from textocvp_tpu_torch.train.evaluator import PredictorEvaluator  # noqa: E402

IMG, S, D, NUM_PREDS, BATCH, FRAMES = 42, 3, 16, 3, 2, 12
EPISODES = {"train": (10, 9, 100), "val": (21, 3, 4), "test": (5, 40, 6)}
# each split's colours in its own vocabulary only (the test split's are unseen in training)
SEEN = ["put the red block in the yellow bowl", "put the cyan block in the brown bowl",
        "put the gray block in the green bowl"]
UNSEEN = ["put the pink block in the white bowl", "put the orange block in the purple bowl",
          "put the white block in the blue bowl"]
TASKS = {"train": SEEN, "val": SEEN, "test": UNSEEN}
TOL = 1e-5


def write_cliport(root, episodes=EPISODES, frames=FRAMES, img=IMG, seed=14):
    """<root>/<split>/episode<N>/color_cache_<img>x<img>.npy (uint8, frames x
    img x img x 3, pixel (0, 0, 0) the frame's index) and
    task_description.txt (with surrounding white space, the split's
    ``TASKS``); episode07564, one of the excluded, in every split."""
    rng = np.random.default_rng(seed)
    token = f"{img}x{img}"
    for split, numbers in episodes.items():
        for j, n in enumerate((*numbers, 7564)):
            ep = root / split / (f"episode{n:05d}" if n == 7564 else f"episode{n}")
            ep.mkdir(parents=True)
            video = rng.integers(0, 256, (frames, img, img, 3), dtype=np.uint8)
            video[:, 0, 0, 0] = np.arange(frames)
            np.save(ep / f"color_cache_{token}.npy", video)
            (ep / "task_description.txt").write_text(f"  {TASKS[split][j % 3]}\n")
    return root


@pytest.fixture(scope="module")
def cliport_root(tmp_path_factory):
    return write_cliport(tmp_path_factory.mktemp("cliport"))


def test_size_token_matches_jax():
    for size in (336, [336, 336], (42, 56), [24]):
        assert datasets._size_token(size) == jax_size_token(size)
    assert datasets._size_token([336, 336]) == "336x336"


@pytest.mark.parametrize("split", ["train", "val", "valid", "test", "eval"])
def test_items_labels_and_order_match_jax(cliport_root, split):
    kw = dict(root=str(cliport_root), split=split, num_frames=10, img_size=[IMG, IMG],
              random_start=True)
    for uint8 in (False, True):
        ours, ref = CLIPort(**kw, uint8_output=uint8), JaxCLIPort(**kw, uint8_output=uint8)
        assert ours.split == ref.split == {"valid": "val", "eval": "test"}.get(split, split)
        assert ours.episodes == ref.episodes and "episode07564" not in ours.episodes
        numbers = EPISODES[ours.split]
        assert [int(e[len("episode"):]) for e in ours.episodes] == sorted(numbers)
        assert ours.labels == ref.labels == [
            TASKS[ours.split][numbers.index(n)] for n in sorted(numbers)]
        assert ours.random_start == ref.random_start == (ours.split == "train")
        assert ours.vocabulary == ref.vocabulary == (
            CLIPORT_VOCAB_TEST if ours.split == "test" else CLIPORT_VOCAB)
        starts = set()
        for epoch in range(2):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            for i in range(len(ref)):
                (fo, lo), (fr, lr) = ours[i], ref[i]
                assert lo == lr and fo.dtype == fr.dtype == (np.uint8 if uint8 else np.float32)
                assert fo.shape == (10, IMG, IMG, 3)
                np.testing.assert_array_equal(fo, fr)
                first = fo[0, 0, 0, 0] if uint8 else round(float(fo[0, 0, 0, 0]) * 255)
                starts.add(int(first))
        # the train split draws its starts from [0, 2]; the others start at 0
        assert (len(starts) > 1) if ours.split == "train" else starts == {0}


def test_refuses_too_few_frames_and_the_png_route(cliport_root, tmp_path):
    kw = dict(root=str(cliport_root), split="test", num_frames=FRAMES + 1, img_size=[IMG, IMG])
    for cls in (CLIPort, JaxCLIPort):
        with pytest.raises(ValueError, match="13 frames required but 12 available"):
            cls(**kw)[0]
    root = write_cliport(tmp_path / "png", {"test": (1,)})
    ep = root / "test" / "episode1"
    (ep / f"color_cache_{IMG}x{IMG}.npy").unlink()
    with pytest.raises(FileNotFoundError, match="make_npy_cache"):
        CLIPort(str(root), "test", num_frames=2, img_size=[IMG, IMG])[0]
    (ep / "color").mkdir()  # the PNG route, and no frame in it
    for cls in (CLIPort, JaxCLIPort):
        with pytest.raises(ValueError, match="2 frames required but 0 available"):
            cls(str(root), "test", num_frames=2, img_size=[IMG, IMG])[0]
    with pytest.raises(FileNotFoundError):
        CLIPort(str(tmp_path / "nowhere"), "test", num_frames=2, img_size=[IMG, IMG])
    with pytest.raises(ValueError, match="Unknown split"):
        CLIPort(str(root), "dev", num_frames=2, img_size=[IMG, IMG])


@pytest.mark.parametrize("tokenizer", ["CustomTokenizer", "T5"])
def test_loader_batches_and_tokens_match_jax(cliport_root, tokenizer):
    p = build_exp_params("ExtendedDINOSAUR", "CLIPort")
    p["dataset"].update(root=str(cliport_root), img_size=[IMG, IMG], num_frames=4,
                        tokenizer=tokenizer)
    for split in ("train", "test"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ours, ref = load_data(p, split=split), jax_load_data(p, split=split)
        assert type(ours.tokenizer).__name__ == type(ref.tokenizer).__name__
        batches = list(EpochLoader(ours, batch_size=BATCH, shuffle=True))
        ref_batches = list(JaxDataLoader(ref, batch_size=BATCH, shuffle=True, num_workers=0))
        assert [b[0].shape[0] for b in batches] == [2, 1]
        for (vo, io), (vr, ir) in zip(batches, ref_batches):
            np.testing.assert_array_equal(vo, vr)
            assert io["caption"] == ir["caption"]
            for key in ("caption_tokens", "caption_lengths", "attn_masks"):
                np.testing.assert_array_equal(io[key], ir[key], err_msg=key)


# --------------------------------------------------------------- 05 on CLIPort

def tiny_cliport_params(build, add, data_root):
    """A tiny ExtendedDINOSAUR (img 42, patch 14, 2 ViT-S blocks, 3 slots of
    16, 4 CNN blocks, ``Learned`` slots) + TextOCVP_T5 experiment over
    ``data_root``."""
    p = build("ExtendedDINOSAUR", "CLIPort")
    mp = p["model"]["model_params"]
    mp.update(img_size=IMG, num_slots=S, slot_dim=D, mlp_hidden=16, mlp_encoder_dim=32,
              initializer="Learned")
    mp["encoder"]["encoder_name"] = "vit_small_patch14_dinov2"
    mp["encoder"]["encoder_params"]["encoder_num_blocks"] = 2
    mp["decoder"]["decoder_params"].update(num_patches=9, in_dim=D, hidden_dim=32, out_dim=385,
                                           num_layers=2)
    mp["transition_module"] = {"model_name": "TransformerBlock", "num_heads": 2, "mlp_size": 16}
    p["dataset"].update(img_size=[IMG, IMG], root=str(data_root))
    p["training"]["batch_size"] = BATCH
    pp = add(p, "TextOCVP_T5")
    pr = pp["predictor"]["predictor_params"]
    pr["predictor_params"].update(token_dim=32, n_heads=2, hidden_dim=64, num_layers=2)
    pr["fusion_params"].update(num_heads=2, head_dim=16, mlp_size=64)
    pr["text_encoder_params"] = dict(vocab_size=32128, d_model=32, d_kv=16, num_heads=2,
                                     d_ff=64, num_layers=2)
    pp["prediction_params"].update(num_context=1, num_preds=NUM_PREDS, input_buffer_size=4)
    return p, pp


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


def _perturb_stats(stats, rng):
    """Running means N(0, 0.3), running variances U(0.5, 2)."""
    def leaf(path, x):
        if path[-1].key == "mean":
            return (0.3 * rng.standard_normal(np.shape(x))).astype(np.float32)
        return rng.uniform(0.5, 2.0, np.shape(x)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, stats)


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory, cliport_root):
    """Both packages' checkpoints of one tiny CLIPort experiment."""
    root = tmp_path_factory.mktemp("cliport_eval")
    params, pred_params = tiny_cliport_params(jax_build_exp_params, jax_add_predictor_params,
                                              cliport_root)
    ours, _ = tiny_cliport_params(build_exp_params, add_predictor_params, cliport_root)
    assert ours == {k: v for k, v in params.items() if k != "tpu"}  # the port has no tpu knobs
    parent = Experiment(root / "exp")
    parent.save_params(params)
    pred = Experiment(root / "exp" / "predictors" / "tiny_t5")
    pred.save_params(pred_params)
    rng = np.random.default_rng(41)
    mvars = jax_setup_model(params).init({"params": jax.random.PRNGKey(0)},
                                         jnp.zeros((1, 1, IMG, IMG, 3)), decode=True)
    mparams = _perturb(jax.device_get(mvars["params"]), rng)
    stats = _perturb_stats(jax.device_get(mvars["batch_stats"]), rng)
    pvars = jax_setup_predictor(pred_params).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 1, S, D)),
        caption_tokens=jnp.ones((1, 5), jnp.int32), attn_masks=jnp.ones((1, 5), jnp.int32))
    pparams = _perturb(jax.device_get(pvars["params"]), rng)
    save_checkpoint(parent.models_dir, "ckpt", {"params": mparams, "batch_stats": stats})
    save_checkpoint(pred.models_dir, "ckpt", {"params": pparams})
    torch.save(from_jax_params("dinosaur", mparams, batch_stats=stats),
               parent.checkpoint_path("ckpt"))
    torch.save(from_jax_params("predictor", pparams), pred.checkpoint_path("ckpt"))
    return root / "exp"


def test_evaluator_matches_jax(exp_dir):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_ev = JaxPredictorEvaluator(exp_dir, "tiny_t5", "ckpt", "ckpt", num_seed=1,
                                       num_preds=NUM_PREDS, results_name="jax")
        ref_ev.load_data()
        videos, others = next(iter(ref_ev.test_loader))
        ref_ev.load_models(videos, others)
        ref = ref_ev.evaluate()
        ev = PredictorEvaluator(exp_dir, "tiny_t5", "ckpt", "ckpt", num_seed=1,
                                num_preds=NUM_PREDS, results_name="torch", device="cpu")
    assert ev.exp_params["dataset"]["num_frames"] == 1 + NUM_PREDS
    ev.load_data()
    ev.load_models()
    assert not ev.model.patch_decoder.cnns[0].bn.training  # the running statistics
    assert len(ev.test_set) == 3 and ev.test_set.vocabulary == CLIPORT_VOCAB_TEST
    out = ev.evaluate()
    saved = json.loads((exp_dir / "predictors" / "tiny_t5" / "results" / "torch"
                        / "results.json").read_text())
    assert saved == out
    assert set(out) == set(ref) == {"psnr", "ssim", "lpips", "tokenizer_fallback"}
    assert out["tokenizer_fallback"] is True and out["lpips"]["comparable"] is False
    for m in ("psnr", "ssim", "lpips"):
        assert len(out[m]["framewise"]) == NUM_PREDS
        got = np.array(out[m]["framewise"] + [out[m]["mean"]])
        want = np.array(ref[m]["framewise"] + [ref[m]["mean"]])
        assert np.abs(got - want).max() <= TOL + 1e-12, (m, got, want)
