"""The 05 evaluate-predictor slice of the PyTorch port on the CPU: the CATER
``.npy`` dataset and its loader against the JAX package's, and the port's
``PredictorEvaluator`` against the JAX ``PredictorEvaluator`` on one tiny
experiment, through to ``results.json``.

The experiment directory holds both packages' checkpoints of the same weights
(``.msgpack`` for the JAX package, ``.pt`` carried by ``from_jax_params``);
SAVi uses the ``Learned`` initializer, so no random draw differs. Both sides
tokenize with the hash fallback (no T5 files here). Five test videos in
batches of 2 leave a ragged last batch, which the JAX package pads to its
mesh and slices, and the port runs as it is. Framewise PSNR agrees within
1e-3 dB, SSIM and LPIPS within 1e-4: float32 on both sides through encode,
a 3-step rollout and the decode, sums in other orders.
"""

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

from textocvp_tpu.data.datasets import CATER as JaxCATER  # noqa: E402
from textocvp_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from textocvp_tpu.data.loader import load_data as jax_load_data  # noqa: E402
from textocvp_tpu.models import setup_model as jax_setup_model  # noqa: E402
from textocvp_tpu.models import setup_predictor as jax_setup_predictor  # noqa: E402
from textocvp_tpu.train.checkpoints import save_checkpoint  # noqa: E402
from textocvp_tpu.train.evaluator import PredictorEvaluator as JaxPredictorEvaluator  # noqa: E402
from textocvp_tpu_torch.cli.evaluate_predictor import evaluate_predictor_args, main  # noqa: E402
from textocvp_tpu_torch.convert import from_jax_params  # noqa: E402
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params  # noqa: E402
from textocvp_tpu_torch.core.experiment import Experiment  # noqa: E402
from textocvp_tpu_torch.data.datasets import CATER  # noqa: E402
from textocvp_tpu_torch.data.loader import EpochLoader, load_data  # noqa: E402
from textocvp_tpu_torch.train.evaluator import PredictorEvaluator  # noqa: E402

RES, S, D, NUM_PREDS, BATCH, VIDEOS, FRAMES = 16, 4, 32, 3, 2, 5, 6
CAPTIONS = ["the cone is sliding to (1, -2)", "the snitch is picked up and placed to (3, 3)",
            "the cone is rotating", "the snitch is containing the cone",
            "the cone is picked up and placed to (-1, 1)"]
PSNR_ATOL, ATOL = 1e-3, 1e-4


def write_cater_npy(root, num_videos=VIDEOS, frames=FRAMES, res=RES, seed=14):
    """<root>/easy/video_<i>.npy uint8 (frames, res, res, 3) and test_explicit.json."""
    rng = np.random.default_rng(seed)
    mode = root / "easy"
    mode.mkdir(parents=True, exist_ok=True)
    ann = {}
    for i in range(num_videos):
        # a smooth image drifting across the frames, plus noise
        yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res), indexing="ij")
        base = rng.uniform(0, 1, 3)
        video = np.stack([np.clip(np.stack([base[c] * (0.5 + 0.5 * np.sin(6 * xx + 0.4 * t + c)
                                                       * np.cos(4 * yy)) for c in range(3)], -1)
                                  + 0.05 * rng.standard_normal((res, res, 3)), 0, 1)
                          for t in range(frames)])
        np.save(mode / f"video_{i:04d}.npy", np.round(video * 255).astype(np.uint8))
        ann[str(i)] = {"video": f"video_{i:04d}.npy", "caption": CAPTIONS[i % len(CAPTIONS)]}
    with open(mode / "test_explicit.json", "w") as f:
        json.dump(ann, f)
    return root


def _tiny_params(data_root):
    p = build_exp_params("SAVi", "CATER_Easy")
    mp = p["model"]["model_params"]
    mp.update(num_slots=S, slot_dim=D, mlp_hidden=64, mlp_encoder_dim=32, initializer="Learned")
    mp["encoder"]["encoder_params"].update(num_channels=[8, 8], resolution=[RES, RES])
    mp["decoder"]["decoder_params"].update(num_channels=[8, 8], resolution=[RES, RES])
    mp["transition_module"] = {"model_name": "TransformerBlock", "num_heads": 2, "mlp_size": 64}
    p["dataset"].update(img_size=[RES, RES], root=str(data_root), num_frames=FRAMES - 1)
    p["training"]["batch_size"] = BATCH
    pp = add_predictor_params(p, "TextOCVP_T5")
    pr = pp["predictor"]["predictor_params"]
    pr["predictor_params"].update(token_dim=64, n_heads=4, hidden_dim=128, num_layers=2)
    pr["fusion_params"].update(num_heads=4, head_dim=16, mlp_size=128)
    pr["text_encoder_params"] = dict(vocab_size=32128, d_model=64, d_kv=16, num_heads=4,
                                     d_ff=128, num_layers=2)
    pp["prediction_params"].update(num_context=1, num_preds=NUM_PREDS, input_buffer_size=4)
    return p, pp


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory):
    """Both packages' checkpoints of one tiny experiment over a CATER .npy fixture."""
    root = tmp_path_factory.mktemp("port_eval")
    data_root = write_cater_npy(root / "CATER")
    params, pred_params = _tiny_params(data_root)
    parent = Experiment(root / "exp")
    parent.save_params(params)
    pred = Experiment(root / "exp" / "predictors" / "tiny_t5")
    pred.save_params(pred_params)
    rng = np.random.default_rng(31)
    mvars = jax_setup_model(params).init({"params": jax.random.PRNGKey(0)},
                                         jnp.zeros((1, 1, RES, RES, 3)), decode=True)
    mparams = _perturb(jax.device_get(mvars["params"]), rng)
    pvars = jax_setup_predictor(pred_params).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 1, S, D)),
        caption_tokens=jnp.ones((1, 5), jnp.int32), attn_masks=jnp.ones((1, 5), jnp.int32))
    pparams = _perturb(jax.device_get(pvars["params"]), rng)
    save_checkpoint(parent.models_dir, "ckpt", {"params": mparams})
    save_checkpoint(pred.models_dir, "ckpt", {"params": pparams})
    torch.save(from_jax_params("savi", mparams), parent.checkpoint_path("ckpt"))
    torch.save(from_jax_params("predictor", pparams), pred.checkpoint_path("ckpt"))
    return root / "exp"


def test_cater_items_and_batches_match_jax(exp_dir):
    params = Experiment(exp_dir).params
    for uint8 in (False, True):
        p = json.loads(json.dumps(params))
        p["dataset"]["uint8_wire"] = uint8
        ours, ref = load_data(p, split="test"), jax_load_data(p, split="test")
        assert len(ours) == len(ref) == VIDEOS
        for i in range(VIDEOS):
            (fo, co), (fr, cr) = ours[i], ref[i]
            assert co == cr and fo.dtype == fr.dtype == (np.uint8 if uint8 else np.float32)
            assert fo.shape == (FRAMES - 1, RES, RES, 3)
            np.testing.assert_array_equal(fo, fr)
        batches = list(EpochLoader(ours, batch_size=BATCH))
        ref_batches = list(JaxDataLoader(ref, batch_size=BATCH, num_workers=0))
        assert [b[0].shape[0] for b in batches] == [2, 2, 1]
        for (vo, io), (vr, ir) in zip(batches, ref_batches):
            np.testing.assert_array_equal(vo, vr)
            assert io["caption"] == ir["caption"]
            for key in ("caption_tokens", "caption_lengths", "attn_masks"):
                np.testing.assert_array_equal(io[key], ir[key], err_msg=key)


def test_cater_refuses_what_the_port_does_not_read(tmp_path):
    root = write_cater_npy(tmp_path, num_videos=2, frames=4)
    with open(root / "easy" / "test_explicit.json") as f:
        ann = json.load(f)
    ann["1"]["video"] = "video_0001.mp4"
    with open(root / "easy" / "test_explicit.json", "w") as f:
        json.dump(ann, f)
    # an mp4 needs imageio's ffmpeg backend, which this machine lacks
    with pytest.raises((RuntimeError, ImportError), match="ffmpeg"):
        CATER(tmp_path, "easy", "test", num_frames=3, img_size=(RES, RES))[1]
    # a resize is read, and equals the JAX package's
    ours = CATER(tmp_path, "easy", "test", num_frames=3, img_size=(8, 8))[0][0]
    np.testing.assert_array_equal(
        ours, JaxCATER(str(tmp_path), "easy", "test", num_frames=3, img_size=(8, 8))[0][0])
    assert ours.shape == (3, 8, 8, 3)


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
    assert ev.batch_size == BATCH and ev.exp_params["dataset"]["num_frames"] == 1 + NUM_PREDS
    ev.load_data()
    ev.load_models()
    out = ev.evaluate()
    saved = json.loads((exp_dir / "predictors" / "tiny_t5" / "results" / "torch"
                        / "results.json").read_text())
    assert saved == out
    assert set(out) == set(ref) == {"psnr", "ssim", "lpips", "tokenizer_fallback"}
    assert out["tokenizer_fallback"] is True and out["lpips"]["comparable"] is False
    for m, tol in (("psnr", PSNR_ATOL), ("ssim", ATOL), ("lpips", ATOL)):
        assert len(out[m]["framewise"]) == NUM_PREDS
        np.testing.assert_allclose(out[m]["framewise"], ref[m]["framewise"], rtol=0, atol=tol,
                                   err_msg=m)
        np.testing.assert_allclose(out[m]["mean"], ref[m]["mean"], rtol=0, atol=tol, err_msg=m)


def test_ragged_batch_rows_equal_full_batch_rows(exp_dir):
    ev = PredictorEvaluator(exp_dir, "tiny_t5", "ckpt", "ckpt", device="cpu")
    ev.load_data()
    ev.load_models()
    videos, info = next(iter(ev.test_loader))
    full = ev.eval_step(videos, info)
    one = ev.eval_step(videos[1:], {k: v[1:] for k, v in info.items()})
    for m in ("psnr", "ssim", "lpips"):
        assert full[m].shape == (BATCH, NUM_PREDS)
        torch.testing.assert_close(one[m][0], full[m][1], rtol=0, atol=1e-5)


def test_cli_writes_results_on_the_cpu(exp_dir):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert main(["-d", str(exp_dir), "--name_pred_exp", "tiny_t5", "--decomp_ckpt", "ckpt",
                     "--pred_ckpt", "ckpt", "--num_preds", "2", "--batch_size", "4",
                     "--device", "cpu"]) == 0
    out_dir = exp_dir / "predictors" / "tiny_t5" / "results" / "eval_pred_ckpt_NumSeed=1_NumPreds=2"
    res = json.loads((out_dir / "results.json").read_text())
    for m in ("psnr", "ssim", "lpips"):
        assert len(res[m]["framewise"]) == 2 and np.isfinite(res[m]["mean"])
        assert (out_dir / f"{m}_framewise.png").is_file()  # from frame num_seed = 1


def test_save_results_merges_with_an_earlier_file(tmp_path):
    exp = Experiment(tmp_path)
    exp.save_results("run", {"psnr": 1, "old": 2})
    path = exp.save_results("run", {"psnr": 3})
    assert json.loads(path.read_text()) == {"psnr": 3, "old": 2}


def test_cli_defaults_to_the_card_and_refuses_cuda_without_one(exp_dir):
    argv = ["-d", str(exp_dir), "--name_pred_exp", "tiny_t5", "--decomp_ckpt", "ckpt",
            "--pred_ckpt", "ckpt"]
    args = evaluate_predictor_args(argv)
    assert args.device == "cuda" and args.batch_size is None and args.num_seed is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
