"""The PyTorch port's serving slice as a whole, on the CPU: PredictionService
against the JAX package's PredictionService on two tiny experiments (SAVi
and ExtendedDINOSAUR, each with TextOCVP_T5), the request contract, and one
HTTP round trip.

One experiment directory holds both packages' checkpoints of the same weights
(``.msgpack`` for the JAX package, ``.pt`` carried by ``from_jax_params`` for
the port, BatchNorm statistics included). The models use the ``Learned``
initializer, so no random draw differs between the two. Both sides tokenize
with the hash fallback.
"""

import io
import json
import os
import threading
import urllib.request

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from textocvp_tpu.models import setup_model as jax_setup_model  # noqa: E402
from textocvp_tpu.models import setup_predictor as jax_setup_predictor  # noqa: E402
from textocvp_tpu.serve import PredictionService as JaxPredictionService  # noqa: E402
from textocvp_tpu.train.checkpoints import save_checkpoint  # noqa: E402
from textocvp_tpu_torch.cli.serve import serve_args  # noqa: E402
from textocvp_tpu_torch.convert import from_jax_params  # noqa: E402
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params  # noqa: E402
from textocvp_tpu_torch.core.experiment import Experiment  # noqa: E402
from textocvp_tpu_torch.serve import PredictionService, serve  # noqa: E402

RES, S, D, NUM_PREDS, BATCH, MAX_TOKENS = 16, 4, 32, 3, 2, 12
DINO_RES = 28
CAPTIONS = ["the cone is sliding to (1, -2)", "the snitch is picked up and placed"]


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


def _tiny_params(model="SAVi"):
    if model == "SAVi":
        p = build_exp_params("SAVi", "CATER_Easy")
        mp = p["model"]["model_params"]
        mp.update(num_slots=S, slot_dim=D, mlp_hidden=64, mlp_encoder_dim=32,
                  initializer="Learned")
        mp["encoder"]["encoder_params"].update(num_channels=[8, 8], resolution=[RES, RES])
        mp["decoder"]["decoder_params"].update(num_channels=[8, 8], resolution=[RES, RES])
        p["dataset"]["img_size"] = [RES, RES]
    else:  # a 1-block DINOv2-small ViT and a 2 x 2 patch grid at 28 px
        p = build_exp_params("ExtendedDINOSAUR", "CLIPort")
        mp = p["model"]["model_params"]
        mp.update(img_size=DINO_RES, num_slots=S, slot_dim=D, mlp_hidden=64,
                  mlp_encoder_dim=32, initializer="Learned")
        mp["encoder"] = {"encoder_name": "vit_small_patch14_dinov2",
                         "encoder_params": {"encoder_num_blocks": 1}}
        mp["decoder"]["decoder_params"].update(num_patches=4, in_dim=D, hidden_dim=32,
                                               out_dim=385, num_layers=2, num_layers_cnn=2)
        p["dataset"]["img_size"] = [DINO_RES, DINO_RES]
    mp["transition_module"] = {"model_name": "TransformerBlock", "num_heads": 2, "mlp_size": 64}
    pp = add_predictor_params(p, "TextOCVP_T5")
    pr = pp["predictor"]["predictor_params"]
    pr["predictor_params"].update(token_dim=64, n_heads=4, hidden_dim=128, num_layers=2)
    pr["fusion_params"].update(num_heads=4, head_dim=16, mlp_size=128)
    pr["text_encoder_params"] = dict(vocab_size=32128, d_model=64, d_kv=16, num_heads=4,
                                     d_ff=128, num_layers=2)
    pp["prediction_params"].update(num_context=1, num_preds=NUM_PREDS, input_buffer_size=4)
    return p, pp


def _write_experiment(root, model_name, res):
    """Both packages' checkpoints of one tiny experiment with perturbed JAX weights."""
    rng = np.random.default_rng(31)
    params, pred_params = _tiny_params(model_name)
    parent = Experiment(root)
    parent.save_params(params)
    pred = Experiment(root / "predictors" / "tiny_t5")
    pred.save_params(pred_params)

    model = jax_setup_model(params)
    video = jnp.zeros((1, 1, res, res, 3))
    mvars = model.init({"params": jax.random.PRNGKey(0)}, video, decode=True)
    mstate = {"params": _perturb(jax.device_get(mvars["params"]), rng)}
    if "batch_stats" in mvars:  # running means off 0, variances off 1
        mstate["batch_stats"] = jax.tree_util.tree_map(
            lambda x: np.asarray(x) + rng.uniform(0.1, 0.5, np.shape(x)).astype(np.float32),
            jax.device_get(mvars["batch_stats"]))
    predictor = jax_setup_predictor(pred_params)
    pvars = predictor.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 1, S, D)),
                           caption_tokens=jnp.ones((1, 5), jnp.int32),
                           attn_masks=jnp.ones((1, 5), jnp.int32))
    pparams = _perturb(jax.device_get(pvars["params"]), rng)

    save_checkpoint(parent.models_dir, "ckpt", mstate)
    save_checkpoint(pred.models_dir, "ckpt", {"params": pparams})
    kind = "savi" if model_name == "SAVi" else "dinosaur"
    torch.save(from_jax_params(kind, mstate["params"], batch_stats=mstate.get("batch_stats")),
               parent.checkpoint_path("ckpt"))
    torch.save(from_jax_params("predictor", pparams), pred.checkpoint_path("ckpt"))
    return root


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory):
    return _write_experiment(tmp_path_factory.mktemp("port_serve") / "exp", "SAVi", RES)


@pytest.fixture(scope="module")
def dino_exp_dir(tmp_path_factory):
    return _write_experiment(tmp_path_factory.mktemp("port_serve_dino") / "exp",
                             "ExtendedDINOSAUR", DINO_RES)


@pytest.fixture(scope="module")
def service(exp_dir):
    return PredictionService(exp_dir, "tiny_t5", "ckpt", "ckpt", batch_size=BATCH,
                             max_tokens=MAX_TOKENS, device="cpu")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(2).uniform(0, 1, (BATCH, 1, RES, RES, 3)).astype(np.float32)


def test_predict_matches_the_jax_chain(exp_dir, service, frames):
    jax_service = JaxPredictionService(exp_dir, "tiny_t5", "ckpt", "ckpt",
                                       batch_size=BATCH, max_tokens=MAX_TOKENS)
    ids = service.tokenizer(CAPTIONS)["caption_tokens"]
    assert service.tokenizer.is_fallback and jax_service.tokenizer.is_fallback
    np.testing.assert_array_equal(ids, jax_service.tokenizer(CAPTIONS)["caption_tokens"])

    ref = jax_service.predict(frames, CAPTIONS)
    out = service.predict(frames, CAPTIONS)
    assert out.shape == ref.shape == (BATCH, NUM_PREDS, RES, RES, 3)
    # uint8 outputs within one level on every pixel (rounding at a .5 boundary)
    levels = np.abs(np.rint(out * 255).astype(int) - np.rint(ref * 255).astype(int))
    assert levels.max() <= 1, levels.max()


def test_dinosaur_predict_matches_the_jax_chain(dino_exp_dir):
    service = PredictionService(dino_exp_dir, "tiny_t5", "ckpt", "ckpt", batch_size=BATCH,
                                max_tokens=MAX_TOKENS, device="cpu")
    assert service.resolution == (DINO_RES, DINO_RES)
    jax_service = JaxPredictionService(dino_exp_dir, "tiny_t5", "ckpt", "ckpt",
                                       batch_size=BATCH, max_tokens=MAX_TOKENS)
    frames = np.random.default_rng(4).uniform(0, 1, (BATCH, 1, DINO_RES, DINO_RES, 3))
    frames = frames.astype(np.float32)
    ref = jax_service.predict(frames, CAPTIONS)
    out = service.predict(frames, CAPTIONS)
    assert out.shape == ref.shape == (BATCH, NUM_PREDS, DINO_RES, DINO_RES, 3)
    # uint8 outputs within one level on every pixel (rounding at a .5 boundary)
    levels = np.abs(np.rint(out * 255).astype(int) - np.rint(ref * 255).astype(int))
    assert levels.max() <= 1, levels.max()


def test_service_refuses_a_features_only_decoder(tmp_path):
    params, pred_params = _tiny_params("ExtendedDINOSAUR")
    params["model"]["model_params"]["decoder"]["decoder_params"]["reconstruct_images"] = False
    pred_params["model"] = params["model"]
    Experiment(tmp_path).save_params(params)
    Experiment(tmp_path / "predictors" / "tiny_t5").save_params(pred_params)
    with pytest.raises(ValueError, match="reconstruct_images"):
        PredictionService(tmp_path, "tiny_t5", "ckpt", "ckpt", device="cpu")


def test_padding_does_not_change_a_row(service, frames):
    one = service.predict(frames[:1], CAPTIONS[:1])
    two = service.predict(frames, CAPTIONS)
    assert one.shape == (1, NUM_PREDS, RES, RES, 3)
    np.testing.assert_array_equal(one[0], two[0])


def test_uint8_and_float32_wires_agree(exp_dir, service, frames):
    grid = np.round(frames * 255).astype(np.uint8)
    as_float = service.predict(grid.astype(np.float32) / np.float32(255), CAPTIONS)
    as_uint8 = service.predict(grid, CAPTIONS)
    u8_service = PredictionService(exp_dir, "tiny_t5", "ckpt", "ckpt", batch_size=BATCH,
                                   max_tokens=MAX_TOKENS, wire_dtype="uint8", device="cpu")
    np.testing.assert_array_equal(as_uint8, u8_service.predict(grid, CAPTIONS))
    np.testing.assert_allclose(as_float, as_uint8, atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("case", ["empty", "too_many_rows", "caption_count", "context",
                                  "caption_too_long", "wire_dtype"])
def test_request_contract_is_enforced(exp_dir, service, frames, case):
    with pytest.raises(ValueError):
        if case == "empty":
            service.predict(frames[:0], [])
        elif case == "too_many_rows":
            service.predict(np.repeat(frames, 2, axis=0), CAPTIONS * 2)
        elif case == "caption_count":
            service.predict(frames, CAPTIONS[:1])
        elif case == "context":
            service.predict(np.repeat(frames, 2, axis=1), CAPTIONS)
        elif case == "caption_too_long":
            service.predict(frames, ["the cone " * 12, "the cone"])
        else:
            PredictionService(exp_dir, "tiny_t5", "ckpt", "ckpt", wire_dtype="float16",
                              device="cpu")


def test_http_round_trip(service, frames):
    httpd = serve(service, host="127.0.0.1", port=0, warmup=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["num_preds"] == NUM_PREDS
        buf = io.BytesIO()
        np.savez(buf, frames=frames, captions=np.array(CAPTIONS))
        req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                     headers={"Content-Type": "application/npz"})
        with urllib.request.urlopen(req, timeout=120) as r:
            pred = np.load(io.BytesIO(r.read()))["pred_frames"]
        assert pred.dtype == np.uint8 and pred.shape == (BATCH, NUM_PREDS, RES, RES, 3)
        np.testing.assert_array_equal(pred, np.rint(service.predict(frames, CAPTIONS) * 255))
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["requests"] == 1 and stats["rows"] == BATCH and stats["errors"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_cli_defaults_to_the_card():
    args = serve_args(["-d", "/tmp/x", "--name_pred_exp", "p", "--decomp_ckpt", "c",
                       "--pred_ckpt", "c"])
    assert args.device == "cuda" and args.batch_size == 8 and args.max_tokens == 24


def test_service_without_a_card_refuses_cuda(exp_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictionService(exp_dir, "tiny_t5", "ckpt", "ckpt")


def test_missing_checkpoint_raises(exp_dir):
    with pytest.raises(FileNotFoundError):
        PredictionService(exp_dir, "tiny_t5", "nope", "ckpt", device="cpu")
