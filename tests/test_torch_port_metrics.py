"""PSNR, SSIM, LPIPS and the MetricTracker of the PyTorch port against the JAX
package's ``textocvp_tpu/train/metrics.py`` on the CPU.

The same numpy frames go through both at 16 px (LPIPS takes its bilinear
resize to 32 px there) and at 64 px, the CATER size. Framewise (B, F) values
agree to 1e-5 absolute: float32 on both sides, sums and convolutions in
other orders.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textocvp_tpu.train import metrics as jm
from textocvp_tpu_torch.train import metrics as tm

ATOL = 1e-5


def _videos(res, seed, b=2, f=3):
    rng = np.random.default_rng(seed)
    preds = rng.uniform(0, 1, (b, f, res, res, 3)).astype(np.float32)
    # targets near the predictions, so SSIM and LPIPS sit away from their limits
    noise = 0.15 * rng.standard_normal(preds.shape).astype(np.float32)
    targets = np.clip(preds + noise, 0, 1).astype(np.float32)
    return preds, targets


@pytest.fixture(scope="module")
def weights():
    return tm._default_lpips_weights(14)


def test_default_lpips_weights_are_the_jax_ones(weights):
    ref = jm._default_lpips_weights(14)
    assert set(weights) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(weights[k], ref[k], err_msg=k)


@pytest.mark.parametrize("res", [16, 64])
@pytest.mark.parametrize("metric", ["psnr", "ssim", "lpips"])
def test_metric_matches_jax(weights, res, metric):
    preds, targets = _videos(res, seed=res)
    if metric == "lpips":
        ref = jm.make_lpips_fn(weights)(jnp.asarray(preds), jnp.asarray(targets))
        out = tm.LPIPS(weights)(torch.from_numpy(preds), torch.from_numpy(targets))
    else:
        ref = getattr(jm, metric)(jnp.asarray(preds), jnp.asarray(targets))
        out = getattr(tm, metric)(torch.from_numpy(preds), torch.from_numpy(targets))
    assert out.shape == (2, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_psnr_clamps_a_perfect_prediction():
    preds, _ = _videos(16, seed=1)
    out = tm.psnr(torch.from_numpy(preds), torch.from_numpy(preds))
    np.testing.assert_allclose(out.numpy(), 100.0)


def _trackers(weights, pretrained=None):
    kw = {"lpips_weights": weights, "lpips_pretrained": pretrained}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jm.MetricTracker(**kw), tm.MetricTracker(**kw)


def test_tracker_to_json_matches_jax(weights):
    jt, tt = _trackers(weights, pretrained=False)
    for seed in (3, 4):  # two batches, the second ragged
        preds, targets = _videos(32, seed, b=3 if seed == 3 else 1)
        jt.accumulate(jnp.asarray(preds), jnp.asarray(targets))
        tt.accumulate(torch.from_numpy(preds), torch.from_numpy(targets))
    ref, out = jt.to_json(), tt.to_json()
    assert set(out) == set(ref) == {"psnr", "ssim", "lpips"}
    assert out["lpips"]["comparable"] is False is ref["lpips"]["comparable"]
    for m in ("psnr", "ssim", "lpips"):
        assert len(out[m]["framewise"]) == 3
        assert out[m]["mean"] == round(out[m]["mean"], 5)
        np.testing.assert_allclose(out[m]["framewise"], ref[m]["framewise"], rtol=0, atol=2e-5)
        np.testing.assert_allclose(out[m]["mean"], ref[m]["mean"], rtol=0, atol=2e-5)


def test_tracker_rejects_an_unknown_metric():
    with pytest.raises(NameError):
        tm.MetricTracker(("psnr", "fid"))


@pytest.mark.parametrize("from_file", [True, False])
def test_lpips_weights_round_trip_and_comparable_flag(tmp_path, monkeypatch, weights, from_file):
    path = tmp_path / "lpips.npz"
    scaled = {k: v * 1.5 for k, v in weights.items()}
    np.savez(path, **scaled)
    monkeypatch.setenv("TEXTOCVP_LPIPS_WEIGHTS", str(path) if from_file else "")
    loaded, pretrained = tm.load_lpips_weights()
    assert pretrained is from_file
    ref_loaded, ref_pretrained = jm.load_lpips_weights()
    assert ref_pretrained is from_file
    for k in weights:
        np.testing.assert_array_equal(loaded[k], scaled[k] if from_file else weights[k])
        np.testing.assert_array_equal(loaded[k], ref_loaded[k])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tracker = tm.MetricTracker(("lpips",))
    preds, targets = _videos(16, seed=5, b=1, f=1)
    tracker.accumulate(torch.from_numpy(preds), torch.from_numpy(targets))
    assert tracker.to_json()["lpips"]["comparable"] is from_file
