"""The 04 step of the port's four other predictors (VanillaTransformer, OCVPSeq, OCVPPar,
TextOCVP_CustomTF) on the CPU, against the JAX package.

* The 04 step: the tiny SAVi of ``test_torch_port_train_savi.py`` (16 px, 4
  slots of 32) frozen, each tiny predictor of ``test_torch_port_predictors.
  py`` trained through it, c=1, p=3, buffer 4, B=2, CATER_Easy captions
  through the CustomTokenizer. Same weights, video, captions and slot noise
  on both sides; the JAX side is the line-for-line ``forward_loss`` copy of
  ``test_torch_port_train_predictor.py::jax_loss_fn``. Loss rtol 1e-5; each
  gradient leaf within 1e-4 of the leaf's largest |g|, that scale floored at
  a thousandth of the largest |g| of any leaf (an attention's key bias has a
  gradient of 0 in exact arithmetic: rounding noise on both sides); the
  embedding rows that the captions never use have a gradient of exactly 0 on
  both sides (within 1e-4 of the largest |g|). Parameters after two Adam
  updates within 1e-7 of optax's at lr 1e-5, but the key biases: Adam
  normalizes their noise into moves of up to lr a step either way (OCVPPar's
  object attention's came out more than 1e-7 apart), so they are held to
  2 lr a step.

(The 05 evaluator and the service of these predictors:
``test_torch_port_train_predictors_eval.py``; the 04 / 05 CLIs:
``_train_predictors_cli.py``.)
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_port_predictors import OTHERS, captions, tiny_params  # noqa: E402
from test_torch_port_train_predictor import TRAINING, _perturb, jax_loss_fn  # noqa: E402
from test_torch_port_train_savi import _jax_noise, tiny_savi_params  # noqa: E402

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params  # noqa: E402
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params  # noqa: E402
from textocvp_tpu.models import setup_model as jax_setup_model  # noqa: E402
from textocvp_tpu.models import setup_predictor as jax_setup_predictor  # noqa: E402
from textocvp_tpu.train.schedulers import build_optimizer as jax_build_optimizer  # noqa: E402
from textocvp_tpu_torch.convert import from_jax_params  # noqa: E402
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params  # noqa: E402
from textocvp_tpu_torch.core.experiment import Experiment  # noqa: E402
from textocvp_tpu_torch.train.checkpoints import save_checkpoint  # noqa: E402
from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer  # noqa: E402

B, C, P, RES, S, D = 2, 1, 3, 16, 4, 32
# an attention's key bias: its gradient is 0 in exact arithmetic, so both
# sides hand Adam rounding noise, which it turns into moves of up to lr
KEY_BIAS = "k.bias"


@pytest.fixture(scope="module")
def decomp_case():
    """JAX weights of the tiny SAVi, a video, CustomTokenizer captions and two
    draws of slot noise."""
    rng = np.random.default_rng(6)
    video = rng.uniform(0, 1, (B, C + P, RES, RES, 3)).astype(np.float32)
    jdecomp = jax_setup_model(tiny_savi_params(jax_build_exp_params))
    mvars = jax.jit(lambda x: jdecomp.init({"params": jax.random.PRNGKey(0),
                                            "slots": jax.random.PRNGKey(1)}, x, decode=True))(
        jnp.asarray(video))
    mparams = _perturb(jax.device_get(mvars["params"]), rng)
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    noise = [_jax_noise(jdecomp, {"params": mparams}, B, k) for k in keys]
    tokens, lengths = captions()
    return {"jdecomp": jdecomp, "mparams": mparams, "video": video, "tokens": tokens,
            "lengths": lengths, "masks": None, "keys": keys, "noise": noise}


_CASES = {}


def pred_case(decomp_case, name):
    """The case of predictor ``name`` (JAX config, module and perturbed
    weights) and the jitted ``value_and_grad`` of the JAX step by
    ``teacher_force``, built once a module."""
    if name not in _CASES:
        rng = np.random.default_rng(len(name))
        jp = tiny_params(jax_build_exp_params, jax_add_predictor_params, name,
                         base=tiny_savi_params(jax_build_exp_params))
        jpred = jax_setup_predictor(jp)
        text = {"caption_tokens": jnp.asarray(decomp_case["tokens"][:1]),
                "caption_lengths": jnp.asarray(decomp_case["lengths"][:1])}
        pvars = jpred.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, C, S, D)), **text)
        case = {**decomp_case, "name": name, "jp": jp, "jpred": jpred,
                "pparams": _perturb(jax.device_get(pvars["params"]), rng)}
        case["fns"] = {tf: jax.jit(jax.value_and_grad(jax_loss_fn(case, tf), has_aux=True))
                       for tf in (False, True)}
        _CASES[name] = case
    return _CASES[name]


def port_trainer(root, case, tf, **training):
    """A PredictorTrainer on the CPU over a parent experiment with the JAX
    SAVi weights (``decomp``) and a predictor experiment started from the
    JAX predictor weights (``init``)."""
    params = tiny_params(build_exp_params, add_predictor_params, case["name"],
                         base=tiny_savi_params(build_exp_params))
    params["prediction_params"]["teacher_force"] = tf
    params["training"].update({**TRAINING, "batch_size": B, **training})
    parent = Experiment(root / "exp")
    parent.save_params(tiny_savi_params(build_exp_params))
    pred = Experiment(root / "exp" / "predictors" / "tiny")
    pred.save_params(params)
    parent.models_dir.mkdir(parents=True)
    torch.save(from_jax_params("savi", case["mparams"]), parent.checkpoint_path("decomp"))
    save_checkpoint(pred.checkpoint_path("init"),
                    {"params": from_jax_params("predictor", case["pparams"])})
    tr = PredictorTrainer(pred.exp_path, "decomp", checkpoint="init", device="cpu")
    tr.setup_model()
    return tr


def port_batch(case, i=0):
    text = {"caption_tokens": torch.from_numpy(case["tokens"]),
            "caption_lengths": torch.from_numpy(case["lengths"])}
    return torch.tensor(case["video"]), torch.tensor(np.asarray(case["noise"][i])), text


@pytest.mark.parametrize("tf", [False, True], ids=["free", "forced"])
@pytest.mark.parametrize("name", OTHERS)
def test_loss_and_every_gradient_match_jax(decomp_case, name, tf, tmp_path):
    case = pred_case(decomp_case, name)
    (loss, _), grads = case["fns"][tf](case["pparams"], case["keys"][0])
    tr = port_trainer(tmp_path, case, tf)
    video, noise, text = port_batch(case)
    total, values = tr.forward_loss(video, noise, **text)
    np.testing.assert_allclose(total.item(), float(loss), rtol=1e-5)
    assert set(values) == {"pred_img_mse", "pred_slot_mse", "_total"}
    total.backward()
    want = from_jax_params("predictor", jax.device_get(grads))
    named = dict(tr.model.named_parameters())
    assert set(want) == set(named) and all(p.requires_grad for p in named.values())
    top = max(g.abs().max().item() for g in want.values())
    for pname, p in named.items():
        g = want[pname]
        err = (p.grad - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), 1e-3 * top), (pname, err)
    if name == "TextOCVP_CustomTF":  # rows no caption uses: exactly 0 on both sides
        used = np.unique(case["tokens"])
        emb = "predictor.text_encoder.token_embedding.weight"
        unused = torch.from_numpy(np.setdiff1d(np.arange(named[emb].shape[0]), used))
        pos = "predictor.text_encoder.position_embedding.weight"
        for leaf, rows in ((emb, unused), (pos, torch.arange(case["tokens"].shape[1], 50))):
            for g in (named[leaf].grad[rows], want[leaf][rows]):
                assert g.abs().max().item() <= 1e-4 * top, leaf
        assert named[emb].grad[torch.from_numpy(used)].abs().max() > 0


@pytest.mark.parametrize("name", OTHERS)
def test_two_updates_match_optax(decomp_case, name, tmp_path):
    case = pred_case(decomp_case, name)
    tx, _ = jax_build_optimizer(TRAINING)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params = case["pparams"]
    opt_state = jax.jit(tx.init)(params)
    tr = port_trainer(tmp_path, case, True)
    lr = TRAINING["lr"]
    frozen = {k: v.clone() for k, v in tr.decomp_model.state_dict().items()}
    for i in range(2):
        (loss, _), grads = case["fns"][True](params, case["keys"][i])
        params, opt_state = update(grads, opt_state, params)
        video, noise, text = port_batch(case, i)
        values = tr.train_step(video, noise, **text)
        np.testing.assert_allclose(float(values["_total"]), float(loss), rtol=1e-5)
        want = from_jax_params("predictor", jax.device_get(params))
        for pname, p in tr.model.state_dict().items():
            if pname.endswith(KEY_BIAS):  # noise in, a move of up to lr out
                assert (p - want[pname]).abs().max().item() <= 2 * (i + 1) * lr, pname
            else:
                torch.testing.assert_close(p, want[pname], rtol=0, atol=1e-7, msg=pname)
    assert tr.optimizer.count == 2
    for pname, before in frozen.items():
        assert torch.equal(tr.decomp_model.state_dict()[pname], before), pname
