"""The trainers' extras on the CPU: ``logs.txt``, TensorBoard, the
``TEXTOCVP_PROFILE`` trace, the background checkpoint writer and its
emergency flush, and ``tpu.remat``.

* Remat recomputes exactly what the forward computed, so on the CPU the
  values, gradients and buffers with and without it are equal bit for bit:
  tiny SAVi and ExtendedDINOSAUR 02 steps (the BatchNorm statistics moved
  once, as without remat) and a TextOCVP_T5 04 step through a frozen SAVi.
  The one exception: the 02 decoder's trained leaves, whose gradient remat
  sums over regions of frames, within REMAT_TOLERANCE (1e-6) of the largest
  leaf (measured at most 2.8e-7).
* One tiny SAVi 02 step with ``tpu.remat`` against the JAX trainer with
  ``tpu.remat``: the loss, then the loss after the Adam update, rtol 1e-5, as
  ``test_torch_port_train_savi.py`` holds the step without remat.
"""

import json

import jax
import numpy as np
import pytest
import torch

from test_torch_port_train_dinosaur import IMG
from test_torch_port_train_dinosaur import tiny_params as tiny_dino_params
from test_torch_port_train_predictor import tiny_pred_params
from test_torch_port_train_savi import B, RES, T, TRAINING, _experiment, _jax_noise
from test_torch_port_train_savi import tiny_savi_params
from textocvp_tpu.train.trainer import DecompTrainer as JaxDecompTrainer
from textocvp_tpu_torch.cli.train_decomp import main as train_main
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core import logger
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_model
from textocvp_tpu_torch.train.checkpoints import (
    AsyncCheckpointWriter,
    load_checkpoint,
    make_checkpoint_saver,
    save_checkpoint,
)
from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer
from textocvp_tpu_torch.train.trainer import REMAT_REGIONS, DecompTrainer

REMAT_TOLERANCE = 1e-6  # the 02 decoder's remat gradients, over the largest leaf


def _regions(frames: int) -> int:
    """The remat regions ``remat_frames`` makes of ``frames`` frames."""
    return -(-frames // -(-frames // REMAT_REGIONS))


def _with(exp, **sections):
    """``exp``'s params with ``sections`` merged into theirs."""
    e = Experiment(exp)
    p = e.params
    for key, val in sections.items():
        p[key] = {**(p.get(key) or {}), **val}
    e.save_params(p)
    return exp


def _log_lines(path):
    return [line.split("    ", 1)[1] for line in (path / "logs.txt").read_text().splitlines()
            if "    " in line]


# ------------------------------------------------------------------ logs
def test_logger_tees_print_and_logs_exceptions(tmp_path, capsys):
    @logger.for_all_methods(logger.log_function)
    class Job:
        def run(self, x):
            return 2 * x

        def fail(self):
            raise ValueError("a broken job")

        @staticmethod
        def helper():
            return "static"

    logger.Logger(tmp_path)
    logger.print_("hello")
    logger.log_info("only in the file")
    assert Job().run(3) == 6 and Job.helper() == "static"
    with pytest.raises(ValueError, match="a broken job"):
        Job().fail()
    assert capsys.readouterr().out == "hello\n"
    lines = _log_lines(tmp_path)
    assert lines[:5] == ["INFO: hello", "INFO: only in the file", "INFO: Calling: run...",
                         "INFO: Calling: helper...", "INFO: Calling: fail..."]
    assert lines[5] == "ERROR: Traceback (most recent call last):"
    assert "ValueError: a broken job" in (tmp_path / "logs.txt").read_text()


def test_the_02_cli_writes_logs_tensorboard_and_a_profile(tmp_path, monkeypatch):
    exp = _experiment(tmp_path)
    monkeypatch.setenv("TEXTOCVP_PROFILE", str(tmp_path / "profile"))
    _with(exp, training={"image_log_frequency": 2})
    tr = train_main(["-d", str(exp), "--device", "cpu"])
    lines = _log_lines(exp)
    for want in ("INFO: Calling: load_data...", "INFO: Calling: setup_model...",
                 "INFO: Starting training loop", "INFO: Calling: training_loop...",
                 "INFO: Calling: valid_epoch...", "INFO: Calling: train_epoch..."):
        assert want in lines, want
    assert sum(line.startswith("INFO:   epoch 0 iter ") for line in lines) == 4
    assert any(line.startswith("INFO: Epoch 1/1: train=") for line in lines)
    # the image strips drew their own noise: 2 valid and 4 train batches
    assert tr.global_step == 6
    (trace,) = (tmp_path / "profile").glob("DecompTrainer_epoch0.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    events_files = list((exp / "tboard_logs").glob("events.out.tfevents.*"))
    assert events_files, "no TensorBoard event file"
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(exp / "tboard_logs"))
    acc.Reload()
    tags = acc.Tags()
    assert {"train/_total", "train/lr", "valid/_total"} <= set(tags["scalars"])
    assert tags["images"] == ["train/recons"]
    assert len(acc.Images("train/recons")) == 2  # iterations 0 and 2


# ------------------------------------------------------------- checkpoints
def test_the_async_writer_writes_what_the_synchronous_one_does(tmp_path):
    runs = {}
    for name, knob in (("sync", False), ("async", True)):
        (tmp_path / name).mkdir()
        exp = _with(_experiment(tmp_path / name, num_epochs=2),
                    tpu={"async_checkpoint": knob})
        train_main(["-d", str(exp), "--device", "cpu"])
        runs[name] = Experiment(exp).models_dir
    names = sorted(p.name for p in runs["sync"].iterdir())
    assert names == sorted(p.name for p in runs["async"].iterdir()) == [
        "checkpoint_epoch_1.pt", "checkpoint_epoch_2.pt", "checkpoint_epoch_final.pt",
        "checkpoint_last_saved.pt"]
    for n in names:
        a, b = load_checkpoint(runs["sync"] / n), load_checkpoint(runs["async"] / n)
        assert (a["epoch"], a["step"]) == (b["epoch"], b["step"])
        for key in a["params"]:
            torch.testing.assert_close(a["params"][key], b["params"][key], rtol=0, atol=0)
        assert a["opt_state"]["count"] == b["opt_state"]["count"]
        for x, y in zip(a["opt_state"]["mu"], b["opt_state"]["mu"]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_the_async_writer_copies_first_and_raises_a_failed_write(tmp_path):
    w = AsyncCheckpointWriter()
    t = torch.arange(4.0)
    w.save(tmp_path / "a.pt", {"params": {"t": t}})
    t.add_(100)  # the next step updates in place: the saved copy keeps 0..3
    w.wait()
    torch.testing.assert_close(load_checkpoint(tmp_path / "a.pt")["params"]["t"],
                               torch.arange(4.0))
    (tmp_path / "file").write_text("")
    w.save(tmp_path / "file" / "b.pt", {"params": {"t": t}})  # its parent is a file
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        w.wait()
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.save(tmp_path / "c.pt", {})
    save, flush = make_checkpoint_saver({"tpu": {"async_checkpoint": False}})
    assert save is save_checkpoint
    flush()


def test_the_emergency_path_drains_the_writer_first(tmp_path, monkeypatch):
    exp = _with(_experiment(tmp_path, num_epochs=2), tpu={"async_checkpoint": True})
    tr = DecompTrainer(exp, device="cpu")
    tr.load_data()
    tr.setup_model()
    calls = []
    step = DecompTrainer.train_step

    def failing(self, videos, noise=None):
        calls.append(1)
        if len(calls) == 5:  # the first step of the second epoch
            raise RuntimeError("boom")
        return step(self, videos, noise)

    monkeypatch.setattr(DecompTrainer, "train_step", failing)
    with pytest.raises(RuntimeError, match="boom"):
        tr.training_loop()
    models = Experiment(exp).models_dir
    assert {p.name for p in models.iterdir()} == {
        "checkpoint_last_saved.pt", "checkpoint_epoch_1.pt", "emergency_checkpoint_epoch_1.pt"}
    assert load_checkpoint(models / "checkpoint_last_saved.pt")["opt_state"]["count"] == 4
    assert load_checkpoint(models / "emergency_checkpoint_epoch_1.pt")["epoch"] == 1
    assert "RuntimeError: boom" in (exp / "logs.txt").read_text()


# ------------------------------------------------------------------- remat
def _grads(trainer, video, noise, **text):
    values = trainer.backward(video, noise, **text)
    return values, {n: p.grad.clone() for n, p in trainer.model.named_parameters()
                    if p.grad is not None}


def _assert_remat_equal(make, video, noise, frozen=None, framewise=None, **text):
    """One backward, and one update, with remat off and on: the same values,
    gradients and buffers, bit for bit; with remat the trained modules run
    again in the backward, the ``frozen`` submodule (by name) does not.
    ``framewise`` = (prefixes, module, regions): the 02 decode's trained
    leaves under ``prefixes``, whose gradient remat sums over ``regions``
    regions of frames, within REMAT_TOLERANCE of the largest leaf, and
    ``module`` run once a region and again in its recompute."""
    out, calls = {}, {}
    for knob in (False, True):
        tr = make(knob)
        assert tr.remat is knob
        count = calls[knob] = {}
        for name, mod in tr.model.named_modules():
            mod.register_forward_pre_hook(
                lambda m, a, name=name: count.__setitem__(name, count.get(name, 0) + 1))
        values, grads = _grads(tr, video, noise, **text)
        tr.optimizer.step()
        out[knob] = values, grads, {n: b.clone() for n, b in tr.model.named_buffers()}
    (v0, g0, b0), (v1, g1, b1) = out[False], out[True]
    assert v0.keys() == v1.keys() and all(torch.equal(v0[k], v1[k]) for k in v0)
    assert g0.keys() == g1.keys() and g0
    prefixes, module, regions = framewise or ((), None, 1)
    top = max(g.abs().max().item() for g in g0.values())
    summed = [name for name in g0 if name.startswith(prefixes)]
    assert bool(summed) == bool(prefixes)
    for name in g0:
        if name in summed:
            assert (g1[name] - g0[name]).abs().max().item() <= REMAT_TOLERANCE * top, name
        else:
            assert torch.equal(g0[name], g1[name]), name
    for name in b0:
        assert torch.equal(b0[name], b1[name]), name
    assert calls[True][""] == 2 * calls[False][""]  # the region ran again
    if module is not None:
        assert calls[True][module] == 2 * regions * calls[False][module] > 0
    if frozen is not None:
        assert calls[True][frozen] == calls[False][frozen] > 0  # kept, not replayed
    return out


def test_remat_gradients_equal_the_plain_ones_for_savi(tmp_path):
    def make(knob):
        (tmp_path / str(knob)).mkdir()
        tr = DecompTrainer(_with(_experiment(tmp_path / str(knob)), tpu={"remat": knob}),
                           device="cpu")
        tr.setup_model()
        return tr

    g = torch.Generator().manual_seed(3)
    _assert_remat_equal(make, torch.rand((B, T, RES, RES, 3), generator=g),
                        torch.randn((B, 4, 32), generator=g),
                        framewise=(("image_decoder.", "decoder_pos_embedding."),
                                   "image_decoder.blocks.0.conv", _regions(B * T)))


def test_remat_gradients_equal_the_plain_ones_for_extended_dinosaur(tmp_path):
    p, _ = tiny_dino_params(build_exp_params, add_predictor_params)
    p["training"].update(TRAINING, batch_size=2, accum_steps=2)
    mp = p["model"]["model_params"]

    def make(knob):
        exp = Experiment(tmp_path / str(knob))
        exp.save_params({**p, "tpu": {"remat": knob}})
        tr = DecompTrainer(exp.exp_path, device="cpu")
        tr.setup_model()
        return tr

    g = torch.Generator().manual_seed(4)
    video = torch.rand((2, 2, IMG, IMG, 3), generator=g)
    # two microbatches of 1 video of 2 frames: 2 regions each; the CNN head
    # (BatchNorm over all frames) a region a block, bit for bit
    out = _assert_remat_equal(make, video, torch.randn((2, mp["num_slots"], mp["slot_dim"]),
                                                       generator=g), frozen="image_encoder",
                              framewise=(("patch_decoder.pos_embed", "patch_decoder.initial_ln.",
                                          "patch_decoder.mlps."), "patch_decoder.mlps.0",
                                         _regions(2)))
    buffers = out[True][2]
    # two microbatches, each moved the statistics once
    tracked = [b for n, b in buffers.items() if n.endswith("num_batches_tracked")]
    assert tracked and all(int(b) == 2 for b in tracked)
    assert any(not torch.equal(b, torch.zeros_like(b)) for n, b in buffers.items()
               if n.endswith("running_mean"))


def _captions():
    """A caption batch of B rows, tokenized as the tiny experiments' datasets do."""
    from textocvp_tpu_torch.data.tokenizers import get_tokenizer
    from textocvp_tpu_torch.data.vocabularies import CATER_EASY_VOCAB

    tok = get_tokenizer("T5", vocabulary=CATER_EASY_VOCAB)
    captions = ["the cone is rotating", "the snitch is sliding to (1, 2)"][:B]
    return {"caption": captions, **tok(captions)}


def test_remat_gradients_equal_the_plain_ones_for_textocvp_t5(tmp_path):
    parent = Experiment(tmp_path / "exp")
    parent.save_params(tiny_savi_params(build_exp_params))
    savi = setup_model(parent.params)
    save_checkpoint(parent.checkpoint_path("frozen"), {"params": savi.state_dict()})
    pp = tiny_pred_params(build_exp_params, add_predictor_params, teacher_force=True)
    pp["training"].update(TRAINING, batch_size=B)

    def make(knob):
        pred = Experiment(parent.exp_path / "predictors" / f"remat_{knob}")
        pred.save_params({**pp, "tpu": {"remat": knob}})
        tr = PredictorTrainer(pred.exp_path, "frozen", device="cpu")
        tr.setup_model()
        return tr

    g = torch.Generator().manual_seed(5)
    frames = pp["prediction_params"]["num_context"] + pp["prediction_params"]["num_preds"]
    video = torch.rand((B, frames, RES, RES, 3), generator=g)
    tr = make(False)
    info = tr.batch_to_device(video.numpy(), _captions())[1]
    _assert_remat_equal(make, video, torch.randn((B, 4, 32), generator=g), **info)


def test_a_remat_step_matches_the_jax_trainer_with_remat(tmp_path):
    exp = _with(_experiment(tmp_path, **TRAINING), tpu={"remat": True})
    video = np.random.default_rng(6).uniform(0, 1, (B, T, RES, RES, 3)).astype(np.float32)
    jtr = JaxDecompTrainer(exp)
    jtr.setup_model(video)
    start = jax.device_get(jtr.params)  # the step donates its inputs
    keys = [jtr._rng(), jtr._rng()]
    noise = [_jax_noise(jtr.model, {"params": start}, B, k) for k in keys]
    state = (jtr.params, jtr.batch_stats, jtr.opt_state)
    jax_losses = []
    for k in keys:
        *state, values = jtr.train_step(*state, video, k)
        jax_losses.append(float(values["_total"]))

    tr = DecompTrainer(exp, device="cpu")
    tr.setup_model()
    assert tr.remat
    tr.model.load_state_dict(from_jax_params("savi", start))
    losses = [float(tr.train_step(torch.from_numpy(video), torch.from_numpy(n))["_total"])
              for n in noise]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
