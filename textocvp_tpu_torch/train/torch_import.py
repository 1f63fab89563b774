"""
Reader of the reference's PyTorch checkpoints (``SAVi_CATER.pth``,
``TextOCVP_CATER.pth``, ``ExtendedDINOSAUR_CLIPort.pth``,
``TextOCVP_CLIPort.pth``) for the port (counterpart of the JAX package's
``textocvp_tpu/train/torch_import.py``, whose numpy converters it copies).

A reference state dict converts first into the JAX package's params tree
(and ``batch_stats``), then through ``convert.from_jax_params`` into the
port's state dict, which loads strictly into the port's model. The rules:

* Linear:     kernel = weight.T
* Conv2d:     kernel = weight.transpose(2, 3, 1, 0)  (OIHW -> HWIO)
* LayerNorm:  scale = weight
* GRUCell:    torch packs the gates' rows [r; z; n] in weight_ih / weight_hh
  and carries two biases; the JAX tree has ir / iz / in with biases, hr / hz
  without, and hn with one. They fold as ir.bias = b_ir + b_hr and
  iz.bias = b_iz + b_hz (both gates add the biases outside any product),
  in.bias = b_in and hn.bias = b_hn (the hidden bias sits inside the r * term);
  the port's ``GRUCell`` holds the same leaves (``bias_ih``, ``bias_hn``).
* torch.nn.MultiheadAttention: in_proj_weight splits into thirds (q, k, v).
* BatchNorm:  weight / bias -> scale / bias; running statistics -> batch_stats.
* A predictor checkpoint without the ``predictor.`` prefix (an older layout)
  gets it.
* The timm ViT's ``pos_embed`` is resampled to the model's patch grid
  (``nn/vit.py::interpolate_pos_embed``).
"""

from __future__ import annotations

import numpy as np

from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.nn.t5 import import_hf_t5_encoder, t5_config
from textocvp_tpu_torch.nn.vit import VIT_CONFIGS, import_timm_state_dict


def load_torch_state_dict(path) -> dict:
    """A reference ``.pth`` checkpoint's model state dict as numpy arrays: the
    ``model_state_dict`` entry when there is one, ``module.`` prefixes
    (``DataParallel``) stripped. The file is unpickled in full, as a
    checkpoint that also holds its optimizer and scheduler states needs:
    read only files you trust."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("model_state_dict", blob) if isinstance(blob, dict) else blob
    return {k.removeprefix("module."): (v.detach().cpu().numpy() if hasattr(v, "detach")
                                        else np.asarray(v))
            for k, v in sd.items()}


def _linear(sd, prefix, bias=True):
    p = {"kernel": sd[f"{prefix}.weight"].T}
    if bias and f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _conv(sd, prefix):
    p = {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _gru(sd, prefix):
    w_ih = sd[f"{prefix}.weight_ih"]  # (3D, D) rows [r; z; n]
    w_hh = sd[f"{prefix}.weight_hh"]
    b_ih = sd[f"{prefix}.bias_ih"]
    b_hh = sd[f"{prefix}.bias_hh"]
    d = w_ih.shape[1]
    wr, wz, wn = w_ih[:d], w_ih[d:2 * d], w_ih[2 * d:]
    ur, uz, un = w_hh[:d], w_hh[d:2 * d], w_hh[2 * d:]
    br, bz, bn = b_ih[:d], b_ih[d:2 * d], b_ih[2 * d:]
    hbr, hbz, hbn = b_hh[:d], b_hh[d:2 * d], b_hh[2 * d:]
    return {
        "ir": {"kernel": wr.T, "bias": br + hbr},
        "iz": {"kernel": wz.T, "bias": bz + hbz},
        "in": {"kernel": wn.T, "bias": bn},
        "hr": {"kernel": ur.T},
        "hz": {"kernel": uz.T},
        "hn": {"kernel": un.T, "bias": hbn},
    }


def _bn(sd, prefix):
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
    return params, stats


def _mhsa(sd, prefix):
    """Reference MetaAttention (bias-free q/k/v/out_projection.0)."""
    return {
        "q": _linear(sd, f"{prefix}.q", bias=False),
        "k": _linear(sd, f"{prefix}.k", bias=False),
        "v": _linear(sd, f"{prefix}.v", bias=False),
        "out": _linear(sd, f"{prefix}.out_projection.0", bias=False),
    }


def _torch_mha(sd, prefix):
    """torch.nn.MultiheadAttention (packed in_proj, biased)."""
    w = sd[f"{prefix}.in_proj_weight"]
    b = sd[f"{prefix}.in_proj_bias"]
    d = w.shape[1]
    return {
        "q": {"kernel": w[:d].T, "bias": b[:d]},
        "k": {"kernel": w[d:2 * d].T, "bias": b[d:2 * d]},
        "v": {"kernel": w[2 * d:].T, "bias": b[2 * d:]},
        "out": _linear(sd, f"{prefix}.out_proj"),
    }


def _torch_encoder_layer(sd, prefix):
    """torch.nn.TransformerEncoderLayer -> TorchStyleEncoderLayer params."""
    return {
        "self_attn": _torch_mha(sd, f"{prefix}.self_attn"),
        "linear1": _linear(sd, f"{prefix}.linear1"),
        "linear2": _linear(sd, f"{prefix}.linear2"),
        "norm1": _ln(sd, f"{prefix}.norm1"),
        "norm2": _ln(sd, f"{prefix}.norm2"),
    }


def _transformer_block(sd, prefix):
    """Reference TransformerBlock (attention.py:323-396)."""
    return {
        "attn": _mhsa(sd, f"{prefix}.attn"),
        "mlp": {"Dense_0": _linear(sd, f"{prefix}.mlp.0"),
                "Dense_1": _linear(sd, f"{prefix}.mlp.2")},
        "ln_query": _ln(sd, f"{prefix}.layernorm_query"),
        "ln_mlp": _ln(sd, f"{prefix}.layernorm_mlp"),
    }


def _slot_attention(sd, prefix):
    return {
        "norm_input": _ln(sd, f"{prefix}.norm_input"),
        "norm_slot": _ln(sd, f"{prefix}.norm_slot"),
        "norm_mlp": _ln(sd, f"{prefix}.norm_mlp"),
        "to_q": _linear(sd, f"{prefix}.to_q"),
        "to_k": _linear(sd, f"{prefix}.to_k"),
        "to_v": _linear(sd, f"{prefix}.to_v"),
        "gru": _gru(sd, f"{prefix}.gru"),
        "mlp": {"Dense_0": _linear(sd, f"{prefix}.mlp.0"),
                "Dense_1": _linear(sd, f"{prefix}.mlp.2")},
    }


def _initializer(sd, prefix):
    p = {}
    if f"{prefix}.slots_mu" in sd:
        p["slots_mu"] = sd[f"{prefix}.slots_mu"]
        p["slots_sigma"] = sd[f"{prefix}.slots_sigma"]
    elif f"{prefix}.slots" in sd:
        p["slots"] = sd[f"{prefix}.slots"].reshape(sd[f"{prefix}.slots"].shape[-2:])
    return p


def _conv_block(sd, prefix, batch_norm: bool, stats: dict, name: str) -> dict:
    """A reference ``ConvBlock`` (``block.0`` the conv, ``block.1`` its
    BatchNorm) -> its params; the BatchNorm's running statistics go into
    ``stats[name]``."""
    p = {"Conv_0": _conv(sd, f"{prefix}.block.0")}
    if batch_norm:
        p["BatchNorm_0"], bn_stats = _bn(sd, f"{prefix}.block.1")
        stats[name] = {"BatchNorm_0": bn_stats}
    return p


def convert_savi(sd: dict, model_params: dict) -> dict:
    """Reference SAVi state dict -> our SAVi flax params (and the
    ``batch_stats`` of a ``batch_norm`` encoder or decoder, whose blocks
    hold the BatchNorm at ``block.1``; the JAX importer reads the convs
    only). The encoder must be the reference's ``ConvEncoder``, the one
    layout the importers know: the reference wires no ``ResNet`` into its
    SAVi, and an encoder without ``num_channels`` (``ResNet``,
    ``ConvEncoder128``) raises here, naming it, where the JAX importer
    fails on the missing key."""
    enc = model_params["encoder"]
    if enc["encoder_name"] != "ConvEncoder":
        raise NotImplementedError(
            f"a reference SAVi checkpoint with encoder {enc['encoder_name']!r}: the importer "
            "reads the reference's ConvEncoder only (the JAX package's importer cannot read "
            "this one either); train it with the port, or import a JAX .msgpack")
    enc_params = enc["encoder_params"]
    dec_params = model_params["decoder"]["decoder_params"]
    num_enc = len(enc_params["num_channels"])
    num_dec = len(dec_params["num_channels"])
    upsample = dec_params.get("upsample") or 1
    stats = {"image_encoder": {}, "image_decoder": {}}

    # encoder: Sequential of ConvBlocks
    image_encoder = {
        f"ConvBlock_{i}": _conv_block(sd, f"encoder.encoder.{i}",
                                      bool(enc_params.get("batch_norm")),
                                      stats["image_encoder"], f"ConvBlock_{i}")
        for i in range(num_enc)
    }

    # decoder: ConvBlocks interleaved with Upsample modules, then a final conv
    image_decoder = {}
    seq_idx = 0
    for i in range(num_dec - 1, -1, -1):
        name = f"ConvBlock_{num_dec - 1 - i}"
        image_decoder[name] = _conv_block(sd, f"decoder.decoder.{seq_idx}",
                                          bool(dec_params.get("batch_norm")),
                                          stats["image_decoder"], name)
        seq_idx += 1
        if upsample >= 2 and i > 0:
            seq_idx += 1  # Upsample module holds no params
    image_decoder["Conv_0"] = _conv(sd, f"decoder.decoder.{seq_idx}")

    params = {
        "slot_initializer": _initializer(sd, "initializer"),
        "transition": _transformer_block(sd, "transition_module"),
        "image_encoder": image_encoder,
        "encoder_pos_embedding": {"Dense_0": {
            "kernel": sd["encoder_pos_embedding.projection.weight"][:, :, 0, 0].T,
            "bias": sd["encoder_pos_embedding.projection.bias"],
        }},
        "encoder_ln": _ln(sd, "encoder_mlp.0"),
        "encoder_mlp": {"Dense_0": _linear(sd, "encoder_mlp.1"),
                        "Dense_1": _linear(sd, "encoder_mlp.3")},
        "decoder_pos_embedding": {"Dense_0": {
            "kernel": sd["decoder_pos_embedding.projection.weight"][:, :, 0, 0].T,
            "bias": sd["decoder_pos_embedding.projection.bias"],
        }},
        "image_decoder": image_decoder,
        "slot_attention": _slot_attention(sd, "slot_attention"),
    }
    out = {"params": params}
    batch_stats = {k: v for k, v in stats.items() if v}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def convert_patch_decoder(sd: dict, dp: dict, img_size: int,
                          prefix: str = "decoder.") -> tuple:
    """Reference MLPPatchDecoder state dict (keys under ``prefix``) -> our
    flax patch_decoder params + batch_stats subtree (reference
    decoders.py:264-365). Shared by the full ExtendedDINOSAUR converter and
    standalone-parity tests."""
    num_layers = dp.get("num_layers", 4)
    mlp_idx = 1 if dp.get("initial_layer_norm") else 0
    patch_decoder = {"pos_embed": sd[f"{prefix}pos_embed"]}
    if dp.get("initial_layer_norm"):
        patch_decoder["initial_ln"] = _ln(sd, f"{prefix}mlp.0")
    seq = mlp_idx
    for i in range(num_layers):
        patch_decoder[f"mlp_{i}"] = _linear(sd, f"{prefix}mlp.{seq}")
        seq += 2  # skip the ReLU

    batch_stats: dict = {}
    if dp.get("reconstruct_images"):
        num_cnn = dp.get("num_layers_cnn", 4)
        bs_tree = {}
        seq_idx = 0
        current = int(dp["num_patches"] ** 0.5)
        patch_size = dp["patch_size"]
        for i in range(num_cnn):
            conv = _conv(sd, f"{prefix}conv_patch_decoder.{seq_idx}.block.0")
            bn_p, bn_s = _bn(sd, f"{prefix}conv_patch_decoder.{seq_idx}.block.1")
            patch_decoder[f"cnn_{i}"] = {"Conv_0": conv, "BatchNorm_0": bn_p}
            bs_tree[f"cnn_{i}"] = {"BatchNorm_0": bn_s}
            seq_idx += 1
            if ((i + 1) * 2 < patch_size) and (current < img_size):
                seq_idx += 1  # Upsample
                current *= 2
        patch_decoder["cnn_final"] = _conv(
            sd, f"{prefix}conv_patch_decoder.{seq_idx}")
        batch_stats = {"patch_decoder": bs_tree}
    return patch_decoder, batch_stats


def convert_extended_dinosaur(sd: dict, model_params: dict) -> dict:
    """Reference ExtendedDINOSAUR state dict -> our flax params + batch_stats."""
    cfg = VIT_CONFIGS[model_params["encoder"]["encoder_name"]]
    enc_params = model_params["encoder"].get("encoder_params", {})
    # nn/encoders.py::get_encoder's precedence, so that the converted ViT has
    # the depth the model is built with
    depth = (enc_params.get("num_blocks") or enc_params.get("encoder_num_blocks")
             or cfg["depth"])
    vit_sd = {k[len("encoder.vit_backbone."):]: v for k, v in sd.items()
              if k.startswith("encoder.vit_backbone.")}
    image_encoder = import_timm_state_dict(
        vit_sd, grid_size=model_params["img_size"] // cfg["patch_size"], depth=depth,
        layerscale=cfg.get("layerscale_init") is not None)

    patch_decoder, batch_stats = convert_patch_decoder(
        sd, model_params["decoder"]["decoder_params"], model_params["img_size"])

    params = {
        "slot_initializer": _initializer(sd, "initializer"),
        "transition": _transformer_block(sd, "transition_module"),
        "image_encoder": image_encoder,
        "feat_proj_ln": _ln(sd, "linear_feat_proj.0"),
        "feat_proj_mlp": {"Dense_0": _linear(sd, "linear_feat_proj.1"),
                          "Dense_1": _linear(sd, "linear_feat_proj.3")},
        "patch_decoder": patch_decoder,
        "slot_attention": _slot_attention(sd, "slot_attention"),
    }
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def _custom_text_encoder(sd, prefix, num_layers):
    p = {
        "token_embedding": {"embedding": sd[f"{prefix}.token_embedding.weight"]},
        "position_embedding": {"embedding": sd[f"{prefix}.position_embedding.weight"]},
        "ln_in": _ln(sd, f"{prefix}.layer_norm"),
        "ln_out": _ln(sd, f"{prefix}.text_out_projection.0"),
        "out_projection": _linear(sd, f"{prefix}.text_out_projection.1"),
    }
    for i in range(num_layers):
        p[f"layer_{i}"] = _torch_encoder_layer(sd, f"{prefix}.transformer.layers.{i}")
    return p


def _adapted_encoder_block(sd, prefix):
    return {
        "ln_query": _ln(sd, f"{prefix}.layernorm_query"),
        "ln_mlp": _ln(sd, f"{prefix}.layernorm_mlp"),
        "attn": _mhsa(sd, f"{prefix}.attn"),
        "mlp": {"Dense_0": _linear(sd, f"{prefix}.mlp.0"),
                "Dense_1": _linear(sd, f"{prefix}.mlp.2")},
        "cross_attention": {
            "ln_q": _ln(sd, f"{prefix}.cross_attention.ln_cross_att_q"),
            "ln_kv": _ln(sd, f"{prefix}.cross_attention.ln_cross_att_kv"),
            "ln_mlp": _ln(sd, f"{prefix}.cross_attention.ln_mlp"),
            "cross_attn": {
                "q": _linear(sd, f"{prefix}.cross_attention.cross_attn.q", bias=False),
                "k": _linear(sd, f"{prefix}.cross_attention.cross_attn.k", bias=False),
                "v": _linear(sd, f"{prefix}.cross_attention.cross_attn.v", bias=False),
                "out": _linear(sd, f"{prefix}.cross_attention.cross_attn.out_projection"),
            },
            "mlp": {"Dense_0": _linear(sd, f"{prefix}.cross_attention.mlp.0"),
                    "Dense_1": _linear(sd, f"{prefix}.cross_attention.mlp.2")},
        },
    }


def convert_predictor(sd: dict, exp_params: dict) -> dict:
    """Reference predictor checkpoint (PredictorWrapper state) -> our
    PredictorWrapper flax params. Handles the legacy-key shim: old checkpoints
    lack the 'predictor.' wrapper prefix (reference setup_model.py:214-221)."""
    if not any(k.startswith("predictor.") for k in sd):
        sd = {f"predictor.{k}": v for k, v in sd.items()}

    name = exp_params["predictor"]["predictor_name"]
    pp = exp_params["predictor"]["predictor_params"]

    if name in ("TextOCVP_CustomTF", "TextOCVP_T5"):
        inner_pp = pp.get("predictor_params", {})
        num_layers = inner_pp.get("num_layers", 8)
        p = {
            "mlp_in": _linear(sd, "predictor.mlp_in"),
            "mlp_out": _linear(sd, "predictor.mlp_out"),
            "pe": {"pe": sd["predictor.pe.pe"].reshape(
                sd["predictor.pe.pe"].shape[1], sd["predictor.pe.pe"].shape[3])},
        }
        for i in range(num_layers):
            p[f"block_{i}"] = _adapted_encoder_block(sd, f"predictor.predictor.{i}")
        if name == "TextOCVP_CustomTF":
            tep = pp.get("text_encoder_params", {})
            p["text_encoder"] = _custom_text_encoder(
                sd, "predictor.text_encoder", tep.get("num_layers", 2))
        else:
            t5_sd = {k[len("predictor.text_encoder."):]: v for k, v in sd.items()
                     if k.startswith("predictor.text_encoder.")}
            p["text_encoder"] = import_hf_t5_encoder(
                t5_sd, t5_config(pp.get("text_encoder_params")))
        return {"params": {"predictor": p}}

    if name in ("VanillaTransformer", "OCVPSeq", "OCVPPar"):
        num_layers = pp.get("num_layers", 2)
        p = {
            "mlp_in": _linear(sd, "predictor.mlp_in"),
            "mlp_out": _linear(sd, "predictor.mlp_out"),
        }
        for i in range(num_layers):
            pre = f"predictor.transformer_encoders.{i}"
            if name == "VanillaTransformer":
                p[f"layer_{i}"] = _torch_encoder_layer(sd, pre)
            elif name == "OCVPSeq":
                p[f"layer_{i}"] = {
                    "object_block": _torch_encoder_layer(sd, f"{pre}.object_encoder_block"),
                    "time_block": _torch_encoder_layer(sd, f"{pre}.time_encoder_block"),
                }
            else:  # OCVPPar
                p[f"layer_{i}"] = {
                    "norm1": _ln(sd, f"{pre}.norm1"),
                    "norm2": _ln(sd, f"{pre}.norm2"),
                    "self_attn_obj": _torch_mha(sd, f"{pre}.self_attn_obj"),
                    "self_attn_time": _torch_mha(sd, f"{pre}.self_attn_time"),
                    "linear1": _linear(sd, f"{pre}.linear1"),
                    "linear2": _linear(sd, f"{pre}.linear2"),
                }
        return {"params": {"predictor": p}}

    raise NameError(f"Unknown predictor {name!r} for torch import")


def convert_state_dict(sd: dict, exp_params: dict, kind: str) -> dict:
    """A reference state dict (numpy) -> the JAX package's ``{"params",
    "batch_stats"}``. ``kind`` is "decomp" or "predictor"."""
    if kind == "decomp":
        name = exp_params["model"]["model_name"]
        mp = exp_params["model"]["model_params"]
        if name == "SAVi":
            state = convert_savi(sd, mp)
        elif name == "ExtendedDINOSAUR":
            state = convert_extended_dinosaur(sd, mp)
        else:
            raise NameError(f"Unknown decomposition model {name!r} for torch import")
    elif kind == "predictor":
        state = convert_predictor(sd, exp_params)
    else:
        raise ValueError(f"kind must be 'decomp'|'predictor', got {kind!r}")
    return {"params": state["params"], "batch_stats": state.get("batch_stats", {})}


def jax_kind(exp_params: dict, kind: str) -> str:
    """The ``convert.from_jax_params`` kind of an experiment's model
    ("decomp") or predictor ("predictor")."""
    if kind == "predictor":
        return "predictor"
    return "dinosaur" if exp_params["model"]["model_name"] == "ExtendedDINOSAUR" else "savi"


def import_checkpoint(path, exp_params: dict, kind: str) -> dict:
    """A reference ``.pth`` -> the port's state dict of the experiment's model
    (``kind`` "decomp") or predictor ("predictor")."""
    state = convert_state_dict(load_torch_state_dict(path), exp_params, kind)
    return from_jax_params(jax_kind(exp_params, kind), state["params"],
                           batch_stats=state["batch_stats"])
