#!/usr/bin/env python3
"""How far an int8 CLIPort reply moves when the service's rows run one at a
time, as each rank of a ``data=2`` mesh runs its row, on one NVIDIA GPU.

    python3 chip_int8_rows_probe.py

Builds ``chip_smoke.py``'s CLIPort serving experiment (ExtendedDINOSAUR +
TextOCVP_T5 at full width, random weights from the seed) twice, in float32
and with ``tpu.decode_quant`` and ``tpu.encode_quant`` int8, and answers one
2-row request with each (the int8 service calibrates on it). Then, with the
same noise, captions and scales, it runs the two rows together and one at a
time and prints one JSON line a service:

- ``feats_err``: the ViT's features (int8 or float), both rows against each
  row alone;
- ``slots_err``: the predicted slots (the encode, slot attention and the
  rollout), the same;
- ``decode_same_slots_err``: the decode of the 2-row slots, together and a
  row at a time;
- ``reply_rowwise_err``: the decode of the slots computed together against
  the decode of those computed a row at a time: what the data axis changes
  in a reply;
- ``reply_max``: the reply's largest value. All errors are max abs, the
  replies' in [0, 1].

It prints the card's name and power limit first. The check of the ``data=2``
int8 service in ``chip_smoke.py`` (``MESH_INT8_DECODE_SCALES_RTOL``) rests on
these numbers.
"""

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_int8_rows_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from textocvp_tpu_torch.data.wire import as_float_video

    tmp = Path(tempfile.mkdtemp(prefix="int8_rows_"))
    cs.write_experiment(tmp / "clipport", *cs.full_width_params(cs.PATHS[1]))
    spec = {"clip_exp": str(cs.clip_int8_experiment(tmp / "clipport" / "exp")), "device": "cuda"}
    frames, caps = cs._mesh_request(cs.CLIP_MESH_BATCH, "clip_exp")
    for pred in (cs.PRED_NAME, cs.CLIP_INT8_NAME):
        svc = cs._mesh_service(spec, cs.CLIP_MESH_BATCH, float_reply=True, exp="clip_exp",
                               pred=pred)
        state = svc.generator.get_state()
        svc.predict(frames, caps)  # the int8 service calibrates here
        svc.generator.set_state(state)
        noise = svc._draw_noise(len(caps))
        text = {k: torch.from_numpy(v).cuda() for k, v in svc._tokenize(caps).items()}
        videos = torch.from_numpy(frames).cuda()
        rows = range(len(caps))
        enc = svc.predict_module.encode_scales
        with torch.inference_mode():
            s2 = svc.predict_module(videos, noise, text)
            s1 = torch.cat([svc.predict_module(videos[i:i + 1], noise[i:i + 1],
                                               {k: v[i:i + 1] for k, v in text.items()})
                            for i in rows])
            seed = as_float_video(videos)
            f2 = svc.model.frozen_features(seed, enc)
            f1 = torch.cat([svc.model.frozen_features(seed[i:i + 1], enc) for i in rows])
            d2 = svc.decode_module(s2) / 255
            d1 = torch.cat([svc.decode_module(s2[i:i + 1]) for i in rows]) / 255
            dx = svc.decode_module(s1) / 255
        print(json.dumps({"service": "int8" if pred == cs.CLIP_INT8_NAME else "float32",
                          "feats_err": float((f2 - f1).abs().max()),
                          "slots_err": float((s2 - s1).abs().max()),
                          "slots_max": float(s2.abs().max()),
                          "decode_same_slots_err": float((d2 - d1).abs().max()),
                          "reply_rowwise_err": float((d2 - dx).abs().max()),
                          "reply_max": float(d2.abs().max())}), flush=True)
        del svc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
