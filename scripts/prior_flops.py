"""FLOP counts of one forward of the port's alternative face models at the
shape ``chip_smoke.py``'s ``priors_full`` drives them: each registered
model at its registry defaults on one 512² image (VQFR, RestoreFormer,
VQVAEGAN, BiSeNet, YOLOv5-face).

The models run on the ``meta`` device under
``torch.utils.flop_counter.FlopCounterMode``: shapes only, nothing is
computed, so the full sizes count in seconds on the CPU. VQFR's deformable
convs are the plain ``ops/deform.py`` (gathers, then one matmul over
(group, tap, channel)); their matmul FLOPs count as ``bmm`` / ``mm``, and
the script adds up, for each launch, the corner samples the gathers write
(B·H·W·G·9·Cin/G values a corner, four corners) under ``dcn_plain``.

    python3 scripts/prior_flops.py

Prints one JSON line: GFLOP by model and by operation.
"""

from __future__ import annotations

import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flair_tpu_torch.models import vqfr  # noqa: E402
from flair_tpu_torch.models.registry import get_model  # noqa: E402

SIZE = 512
MODELS = ("vqfr", "restoreformer", "vqvaegan", "bisenet", "yolov5face")


def count(fn) -> dict:
    """GFLOP of ``fn()`` by aten operation, plus the plain DCN's launches,
    its contraction GFLOP and the corner samples it gathers (millions)."""
    dcn = {"launches": 0, "gflop": 0.0, "corner_samples_m": 0.0}
    real = vqfr.modulated_deform_conv2d

    def counted(x, offset, mask, weight, bias=None, **kw):
        b, h, w, cin = x.shape
        cout = weight.shape[0]
        dcn["launches"] += 1
        dcn["gflop"] += 2.0 * b * h * w * 9 * cin * cout / 1e9
        dcn["corner_samples_m"] += 4.0 * b * h * w * 9 * cin / 1e6
        return real(x, offset, mask, weight, bias, **kw)

    vqfr.modulated_deform_conv2d = counted
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            fn()
    finally:
        vqfr.modulated_deform_conv2d = real
    out = {str(k).replace("aten.", ""): v / 1e9
           for k, v in fc.get_flop_counts()["Global"].items()}
    out["total"] = sum(out.values())
    out["dcn_plain"] = dcn
    return out


def main() -> int:
    meta = torch.device("meta")
    x = torch.zeros((1, 3, SIZE, SIZE), device=meta)
    rec = {}
    for name in MODELS:
        model = get_model(name).to(meta).eval()
        rec[f"{name}_{SIZE}"] = count(lambda: model(x))
        rec[f"{name}_{SIZE}"]["params_m"] = sum(
            p.numel() for p in model.parameters()) / 1e6
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
