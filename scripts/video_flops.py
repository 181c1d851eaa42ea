"""FLOP counts of one forward of the port's video models at the shapes
``chip_smoke.py`` drives them: AMT-G and SuperSloMo on one 512² pair at
factor 2 (``interp_full``), DAVSRNet at the registry defaults on a 3-frame
64² clip (``davsr_full``).

The models run on the ``meta`` device under
``torch.utils.flop_counter.FlopCounterMode``: shapes only, nothing is
computed, so the full sizes count in seconds on the CPU. K1 (the DCN
kernel, ``ops.dcn.deform_conv2d_raw``) has no meta version: here it is
replaced by an empty output of its shape and counted from that shape,
2·B·H·W·9·Cin·Cout a launch, as ``chip_smoke.dcn_bound_ms`` counts it.

    python3 scripts/video_flops.py

Prints one JSON line: GFLOP by model and by operation.
"""

from __future__ import annotations

import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flair_tpu_torch.models import vsrpp  # noqa: E402
from flair_tpu_torch.models.amt import interpolate  # noqa: E402
from flair_tpu_torch.models.registry import get_model  # noqa: E402

INTERP_SIZE = 512
DAVSR_T, DAVSR_SIZE = 3, 64


def count(fn) -> dict:
    """GFLOP of ``fn()`` by aten operation, plus K1 launches and GFLOP."""
    k1 = {"launches": 0, "flop": 0.0}

    def dcn_shape_only(x, res_y, res_x, mask_logits, flow_y, flow_x, weight,
                       bias, mrm):
        b, h, w, cin = x.shape
        cout = weight.shape[0]
        k1["launches"] += 1
        k1["flop"] += 2.0 * b * h * w * 9 * cin * cout
        return x.new_empty((b, h, w, cout))

    real = vsrpp.deform_conv2d_raw
    vsrpp.deform_conv2d_raw = dcn_shape_only
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            fn()
    finally:
        vsrpp.deform_conv2d_raw = real
    out = {str(k).replace("aten.", ""): v / 1e9
           for k, v in fc.get_flop_counts()["Global"].items()}
    out["dcn_raw (K1)"] = k1["flop"] / 1e9
    out["total"] = sum(out.values())
    out["k1_launches"] = k1["launches"]
    return out


def main() -> int:
    meta = torch.device("meta")
    pair = torch.zeros((1, INTERP_SIZE, INTERP_SIZE, 3), device=meta)
    clip = torch.zeros((1, DAVSR_T, DAVSR_SIZE, DAVSR_SIZE, 3), device=meta)
    amt = get_model("amt").to(meta).eval()
    slomo = get_model("superslomo").to(meta).eval()
    davsr = get_model("davsr").to(meta).eval()
    rec = {"amt_g_512_factor2": count(lambda: interpolate(amt, pair, pair,
                                                          2)),
           "superslomo_512_factor2": count(lambda: slomo(pair, pair)),
           "davsr_3x64": count(lambda: davsr(clip))}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
