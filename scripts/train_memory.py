"""Activation memory of one BicubicUNet training step, counted on the CPU
and extrapolated to 512².

The forward of ``train.make_train_step``'s loss runs at the registry
model's full width on a small square clip (the model's resolution-keyed
modules, attention and VSR++, scaled with it), under a
``saved_tensors_hooks`` that records the bytes of every distinct storage
autograd keeps for the backward. Two sizes fit bytes = a + b·S², read at
S = 512. Training state (float32 parameters, gradients, AdamW moments, one
EMA stream) is counted from the parameters.

    python3 scripts/train_memory.py --frames 5 --sizes 64,128

Prints one JSON line. Runs on the CPU; no card needed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flair_tpu_torch.diffusion import (  # noqa: E402
    get_named_beta_schedule, make_diffusion, training_losses)
from flair_tpu_torch.models.registry import get_model  # noqa: E402
from flair_tpu_torch.pipeline.wrappers import wrap_bicubic_train  # noqa: E402


def saved_bytes(size: int, frames: int) -> tuple[int, int]:
    """(bytes autograd keeps for the backward, parameters) at ``size``²."""
    model = get_model("bicubic_unet", dtype=torch.bfloat16, image_size=size,
                      attn_res=(size // 8, size // 16),
                      vsrpp_res=(size, size // 2))
    d = make_diffusion(get_named_beta_schedule("face_bicubic", 2000),
                       device="cpu")
    apply = wrap_bicubic_train(d, model)
    params = dict(model.named_parameters())
    x = torch.rand(1, frames, size, size, 3) * 2 - 1
    storages = {}

    def pack(t):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        training_losses(
            d, lambda x_t, t_b: apply(params, x_t,
                                      t_b[:, None].expand(1, frames),
                                      {"low_res_input": x}),
            x, torch.tensor([500]), torch.Generator().manual_seed(0))
    return sum(storages.values()), sum(p.numel() for p in params.values())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--sizes", default="64,128")
    args = ap.parse_args()
    s0, s1 = (int(v) for v in args.sizes.split(","))
    (b0, n), (b1, _) = saved_bytes(s0, args.frames), saved_bytes(s1, args.frames)
    slope = (b1 - b0) / (s1 ** 2 - s0 ** 2)
    at_512 = b0 + slope * (512 ** 2 - s0 ** 2)
    gib = 2 ** 30
    print(json.dumps({
        "frames": args.frames, "sizes": [s0, s1],
        "saved_gib": [b0 / gib, b1 / gib],
        "saved_gib_at_512": at_512 / gib,
        # float32 parameters, gradients, two AdamW moments, one EMA stream
        "train_state_gib": 5 * 4 * n / gib}))


if __name__ == "__main__":
    main()
