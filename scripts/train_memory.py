"""Activation memory of one UNet training step, counted on the CPU and
extrapolated to 512².

The forward of ``train.make_train_step``'s loss runs at the registry
model's full width on a small square clip (the model's resolution-keyed
modules, attention and VSR++, scaled with it), under a
``saved_tensors_hooks`` that records the bytes of every distinct storage
autograd keeps for the backward. Two sizes fit bytes = a + b·S², read at
S = 512. Training state (float32 parameters, gradients, AdamW moments, one
EMA stream) is counted from the parameters.

With ``--use-checkpoint`` the model remats its blocks
(``models.common.checkpointed``, non-reentrant ``torch.utils.checkpoint``).
A hook outside a checkpointed region does not see what the region saves:
the region keeps only its inputs, for the recompute. So each region is run
here WITHOUT checkpointing, under a hook of its own that counts what it
saves, and its output is detached before the step goes on:

- ``saved`` is what the step keeps between forward and backward: the
  storages saved outside the regions and every region's inputs;
- ``recompute`` is the largest single region's own saved bytes, which its
  recompute holds during the backward on top of ``saved`` (an upper bound:
  a region's inputs are counted in both).

    python3 scripts/train_memory.py --frames 5 --sizes 64,128
    python3 scripts/train_memory.py --model blur_unet --use-checkpoint

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
    get_named_beta_schedule, make_diffusion, make_task_diffusion,
    training_losses)
from flair_tpu_torch.models import adm, sr3  # noqa: E402
from flair_tpu_torch.models.registry import get_model  # noqa: E402
from flair_tpu_torch.pipeline.wrappers import (  # noqa: E402
    wrap_bicubic_train, wrap_blur_train)


def tensors_in(obj):
    """Every tensor in nested tuples / lists / dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from tensors_in(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from tensors_in(o)


def record(storages, t):
    st = t.untyped_storage()
    storages[st.data_ptr()] = st.nbytes()


def build(name: str, size: int, use_checkpoint: bool):
    """(model, diffusion, training wrapper) of the registry model with its
    resolution-keyed modules scaled to ``size``."""
    if name == "bicubic_unet":
        model = get_model(name, dtype=torch.bfloat16, image_size=size,
                          attn_res=(size // 8, size // 16),
                          vsrpp_res=(size, size // 2),
                          use_checkpoint=use_checkpoint)
        d = make_diffusion(get_named_beta_schedule("face_bicubic", 2000),
                           device="cpu")
        return model, d, wrap_bicubic_train(d, model)
    # attention and VSR++ are keyed by the downsampling factor: the same
    # sites at any size
    model = get_model(name, dtype=torch.bfloat16, image_size=size,
                      use_checkpoint=use_checkpoint)
    d = make_task_diffusion("gaussian", "1000", device="cpu")
    return model, d, wrap_blur_train(d, model)


def saved_bytes(name: str, size: int, frames: int, use_checkpoint: bool):
    """(bytes kept for the backward, the largest region's recompute bytes,
    parameters) at ``size``²."""
    model, d, apply = build(name, size, use_checkpoint)
    params = dict(model.named_parameters())
    x = torch.rand(1, frames, size, size, 3) * 2 - 1
    storages, regions = {}, []

    def pack(t):
        record(storages, t)
        return t

    def measured(module, *args, **kwargs):
        """A checkpointed region as the measurement sees it: its inputs
        kept, its own saved bytes counted apart, its output detached."""
        if not torch.is_grad_enabled():
            return module(*args, **kwargs)
        for t in tensors_in((args, kwargs)):
            record(storages, t)
        inner = {}

        def pack_inner(t):
            record(inner, t)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack_inner, lambda t: t):
            out = module(*args, **kwargs)
        regions.append(sum(inner.values()))
        return out.detach().requires_grad_(True)

    saved_fns = adm.checkpointed, sr3.checkpointed
    adm.checkpointed = sr3.checkpointed = measured
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            training_losses(
                d, lambda x_t, t_b: apply(params, x_t,
                                          t_b[:, None].expand(1, frames),
                                          {"low_res_input": x}),
                x, torch.tensor([500]), torch.Generator().manual_seed(0))
    finally:
        adm.checkpointed, sr3.checkpointed = saved_fns
    return (sum(storages.values()), max(regions, default=0),
            sum(p.numel() for p in params.values()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="bicubic_unet",
                    choices=("bicubic_unet", "blur_unet"))
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--sizes", default="64,128")
    ap.add_argument("--use-checkpoint", action="store_true")
    args = ap.parse_args()
    s0, s1 = (int(v) for v in args.sizes.split(","))
    (b0, r0, n), (b1, r1, _) = (
        saved_bytes(args.model, s, args.frames, args.use_checkpoint)
        for s in (s0, s1))
    gib = 2 ** 30

    def at_512(v0, v1):
        return (v0 + (v1 - v0) / (s1 ** 2 - s0 ** 2) * (512 ** 2 - s0 ** 2)
                ) / gib

    print(json.dumps({
        "model": args.model, "frames": args.frames, "sizes": [s0, s1],
        "use_checkpoint": args.use_checkpoint,
        "saved_gib": [b0 / gib, b1 / gib],
        "saved_gib_at_512": at_512(b0, b1),
        "recompute_gib_at_512": at_512(r0, r1),
        "params_m": n / 1e6,
        # float32 parameters, gradients, two AdamW moments, one EMA stream
        "train_state_gib": 5 * 4 * n / gib}))


if __name__ == "__main__":
    main()
