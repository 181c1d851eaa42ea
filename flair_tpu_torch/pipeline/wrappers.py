"""Denoiser wrappers: spaced step → model conditioning.

Counterpart of ``flair_tpu/pipeline/wrappers.py`` (respace._WrappedModel,
respace.py:138-167): the sampler hands the spaced step t;
- the BicubicUNet receives the noise level ``sqrt_alphas_cumprod_prev[t+1]``;
- the BlurUNet receives ``scale_timesteps(map_timesteps(t))``, the
  original-schedule index, as int64 for every frame.

Each wrapper carries ``.flows_fn(rnn_input)`` — the SPyNet flows, computed
once per window — and ``.model``.
"""

from __future__ import annotations

import torch

from ..diffusion.gaussian import (
    Diffusion, map_timesteps, scale_timesteps, sr3_noise_level)


def _wrap(model, cond, enable_cross_frames: bool):
    def apply(x, t, low_res, rnn_input, vsrpp_weights, flows=None):
        return model(x, cond(t, x), low_res, rnn_input=rnn_input,
                     enable_cross_frames=enable_cross_frames,
                     vsrpp_weights=vsrpp_weights, flows=flows)

    def flows_fn(rnn_input):
        return model.compute_flows(rnn_input, enable_cross_frames)

    apply.flows_fn = flows_fn
    apply.model = model
    return apply


def wrap_bicubic_model(d: Diffusion, model, *, enable_cross_frames: bool = True):
    """``apply(x, t, low_res, rnn_input, vsrpp_weights, flows=None) → eps``
    for a BicubicUNet, all tensors (B, T, H, W, 3)."""

    def cond(t, x):
        return sr3_noise_level(d, t).to(x.device).expand(x.shape[0], x.shape[1])

    return _wrap(model, cond, enable_cross_frames)


def wrap_blur_model(d: Diffusion, model, *, enable_cross_frames: bool = True):
    """``apply(x, t, low_res, rnn_input, vsrpp_weights, flows=None) →
    (eps, variance fraction)`` (B, T, H, W, 6) for a BlurUNet."""

    def cond(t, x):
        t_orig = scale_timesteps(d, map_timesteps(d, t))
        return t_orig.to(device=x.device, dtype=torch.int64).expand(
            x.shape[0], x.shape[1])

    return _wrap(model, cond, enable_cross_frames)
