"""Denoiser wrappers: spaced step → model conditioning.

Counterpart of ``flair_tpu/pipeline/wrappers.py`` (respace._WrappedModel,
respace.py:138-167): the sampler hands the spaced step t;
- the BicubicUNet receives the noise level ``sqrt_alphas_cumprod_prev[t+1]``;
- the BlurUNet receives ``scale_timesteps(map_timesteps(t))``, the
  original-schedule index, as int64 for every frame.

Each denoiser wrapper carries ``.flows_fn(rnn_input)`` — the SPyNet flows,
computed once per window — and ``.model``.

``wrap_codeformer`` / ``wrap_parsenet`` turn the face models into the
``codeformer_apply`` / ``parsenet_apply`` callables of the face prior:
NHWC in the input's dtype in and out, NCHW in the model's dtype inside.
"""

from __future__ import annotations

import torch

from ..diffusion.gaussian import (
    Diffusion, map_timesteps, scale_timesteps, sr3_noise_level)
from ..utils.spans import span


def _wrap(model, cond, enable_cross_frames: bool):
    def apply(x, t, low_res, rnn_input, vsrpp_weights, flows=None):
        with span("denoiser"):
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


def wrap_bicubic_train(d: Diffusion, model):
    """``apply_fn(params, x_t, ts, batch) → eps`` for training a BicubicUNet
    with ``train.make_train_step``, as the JAX package trains it
    (``__graft_entry__.py:168-174``): the noise level
    ``sr3_noise_level(d, t)`` of each frame's t, ``batch["low_res_input"]``
    as the conditioning and ``batch["rnn_input"]`` (default: the
    conditioning) as SPyNet's input. ``params`` (name → tensor) stand in for
    the model's own, as ``model.apply(params, ...)`` does."""

    def apply(params, x_t, ts, batch):
        lvl = sr3_noise_level(d, ts.reshape(-1)).reshape(ts.shape)
        low = batch["low_res_input"]
        return torch.func.functional_call(
            model, params, (x_t, lvl, low),
            {"rnn_input": batch.get("rnn_input", low)})

    apply.model = model
    return apply


def wrap_blur_train(d: Diffusion, model):
    """``apply_fn(params, x_t, ts, batch) → (eps, variance fraction)``
    (B, T, H, W, 6) for training a BlurUNet with ``train.make_train_step``
    (LEARNED_RANGE: the loss adds the VB term): each frame's t as the
    original-schedule index ``scale_timesteps(map_timesteps(t))`` in int64,
    ``batch["low_res_input"]`` as the conditioning and ``batch["rnn_input"]``
    (default: the conditioning) as SPyNet's input, as ``restore_video``'s
    blur branch builds them. ``params`` stand in for the model's own.

    Both training wrappers hold under ``use_checkpoint``: the model's
    ``checkpointed`` blocks capture the tensors ``functional_call`` put in,
    so the backward's recompute runs on ``params`` too."""

    def apply(params, x_t, ts, batch):
        t_orig = scale_timesteps(d, map_timesteps(d, ts.reshape(-1)))
        t_orig = t_orig.to(torch.int64).reshape(ts.shape)
        low = batch["low_res_input"]
        return torch.func.functional_call(
            model, params, (x_t, t_orig, low),
            {"rnn_input": batch.get("rnn_input", low)})

    apply.model = model
    return apply


def wrap_blur_model(d: Diffusion, model, *, enable_cross_frames: bool = True):
    """``apply(x, t, low_res, rnn_input, vsrpp_weights, flows=None) →
    (eps, variance fraction)`` (B, T, H, W, 6) for a BlurUNet."""

    def cond(t, x):
        t_orig = scale_timesteps(d, map_timesteps(d, t))
        return t_orig.to(device=x.device, dtype=torch.int64).expand(
            x.shape[0], x.shape[1])

    return _wrap(model, cond, enable_cross_frames)


def wrap_codeformer(model):
    """``apply(faces (N, S, S, 3)) → restored faces`` for a CodeFormer,
    applied as the demo applies it, w = 1 with AdaIN
    (video_sample.py:450-452)."""

    def apply(faces):
        out, _, _ = model(faces.permute(0, 3, 1, 2), w=1.0, adain=True)
        return out.permute(0, 2, 3, 1).to(faces.dtype)

    apply.model = model
    return apply


def wrap_parsenet(model):
    """``apply(faces (N, S, S, 3)) → (N, S, S, 19) logits`` for a ParseNet."""

    def apply(faces):
        logits, _ = model(faces.permute(0, 3, 1, 2))
        return logits.permute(0, 2, 3, 1).to(faces.dtype)

    apply.model = model
    return apply
