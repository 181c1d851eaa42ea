"""Denoiser wrapper: spaced step → SR3 noise-level conditioning.

Counterpart of ``wrap_bicubic_model`` in ``flair_tpu/pipeline/wrappers.py``
(respace._WrappedModel, respace.py:138-167): the sampler hands the spaced
step t; the BicubicUNet receives ``sqrt_alphas_cumprod_prev[t+1]``.
"""

from __future__ import annotations

from ..diffusion.gaussian import Diffusion, sr3_noise_level


def wrap_bicubic_model(d: Diffusion, model, *, enable_cross_frames: bool = True):
    """``apply(x, t, low_res, rnn_input, vsrpp_weights, flows=None) → eps``
    for a BicubicUNet, all tensors (B, T, H, W, 3). The callable also
    carries ``.flows_fn(rnn_input)`` — the once-per-window SPyNet flows —
    and ``.model``."""

    def apply(x, t, low_res, rnn_input, vsrpp_weights, flows=None):
        b, tw = x.shape[0], x.shape[1]
        lvl = sr3_noise_level(d, t).to(x.device).expand(b, tw)
        return model(x, lvl, low_res, rnn_input=rnn_input,
                     enable_cross_frames=enable_cross_frames,
                     vsrpp_weights=vsrpp_weights, flows=flows)

    def flows_fn(rnn_input):
        return model.compute_flows(rnn_input, enable_cross_frames)

    apply.flows_fn = flows_fn
    apply.model = model
    return apply
