"""VLB terms and the training loss.

Counterpart of ``flair_tpu/diffusion/losses.py`` (math helpers:
guided_diffusion/losses.py:12-77). ``training_losses`` is the loss the
reference's TrainLoop calls but its diffusion core never defines:

- MSE / RESCALED_MSE: MSE on the mean-type target; with a learned variance,
  plus a VB term whose mean is frozen (``detach``, JAX's ``stop_gradient``)
  so it trains only the variance head, scaled by T/1000 for RESCALED_MSE;
- KL / RESCALED_KL: the VLB alone (× T for RESCALED_KL).

Channels are the last axis, as in the sampler: x (B, T, H, W, C).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from .gaussian import (
    Diffusion,
    p_mean_variance,
    q_mean_variance,
    q_posterior_mean_variance,
    q_sample,
)
from .schedules import LossType, ModelMeanType, ModelVarType

_LOG2 = math.log(2.0)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL divergence between two diagonal gaussians (losses.py:12-39)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    """Tanh approximation of the standard normal CDF (losses.py:42-47)."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a gaussian discretized to [-1, 1] 8-bit bins
    (losses.py:50-77)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


def mean_flat(x):
    """Mean over all non-batch axes (nn.py:835-839)."""
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def vb_terms_bpd(d: Diffusion, model_output, x_start, x_t, t,
                 clip_denoised: bool = False) -> Dict[str, torch.Tensor]:
    """The variational bound's term at timestep t, in bits per dim: the
    decoder NLL at t = 0, KL(q(x_{t-1}|x_t, x_0) || p(x_{t-1}|x_t)) else."""
    true_mean, _, true_log_var = q_posterior_mean_variance(d, x_start, x_t, t)
    out = p_mean_variance(d, model_output, x_t, t, clip_denoised=clip_denoised)
    kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
    kl = mean_flat(kl) / _LOG2
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
    decoder_nll = mean_flat(decoder_nll) / _LOG2
    output = torch.where(torch.as_tensor(t, device=kl.device) == 0,
                         decoder_nll, kl)
    return {"output": output, "pred_xstart": out["pred_xstart"]}


def training_losses(d: Diffusion, model_fn: Callable, x_start, t,
                    generator: Optional[torch.Generator] = None,
                    noise=None) -> Dict[str, torch.Tensor]:
    """Per-example training losses for timesteps ``t`` (int64, (B,)).

    ``model_fn(x_t, t)`` is the denoiser; ``noise`` defaults to a standard
    normal draw from ``generator`` in x_start's shape, dtype and device.
    Returns ``loss`` (B,) and, by loss type, ``mse`` and ``vb``."""
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator,
                            dtype=x_start.dtype, device=x_start.device)
    x_t = q_sample(d, x_start, t, noise)
    terms: Dict[str, torch.Tensor] = {}
    model_output = model_fn(x_t, t)

    if d.loss_type in (LossType.KL, LossType.RESCALED_KL):
        terms["loss"] = vb_terms_bpd(d, model_output, x_start, x_t, t)["output"]
        if d.loss_type == LossType.RESCALED_KL:
            terms["loss"] = terms["loss"] * d.num_timesteps
    elif d.loss_type in (LossType.MSE, LossType.RESCALED_MSE):
        c = x_start.shape[-1]
        if d.model_var_type in (ModelVarType.LEARNED,
                                ModelVarType.LEARNED_RANGE):
            assert model_output.shape[-1] == 2 * c, model_output.shape
            eps_part, var_part = model_output.split(c, dim=-1)
            # the VB term trains the variance head only: its mean is frozen
            frozen_out = torch.cat([eps_part.detach(), var_part], dim=-1)
            terms["vb"] = vb_terms_bpd(d, frozen_out, x_start, x_t, t)["output"]
            if d.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (d.num_timesteps / 1000.0)
            model_output = eps_part
        if d.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = q_posterior_mean_variance(d, x_start, x_t, t)[0]
        elif d.model_mean_type == ModelMeanType.START_X:
            target = x_start
        else:
            target = noise
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = (terms["mse"] + terms["vb"] if "vb" in terms
                         else terms["mse"])
    else:
        raise NotImplementedError(d.loss_type)
    return terms


def prior_bpd(d: Diffusion, x_start):
    """KL(q(x_T | x_0) || N(0, 1)) in bits per dim."""
    t = torch.full((x_start.shape[0],), d.num_timesteps - 1,
                   dtype=torch.int64, device=x_start.device)
    qt_mean, _, qt_log_variance = q_mean_variance(d, x_start, t)
    kl_prior = normal_kl(qt_mean, qt_log_variance, 0.0,
                         torch.zeros_like(qt_log_variance))
    return mean_flat(kl_prior) / _LOG2
