"""Diffusion engine: schedules, respacing, guided sampler, training losses,
timestep samplers."""

from .schedules import (
    LossType,
    ModelMeanType,
    ModelVarType,
    compute_tables,
    get_named_beta_schedule,
    respace_betas,
    space_timesteps,
)
from .gaussian import (
    Diffusion,
    extract,
    make_diffusion,
    make_task_diffusion,
    map_timesteps,
    p_mean_variance,
    predict_eps_from_xstart,
    predict_xstart_from_eps,
    q_mean_variance,
    q_posterior_mean_variance,
    q_sample,
    scale_timesteps,
    sr3_noise_level,
)
from .sampler import (
    GuidanceConfig,
    compute_gammas,
    compute_ws,
    guidance_tables,
    guided_sample_steps,
    make_guided_update,
    p_sample,
)
from .losses import (
    approx_standard_normal_cdf,
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
    prior_bpd,
    training_losses,
    vb_terms_bpd,
)
from .resample import (
    LossAwareState,
    loss_aware_sample,
    loss_aware_weights,
    uniform_sample,
    update_with_losses,
)
