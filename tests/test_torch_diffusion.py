"""Port diffusion core and operators against flair_tpu.

Schedule tables and respacing (exact / f32-rounding), ``p_sample`` under
both update rules with injected noise, the guided loop with a stub
denoiser fed the same noise in both packages, SRConv ``A`` / ``A_pinv``
at ×8 and ×16 and ``A_pinv_eta``, the LEARNED_RANGE moments of a 6-channel output,
``scale_timesteps`` and the gaussian/jpeg restore closure — all ≤1e-5
absolute in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flair_tpu import diffusion as jd
from flair_tpu.operators.factory import get_operator as j_get_operator
from flair_tpu_torch import diffusion as td
from flair_tpu_torch.operators.factory import get_operator as t_get_operator

torch.set_num_threads(1)
ATOL = 1e-5


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name,n", [("face_bicubic", 2000), ("face_blur", 1000)])
def test_schedule_tables(name, n):
    bj = jd.get_named_beta_schedule(name, n)
    bt = td.get_named_beta_schedule(name, n)
    np.testing.assert_array_equal(bt, bj)
    tj, tt = jd.compute_tables(bj), td.compute_tables(bt)
    for f in ("alphas_cumprod", "sqrt_alphas_cumprod_prev",
              "posterior_log_variance_clipped", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f))


@pytest.mark.parametrize("steps", ["ddim25", "100", "25", "10,5"])
def test_respacing_x8_schedule(steps):
    assert (td.space_timesteps(2000, steps)
            == jd.space_timesteps(2000, steps))
    betas = td.get_named_beta_schedule("face_bicubic", 2000)
    nb_t, map_t = td.respace_betas(betas, td.space_timesteps(2000, steps))
    nb_j, map_j = jd.respace_betas(betas, jd.space_timesteps(2000, steps))
    np.testing.assert_array_equal(nb_t, nb_j)
    np.testing.assert_array_equal(map_t, map_j)
    dt = td.make_task_diffusion("x8_bicubic", steps, device="cpu")
    dj = jd.make_task_diffusion("x8_bicubic", steps)
    assert dt.num_timesteps == dj.num_timesteps
    for f in ("betas", "sqrt_alphas_cumprod_prev", "posterior_variance",
              "timestep_map"):
        np.testing.assert_array_equal(getattr(dt, f).numpy(),
                                      np.asarray(getattr(dj, f)))
    t = dt.num_timesteps // 2
    np.testing.assert_allclose(td.sr3_noise_level(dt, t).numpy(),
                               np.asarray(jd.sr3_noise_level(dj, t)),
                               atol=ATOL)


def test_ddim25_on_x8_schedule_is_stride_80():
    assert sorted(td.space_timesteps(2000, "ddim25")) == list(range(0, 2000, 80))


@pytest.mark.parametrize("rule", ["ddpm", "ddim"])
@pytest.mark.parametrize("t", [0, 7])
def test_p_sample_with_injected_noise(rule, t):
    dt = td.make_task_diffusion("x8_bicubic", "ddim25", device="cpu")
    dj = jd.make_task_diffusion("x8_bicubic", "ddim25")
    x, mo, z, pv = (rand(s, 2, 3, 4, 5, 3) for s in (1, 2, 3, 4))
    mask = np.zeros((1, 3, 1, 1, 1), bool)
    mask[:, :1] = True
    kw = dict(gamma_t=0.7, rho=0.35, eta=0.8, rule=rule)
    s_t, x0_t = td.p_sample(
        dt, *map(torch.from_numpy, (mo, x)), t, torch.from_numpy(z),
        restore_fn=lambda v: 0.1 * v, pin_mask=torch.from_numpy(mask),
        pin_values=torch.from_numpy(pv), **kw)
    s_j, x0_j = jd.p_sample(
        dj, *map(jnp.asarray, (mo, x)), jnp.asarray(t, jnp.int32),
        jnp.asarray(z), w_t=1.0, in_face_window=False,
        restore_fn=lambda v: 0.1 * v, pin_mask=jnp.asarray(mask),
        pin_values=jnp.asarray(pv), **kw)
    np.testing.assert_allclose(x0_t.numpy(), np.asarray(x0_j), atol=ATOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL)


@pytest.mark.parametrize("rule,eta", [("ddpm", 0.0), ("ddim", 0.5)])
def test_guided_sample_steps_stub_denoiser(monkeypatch, rule, eta):
    steps = "10"
    dt = td.make_task_diffusion("x8_bicubic", steps, device="cpu")
    dj = jd.make_task_diffusion("x8_bicubic", steps)
    cfg_t = td.GuidanceConfig(use_aux=False, rho=0.35, zeta=-1)
    cfg_j = jd.GuidanceConfig(use_aux=False, rho=0.35, zeta=-1)
    shape = (1, 2, 4, 4, 3)
    noises = [rand(100 + i, *shape) for i in range(dt.num_timesteps)]
    x_t = rand(99, *shape)

    def stub(x, t):  # any deterministic denoiser of (x, t)
        return 0.3 * x + 0.01 * t

    it_j = iter(noises)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=None, dtype=jnp.float32:
                        jnp.asarray(next(it_j), dtype))
    out_j = jd.guided_sample_steps(
        dj, stub, jnp.asarray(x_t), jax.random.PRNGKey(0), cfg_j,
        restore_fn=lambda v: 0.2 * v, jit_update=False, rule=rule, eta=eta)
    it_t = iter(noises)
    out_t = td.guided_sample_steps(
        dt, stub, torch.from_numpy(x_t), cfg_t, restore_fn=lambda v: 0.2 * v,
        rule=rule, eta=eta, noise_fn=lambda s: next(it_t))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)


def test_guidance_tables():
    dt = td.make_task_diffusion("x8_bicubic", "ddim25", device="cpu")
    dj = jd.make_task_diffusion("x8_bicubic", "ddim25")
    for cfg in (dict(use_aux=False), dict(w=0.7, tau=3, zeta=1.0,
                                          noise_level=2.0)):
        a = td.guidance_tables(dt, td.GuidanceConfig(**cfg))
        b = jd.guidance_tables(dj, jd.GuidanceConfig(**cfg))
        for u, v in zip(a, b):
            np.testing.assert_allclose(np.asarray(u), np.asarray(v), atol=ATOL)


@pytest.mark.parametrize("task", ["x8_bicubic", "x16_bicubic"])
def test_srconv_a_and_pinv(task):
    img = 64
    op_t = t_get_operator(task, img, device="cpu")
    op_j = j_get_operator(task, img)
    x = rand(5, 2, img * img * 3)
    factor = 8 if task == "x8_bicubic" else 16
    y = rand(6, 2, (img // factor) ** 2 * 3)
    np.testing.assert_allclose(op_t.A(torch.from_numpy(x)).numpy(),
                               np.asarray(op_j.A(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(op_t.A_pinv(torch.from_numpy(y)).numpy(),
                               np.asarray(op_j.A_pinv(jnp.asarray(y))),
                               atol=ATOL)


@pytest.mark.parametrize("eta", [0.1, 1.0])
def test_srconv_a_pinv_eta(eta):
    """The regularised pseudo-inverse s / (s² + η) on the singular
    coordinates (flair_tpu/operators/svd_ops.py:67-72)."""
    op_t = t_get_operator("x8_bicubic", 64, device="cpu")
    op_j = j_get_operator("x8_bicubic", 64)
    y = rand(7, 2, 8 * 8 * 3)
    np.testing.assert_allclose(
        op_t.A_pinv_eta(torch.from_numpy(y), eta).numpy(),
        np.asarray(op_j.A_pinv_eta(jnp.asarray(y), eta)), atol=ATOL)


@pytest.mark.parametrize("entry", ["get_operator", "get_operator_gaussian",
                                   "make_task_diffusion"])
def test_entry_points_default_to_cuda(monkeypatch, entry):
    """With no device given an entry point asks for CUDA, and without it
    raises rather than continuing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"get_operator": lambda: t_get_operator("x8_bicubic", 64),
            "get_operator_gaussian": lambda: t_get_operator("gaussian", 64),
            "make_task_diffusion":
                lambda: td.make_task_diffusion("x8_bicubic", "ddim4")}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("steps", ["ddim25", "100"])
def test_p_mean_variance_learned_range_six_channels(steps):
    """The gaussian/jpeg schedule: the BlurUNet's 6-channel output is (ε,
    variance fraction in [-1, 1]); the fraction interpolates the log
    variance between the clipped posterior and β, per batch timestep."""
    dt = td.make_task_diffusion("gaussian", steps, device="cpu")
    dj = jd.make_task_diffusion("gaussian", steps)
    assert dt.model_var_type == td.ModelVarType.LEARNED_RANGE
    x = rand(20, 2, 3, 4, 5, 3)
    mo = np.concatenate([rand(21, 2, 3, 4, 5, 3),
                         np.tanh(rand(22, 2, 3, 4, 5, 3))], -1)
    t = np.array([0, dt.num_timesteps - 1])
    out_t = td.p_mean_variance(dt, torch.from_numpy(mo), torch.from_numpy(x),
                               torch.from_numpy(t))
    out_j = jd.p_mean_variance(dj, jnp.asarray(mo), jnp.asarray(x),
                               jnp.asarray(t, jnp.int32))
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(
            np.broadcast_to(out_t[k].numpy(), x.shape),
            np.broadcast_to(np.asarray(out_j[k]), x.shape), rtol=1e-5,
            atol=ATOL)


@pytest.mark.parametrize("rescale", [False, True])
def test_scale_timesteps(rescale):
    """The BlurUNet's conditioning: the original-schedule index of a spaced
    step, rescaled to 0..1000 when the diffusion asks for it."""
    betas = td.get_named_beta_schedule("face_blur", 1000)
    use = td.space_timesteps(1000, "ddim25")
    dt = td.make_diffusion(betas, rescale_timesteps=rescale, use_timesteps=use,
                           device="cpu")
    dj = jd.make_diffusion(betas, rescale_timesteps=rescale, use_timesteps=use)
    t = np.arange(dt.num_timesteps)
    out_t = td.scale_timesteps(dt, td.map_timesteps(dt, torch.from_numpy(t)))
    out_j = jd.scale_timesteps(dj, jd.map_timesteps(dj, jnp.asarray(t)))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    assert out_t.dtype == (torch.float32 if rescale else torch.int64)


@pytest.mark.parametrize("task", ["gaussian", "jpeg"])
def test_blur_operator_default_and_restore_fn(task):
    """get_operator builds PseudoSR for the blur tasks; the restore closure
    adds the JPEG round-trip for jpeg only."""
    from flair_tpu.operators.factory import make_restore_fn_p as j_restore
    from flair_tpu_torch.operators import PseudoSR
    from flair_tpu_torch.operators.factory import make_restore_fn_p

    op_t = t_get_operator(task, 64, device="cpu")
    op_j = j_get_operator(task, 64)
    assert isinstance(op_t, PseudoSR)
    x0 = np.tanh(rand(23, 2, 64, 64, 3))
    y = np.tanh(rand(24, 2, 16, 16, 3))
    out_t = make_restore_fn_p(task, op_t, jpeg_qf=60)(
        torch.from_numpy(x0), torch.from_numpy(y))
    out_j = j_restore(task, op_j, jpeg_qf=60)(jnp.asarray(x0), jnp.asarray(y))
    assert np.mean(np.abs(out_t.numpy() - np.asarray(out_j))) <= 1e-5
