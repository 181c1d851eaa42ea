"""Port training losses and timestep samplers (flair_tpu_torch.diffusion.
{losses,resample}) against flair_tpu, float32 on the CPU.

Every loss helper, ``vb_terms_bpd``, ``training_losses`` (all four loss
types × fixed and learned variances, the three mean types) and
``prior_bpd`` on the same numpy inputs, and the gradient of the loss with
respect to the model output (the learned-variance VB term's frozen mean);
the loss-aware sampler's weights, ring buffer (duplicate t in one batch,
rows at capacity) and importance weights; the uniform sampler's range and
generator determinism. All within 1e-6 (absolute, or relative to the
largest value where the terms reach 10² and more).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flair_tpu import diffusion as jd
from flair_tpu.diffusion import losses as jl
from flair_tpu.diffusion import resample as jr
from flair_tpu_torch import diffusion as td
from flair_tpu_torch.diffusion import losses as tl
from flair_tpu_torch.diffusion import resample as tr

torch.set_num_threads(1)
TOL = 1e-6
SHAPE = (3, 2, 6, 5, 3)   # (B, T, H, W, C)


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0)


def image(seed):
    """A clip on the 8-bit grid of [-1, 1], edges included."""
    x = np.round((rand(seed, *SHAPE) * 0.6 + 0.5) * 255) / 127.5 - 1
    return np.clip(x, -1, 1).astype(np.float32)


def near_truth(dj, mean_type, x0, x_t, t, noise, var_channels, seed):
    """A denoiser output close to the truth of its mean type, as a trained
    model's is (off by 0.003; the t = 0 decoder bins are ~0.01 wide, and an
    output many widths off puts both packages' NLL in a float32 tail where
    two CDFs cancel), with a
    variance half in [-1, 1] when the variance is learned."""
    target = {"EPSILON": noise, "START_X": x0,
              "PREVIOUS_X": np.array(jd.q_posterior_mean_variance(
                  dj, x0, x_t, jnp.asarray(t))[0])}[mean_type]
    out = target + rand(seed, *SHAPE, scale=0.003)
    if var_channels:
        var = np.tanh(rand(seed + 1, *SHAPE))
        out = np.concatenate([out, var], axis=-1)
    return out.astype(np.float32)


def diffusions(mean_type: str, var_type: str, loss_type: str, n=100):
    """Both packages' diffusions on the same schedule, types by name."""
    betas = jd.get_named_beta_schedule("face_blur", n)

    def kw(pkg):
        return dict(model_mean_type=pkg.ModelMeanType[mean_type],
                    model_var_type=pkg.ModelVarType[var_type],
                    loss_type=pkg.LossType[loss_type])

    return (jd.make_diffusion(betas, **kw(jd)),
            td.make_diffusion(betas, device="cpu", **kw(td)))


def test_normal_kl_cdf_likelihood_mean_flat():
    m1, lv1, m2, lv2 = (rand(i, *SHAPE, scale=0.5) for i in range(4))
    close(tl.normal_kl(*map(torch.from_numpy, (m1, lv1, m2, lv2))).numpy(),
          jl.normal_kl(m1, lv1, m2, lv2))
    x = rand(5, *SHAPE, scale=2.0)
    close(tl.approx_standard_normal_cdf(torch.from_numpy(x)).numpy(),
          jl.approx_standard_normal_cdf(x))
    xq = image(6)
    assert (xq == -1).any() and (xq == 1).any()
    # decoder-like inputs (means near x, std 0.01-0.03): the bin mass is a
    # difference of two CDFs, ill-conditioned in float32 far out in a tail
    means = xq + rand(7, *SHAPE, scale=0.01)
    ls = rand(8, *SHAPE, scale=0.3) - 4.0
    close(tl.discretized_gaussian_log_likelihood(
        torch.from_numpy(xq), means=torch.from_numpy(means),
        log_scales=torch.from_numpy(ls)).numpy(),
        jl.discretized_gaussian_log_likelihood(xq, means=means, log_scales=ls))
    close(tl.mean_flat(torch.from_numpy(x)).numpy(), jl.mean_flat(x))


@pytest.mark.parametrize("var_type", ["FIXED_SMALL", "FIXED_LARGE",
                                      "LEARNED", "LEARNED_RANGE"])
def test_q_mean_variance_and_vb_terms(var_type):
    dj, dt = diffusions("EPSILON", var_type, "KL")
    x0, noise = image(10), rand(11, *SHAPE)
    t = np.array([0, 37, 99])
    x_t = np.array(jd.q_sample(dj, x0, jnp.asarray(t), noise))
    out = near_truth(dj, "EPSILON", x0, x_t, t, noise,
                     "LEARNED" in var_type, 12)
    for a, b in zip(td.q_mean_variance(dt, torch.from_numpy(x0),
                                       torch.from_numpy(t)),
                    jd.q_mean_variance(dj, x0, jnp.asarray(t))):
        close(a.numpy(), b)
    vt_t = tl.vb_terms_bpd(dt, torch.from_numpy(out), torch.from_numpy(x0),
                           torch.from_numpy(x_t), torch.from_numpy(t))
    vt_j = jl.vb_terms_bpd(dj, out, x0, x_t, jnp.asarray(t))
    close(vt_t["output"].numpy(), vt_j["output"])
    close(vt_t["pred_xstart"].numpy(), vt_j["pred_xstart"])


CASES = [(m, v, lt) for lt in ("MSE", "RESCALED_MSE", "KL", "RESCALED_KL")
         for v in ("FIXED_SMALL", "LEARNED_RANGE")
         for m in ("EPSILON",)]
CASES += [("START_X", "LEARNED", "MSE"), ("PREVIOUS_X", "FIXED_LARGE", "MSE"),
          ("START_X", "FIXED_SMALL", "KL")]


@pytest.mark.parametrize("mean_type,var_type,loss_type", CASES)
def test_training_losses_and_output_gradient(mean_type, var_type, loss_type):
    """Terms and d(loss.sum())/d(model output) on a stub denoiser that
    returns a fixed output plus 0 · x_t: the learned-variance VB term must
    not reach the eps half (JAX's stop_gradient, the port's detach)."""
    dj, dt = diffusions(mean_type, var_type, loss_type)
    x0, noise = image(20), rand(21, *SHAPE)
    t = np.array([0, 50, 99])
    x_t = np.array(jd.q_sample(dj, x0, jnp.asarray(t), noise))
    out = near_truth(dj, mean_type, x0, x_t, t, noise,
                     "LEARNED" in var_type, 22)

    def jax_loss(o):
        terms = jl.training_losses(dj, lambda x_t, tt: o + 0 * x_t[..., :1],
                                   jnp.asarray(x0), jnp.asarray(t), None,
                                   noise=jnp.asarray(noise))
        return terms["loss"].sum(), terms

    (_, terms_j), g_j = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(out))
    o_t = torch.from_numpy(out).requires_grad_(True)
    terms_t = tl.training_losses(
        dt, lambda x_t, tt: o_t + 0 * x_t[..., :1], torch.from_numpy(x0),
        torch.from_numpy(t), noise=torch.from_numpy(noise))
    assert set(terms_t) == set(terms_j)
    for k in terms_t:
        close(terms_t[k].detach().numpy(), terms_j[k])
    (g_t,) = torch.autograd.grad(terms_t["loss"].sum(), o_t,
                                 retain_graph=True)
    close(g_t.numpy(), g_j)
    if var_type.startswith("LEARNED") and "MSE" in loss_type:
        # the eps half sees only the MSE term
        (g_mse,) = torch.autograd.grad(terms_t["mse"].sum(), o_t)
        close(g_t[..., :3].numpy(), g_mse[..., :3].numpy())


def test_training_losses_draws_noise_from_the_generator():
    _, dt = diffusions("EPSILON", "FIXED_SMALL", "MSE")
    x0 = torch.from_numpy(image(30))
    t = torch.tensor([3, 4, 5])

    def run(seed):
        return tl.training_losses(dt, lambda x_t, tt: x_t, x0, t,
                                  torch.Generator().manual_seed(seed))["loss"]

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))


def test_prior_bpd():
    dj, dt = diffusions("EPSILON", "FIXED_SMALL", "MSE")
    x0 = image(40)
    close(tl.prior_bpd(dt, torch.from_numpy(x0)).numpy(),
          jl.prior_bpd(dj, jnp.asarray(x0)))


def test_uniform_sample_range_and_generator():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    t1, w1 = tr.uniform_sample(g1, 4096, 17)
    t2, _ = tr.uniform_sample(g2, 4096, 17)
    assert t1.dtype == torch.int64 and torch.equal(t1, t2)
    assert int(t1.min()) == 0 and int(t1.max()) == 16
    assert torch.equal(w1, torch.ones(4096))


def loss_aware_pair(t_hist, history=3, seed=50):
    """Both packages' states after the same sequence of batches."""
    st_j = jr.LossAwareState.create(10, history_per_term=history)
    st_t = tr.LossAwareState.create(10, history_per_term=history)
    rng = np.random.default_rng(seed)
    for ts in t_hist:
        ts = np.asarray(ts)
        losses = rng.uniform(0.1, 3.0, ts.shape).astype(np.float32)
        st_j = jr.update_with_losses(st_j, jnp.asarray(ts), jnp.asarray(losses))
        st_t = tr.update_with_losses(st_t, torch.from_numpy(ts),
                                     torch.from_numpy(losses))
    return st_j, st_t


def test_loss_aware_ring_buffer_in_batch_order():
    """Duplicate t inside one batch write one after another; full rows
    drop their oldest loss (the JAX scan's in-order semantics)."""
    hist = [[1, 5, 5, 9], [5, 5, 1, 1], [5, 9, 9, 9, 9], [0, 0, 0, 0, 1]]
    st_j, st_t = loss_aware_pair(hist)
    np.testing.assert_array_equal(st_t.loss_counts.numpy(),
                                  np.asarray(st_j.loss_counts))
    np.testing.assert_array_equal(st_t.loss_history.numpy(),
                                  np.asarray(st_j.loss_history))
    assert int(st_t.loss_counts[5]) == 3 and int(st_t.loss_counts[3]) == 0


def test_loss_aware_weights_and_sample():
    cold_j, cold_t = loss_aware_pair([[1, 2]])
    close(tr.loss_aware_weights(cold_t).numpy(), jr.loss_aware_weights(cold_j))
    warm = [list(range(10))] * 3 + [[4, 4, 7]]
    st_j, st_t = loss_aware_pair(warm)
    p_j = np.asarray(jr.loss_aware_weights(st_j))
    close(tr.loss_aware_weights(st_t).numpy(), p_j)
    assert not np.allclose(p_j, 0.1)
    t, w = tr.loss_aware_sample(torch.Generator().manual_seed(0), st_t, 64)
    assert t.shape == (64,) and w.dtype == torch.float32
    close(w.numpy(), 1.0 / (10 * p_j[t.numpy()]))
