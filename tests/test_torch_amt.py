"""The port's AMT (flair_tpu_torch/models/amt.py) against flair_tpu, and
the training runner densifying ``skip > 1`` clips with it.

Seeded numpy variables in the flax model's shapes
(``flax_init.random_flax_params``) go into both, carried into the port by
``from_flax``; the same seeded numpy inputs go through both,
float32. The JAX side is jitted (one compile of a whole AMT call takes
10-15 s on one core, op-by-op dispatch 30 s), at the JAX tests' tiny AMT
(``channels=(16, 24, 32, 48)``, 2 flows, 2 correlation levels of radius 2):
32², where the coarsest decoder works at 2², and a 24×40 pair that
``interpolate`` edge-pads to 32×48.

The ``cuda`` test runs the port on the card against its own CPU run
(``pytest --noconftest -m cuda``); it skips here.
"""

import functools

import numpy as np
import pytest
import torch

from flax_init import random_flax_params
from flair_tpu_torch.models.amt import (
    AMT, BidirCorr, UpConv, interpolate, make_interpolator)
from flair_tpu_torch.models.registry import get_model
from flair_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)
TINY = dict(channels=(16, 24, 32, 48), skip_channels=16, num_flows=2,
            corr_lvls=2, corr_radius=2)
TOL = 1e-4      # max abs error, frames in [0, 1] / [-1, 1]


def uniform(seed, *shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def moving_pair(seed, h, w, shift=2):
    """(1, h, w, 3) frames in [-0.9, 0.9]: one smooth seeded pattern and
    the same pattern ``shift`` pixels to the right."""
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 6.28, 3)
    fr = rng.uniform(0.1, 0.4, (3, 2))

    def frame(dx):
        yy, xx = np.meshgrid(np.arange(h), np.arange(w) - dx, indexing="ij")
        return 0.9 * np.stack([np.sin(fr[c, 0] * yy + fr[c, 1] * xx + ph[c])
                               for c in range(3)], -1)[None]

    return frame(0).astype(np.float32), frame(shift).astype(np.float32)


@functools.lru_cache(maxsize=None)
def tiny_pair(seed=0):
    """The tiny flax AMT with seeded variables, and the port's."""
    from flair_tpu.models.amt import AMT as J
    from flair_tpu.utils.checkpoint import unflatten_params

    jm = J(**TINY)
    x = uniform(seed, 1, 32, 32, 3)
    flat = random_flax_params(jm, seed, x, x, np.array([0.5], np.float32))
    tm = get_model("amt", **TINY).eval()
    tm.load_state_dict(from_flax(flat), strict=True)
    return jm, unflatten_params(flat), tm


@pytest.mark.parametrize("hw", [(4, 6), (5, 7)])
def test_upconv_matches_flair_tpu(hw):
    """flax ConvTranspose((4, 4), 2, SAME) correlates an unflipped kernel;
    from_flax flips it into torch's layout. Even and odd sizes."""
    import jax

    from flair_tpu.models.amt import UpConv as J
    from flair_tpu.utils.checkpoint import unflatten_params

    x = uniform(1, 2, *hw, 8, lo=-1.0)
    jm = J(6)
    flat = random_flax_params(jm, 2, x)
    ref = np.asarray(jm.apply(unflatten_params(flat), x))
    tm = UpConv(8, 6)
    tm.load_state_dict(from_flax(flat), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert ref.shape == (2, 2 * hw[0], 2 * hw[1], 6)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("levels,hw", [(2, (5, 6)), (3, (4, 4))])
def test_bidir_corr_lookup_matches_flair_tpu(levels, hw):
    """Both directions at 2 and 3 levels (5×6 → 2×3 pools with floor; 4×4
    → 2×2 → 1×1 broadcasts its one entry), radius 2, centroids moved by
    flows of up to 3 px so that taps leave the map."""
    import jax.numpy as jnp

    from flair_tpu.models.amt import BidirCorr as J

    rng = np.random.default_rng(3)
    h, w = hw
    f0 = rng.standard_normal((2, h, w, 8)).astype(np.float32)
    f1 = rng.standard_normal((2, h, w, 8)).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([gx, gy], -1)[None].astype(np.float32)
    c0 = base + rng.uniform(-3, 3, (2, h, w, 2)).astype(np.float32)
    c1 = base + rng.uniform(-3, 3, (2, h, w, 2)).astype(np.float32)
    j0, j1 = J(jnp.asarray(f0), jnp.asarray(f1), levels, 2).lookup(
        jnp.asarray(c0), jnp.asarray(c1))
    corr = BidirCorr(torch.from_numpy(f0).permute(0, 3, 1, 2),
                     torch.from_numpy(f1).permute(0, 3, 1, 2), levels, 2)
    t0, t1 = corr.lookup(torch.from_numpy(c0), torch.from_numpy(c1))
    for t, j in ((t0, j0), (t1, j1)):
        assert t.shape == (2, levels * 25, h, w)
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(j), rtol=0, atol=1e-5)


def test_amt_matches_flair_tpu():
    """The tiny AMT at 32², t = 0.3."""
    import jax

    jm, params, tm = tiny_pair()
    i0, i1 = uniform(4, 1, 32, 32, 3), uniform(5, 1, 32, 32, 3)
    embt = np.array([0.3], np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, i0, i1, embt))
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, (i0, i1, embt)))
    assert out.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)


def test_interpolate_matches_flair_tpu():
    """``interpolate`` at factor 3 on a 24×40 pair in 2-px motion: edge
    padding to 32×48, two AMT calls (t = 1/3, 2/3), the crop back.

    The pair is a moving smooth pattern, what an interpolator is given. On
    two frames of independent noise the random-weight model predicts flows
    of up to 45 px and samples its correlation volume three flows away
    (1 / (1 − t) at t = 2/3): there a 1-ulp change of one input moves the
    port's own output by 1.7e-4, and both float32 results lie 1.6e-4 (port)
    and 2.1e-4 (JAX) from the port's float64 run, against 8e-5 and below on
    this pair."""
    import jax

    from flair_tpu.models.amt import interpolate as j_interpolate

    jm, params, tm = tiny_pair()
    f0, f1 = moving_pair(6, 24, 40)
    ref = np.asarray(jax.jit(
        lambda p, a, b: j_interpolate(jm, p, a, b, 3))(params, f0, f1))
    with torch.no_grad():
        out = interpolate(tm, torch.from_numpy(f0), torch.from_numpy(f1), 3)
    assert out.shape == (1, 2, 24, 40, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)


def test_interpolate_skipped_frames_with_amt_matches_flair_tpu():
    """The runner's densification with AMT bound by ``make_interpolator``
    against the JAX ``interpolate_skipped_frames(model, params, ...)``:
    B = 2 clips of 3 frames at 16², skip 2."""
    import jax

    from flair_tpu.train.runner import interpolate_skipped_frames as j_skip
    from flair_tpu_torch.train import interpolate_skipped_frames

    jm, params, tm = tiny_pair()
    low = uniform(8, 2, 3, 16, 16, 3, lo=-1.0)
    ref = np.asarray(jax.jit(lambda p, v: j_skip(jm, p, v, 2))(params, low))
    out = interpolate_skipped_frames(make_interpolator(tm),
                                     torch.from_numpy(low), 2)
    assert out.shape == (2, 5, 16, 16, 3) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)
    np.testing.assert_array_equal(out[:, ::2].numpy(), low)


def test_runner_step_with_skip_leaves_amt_alone(tmp_path):
    """A ``TrainRunner`` step with ``skip = 2`` on the CPU: 2 conditioning
    frames densified to 3 by AMT; AMT's parameters unchanged, without
    gradients and outside the optimizer and EMA state, and AMT left in
    eval mode."""
    from flair_tpu_torch.diffusion import (get_named_beta_schedule,
                                           make_diffusion)
    from flair_tpu_torch.models.sr3 import BicubicUNet
    from flair_tpu_torch.pipeline.wrappers import wrap_bicubic_train
    from flair_tpu_torch.train import TrainConfig, TrainRunner

    model = BicubicUNet(inner_channel=32, norm_groups=16,
                        channel_mults=(1, 2), attn_res=(8,), vsrpp_res=(16,),
                        image_size=16, num_frames=3, head_dim=8)
    model.random_init(seed=0, scale=0.05)
    d = make_diffusion(get_named_beta_schedule("face_bicubic", 2000),
                       device="cpu")
    amt = AMT(**TINY)
    before = {k: v.clone() for k, v in amt.state_dict().items()}
    runner = TrainRunner(d, wrap_bicubic_train(d, model), TrainConfig(),
                         model, ckpt_dir=str(tmp_path), device="cpu", skip=2,
                         interpolate=make_interpolator(amt))
    rng = np.random.default_rng(9)
    host = runner.run_step({
        "x_start": rng.uniform(-1, 1, (1, 3, 16, 16, 3)).astype(np.float32),
        "low_res_input": rng.uniform(-1, 1, (1, 2, 16, 16, 3)).astype(
            np.float32)})
    assert np.isfinite(host["loss"]).all()
    assert all(g is not None for g in host["grads"].values())
    assert not amt.training
    amt_ids = {id(p) for p in amt.parameters()}
    state = runner.state
    for stream in (state.params, state.opt_state.mu, state.opt_state.nu,
                   *state.ema_params):
        assert not amt_ids & {id(v) for v in stream.values()}
        assert len(stream) == len(list(model.parameters()))
    for k, v in amt.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in amt.parameters())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_amt_matches_cpu(cuda_device):
    """The tiny AMT, seeded random weights, f32 with TF32 off: cuDNN,
    the correlation matmul and grid_sample on the card against the CPU,
    through ``interpolate`` at factor 2 on a 24×40 pair."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    tm = AMT(**TINY).eval()
    f0, f1 = map(torch.from_numpy, moving_pair(10, 24, 40))
    with torch.no_grad():
        ref = interpolate(tm, f0, f1, 2)
        out = interpolate(tm.to(cuda_device), f0.to(cuda_device),
                          f1.to(cuda_device), 2)
    torch.backends.cudnn.allow_tf32 = True
    assert (out.cpu() - ref).abs().max().item() <= TOL
