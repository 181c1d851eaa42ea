"""Gradient checkpointing (``use_checkpoint``) in both UNets and the BlurUNet
training step, float32 on the CPU.

- flax's ``nn.remat`` keeps the scope names: the JAX BlurUNet and
  BicubicUNet built with ``use_checkpoint=True`` init the same flat tree as
  without it, which ``flax_names`` of the port's model names exactly;
- remat is exact: for the goldens' gaussian BlurUNet and x8 BicubicUNet,
  the loss and every gradient with ``use_checkpoint=True`` equal those of
  ``False`` (bound: 1e-7 relative; on the CPU they agree bit for bit). The
  same holds with a ``params`` dict that is NOT the module's own tensors
  (carried from the goldens while the module keeps a random init): under
  ``torch.func.functional_call`` the recompute must run on that dict, not
  on the module's tensors, which the backward would otherwise see;
- ``wrap_blur_train`` conditions the model as ``restore_video`` does;
- one training step of the goldens' gaussian BlurUNet with remat against
  ``flair_tpu.train.make_train_step`` (the JAX model with
  ``use_checkpoint=True`` and the exact DCN), t and noise injected: loss and
  grad_norm within 1e-5 relative, each gradient within 1e-4 of max(its
  largest entry, GRAD_FLOOR of the model's largest), as
  tests/test_torch_train.py holds the x8 step, or
  within twice its ``ulp_jump`` (below), for at most MAX_JUMPY of the
  tensors;
- on the card (``-m cuda``): the same step on cuda (K1, K2) against cpu,
  under the same rule with the card's own jump.

``ulp_jump``: the BlurUNet's gradient is not continuous in its input at
this bound. Its VSR++ / SPyNet gradients pass leaky-ReLU / ReLU kinks and
bilinear sampling, whose coordinate derivative jumps at every integer
position, and moving ``x_start`` by one float32 ulp (×(1 ± 1e-7)) moves
a few gradients of the port's own step by 1-4× the bound above (CPU,
goldens' weights; the x8 model by at most 0.22×); so does summing in
another order. Two float32 implementations round differently and so land
on either side of such kinks. A gradient may therefore differ by twice
the largest change that such a rerun makes in the same implementation,
measured in the test, not chosen.
  This file imports JAX only inside the parity tests (the card's machine
  has none).
"""

import os

import numpy as np
import pytest
import torch

from flair_tpu_torch.diffusion import (
    get_named_beta_schedule, make_diffusion, make_task_diffusion,
    training_losses)
from flair_tpu_torch.models.adm import BlurUNet
from flair_tpu_torch.models.sr3 import BicubicUNet
from flair_tpu_torch.pipeline.wrappers import (
    wrap_bicubic_train, wrap_blur_train)
from flair_tpu_torch.train import (
    TrainConfig, create_train_state, make_train_step)
from flair_tpu_torch.utils.convert import flax_names, from_flax, to_flax

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the goldens' models (tests/test_torch_goldens.py)
BLUR_KW = dict(image_size=64, model_channels=32, num_res_blocks=1,
               attention_resolutions=(2,), rnn_resolutions=(1,),
               channel_mult=(1, 2), num_heads=1, num_head_channels=8,
               temporal_frames=5)
X8_KW = dict(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
             attn_res=(32,), vsrpp_res=(64,), image_size=64, num_frames=3,
             head_dim=8)
GOLDEN = {"blur": "gaussian_s64", "bicubic": "x8_s64"}
# as tests/test_torch_train.py (the floor is explained there)
GRAD_FLOOR = 0.2
REMAT_TOL = 1e-7
FRAMES = 3
# at most this share of the gradient tensors may pass on their ulp jump
MAX_JUMPY = 0.05


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def clip(seed, b, t, s):
    """(B, T, s, s, 3) smooth frames in [-1, 1]."""
    yy, xx = np.meshgrid(np.linspace(0, 1, s), np.linspace(0, 1, s),
                         indexing="ij")
    ph = np.random.default_rng(seed).uniform(0, 6.28, (b, t, 1, 1, 3))
    return np.tanh(np.sin(4 * yy[..., None] + 3 * xx[..., None] + ph)
                   + rand(seed, b, t, s, s, 3, scale=0.1)).astype(np.float32)


def golden_flat(kind):
    return dict(np.load(os.path.join(ROOT, "goldens", GOLDEN[kind],
                                     "params.npz")))


def build(kind, device="cpu", **kw):
    """(model, diffusion, train wrapper, batch) of the goldens' ``kind``
    model, its weights loaded; the batch (B = 1, FRAMES frames, 64²)
    holds a separate ``rnn_input`` for the BlurUNet."""
    if kind == "blur":
        model = BlurUNet(**dict(BLUR_KW, **kw))
        d = make_task_diffusion("gaussian", "1000", device=device)
        wrap = wrap_blur_train
        batch = {"x_start": clip(1, 1, FRAMES, 64),
                 "low_res_input": clip(2, 1, FRAMES, 64),
                 "rnn_input": clip(3, 1, FRAMES, 64)}
    else:
        model = BicubicUNet(**dict(X8_KW, **kw))
        d = make_diffusion(get_named_beta_schedule("face_bicubic", 2000),
                           device=device)
        wrap = wrap_bicubic_train
        batch = {"x_start": clip(1, 1, FRAMES, 64),
                 "low_res_input": clip(2, 1, FRAMES, 64)}
    model.load_state_dict(from_flax(golden_flat(kind)))
    model.to(device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return model, d, wrap(d, model), batch


def loss_and_grads(d, apply, params, batch, t, noise):
    """The training step's loss and its gradients in ``params``."""
    x = batch["x_start"]
    b, tw = x.shape[:2]
    terms = training_losses(
        d, lambda x_t, t_b: apply(params, x_t, t_b[:, None].expand(b, tw),
                                  batch), x, t, noise=noise)
    loss = terms["loss"].mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


@pytest.mark.parametrize("kind", ["blur", "bicubic"])
def test_remat_keeps_the_flax_scope_names(kind):
    import jax
    import jax.numpy as jnp

    from flax.core import unfreeze
    from flax.traverse_util import flatten_dict

    from flair_tpu.models.adm import BlurUNet as JBlur
    from flair_tpu.models.sr3 import BicubicUNet as JBicubic

    x = jnp.zeros((1, FRAMES, 64, 64, 3))
    trees = []
    for remat in (False, True):
        if kind == "blur":
            jm = JBlur(**BLUR_KW, dcn_patch_size=None, use_checkpoint=remat)
            ts = jnp.zeros((1, FRAMES), jnp.int32)
        else:
            jm = JBicubic(**X8_KW, dcn_patch_size=None, use_checkpoint=remat)
            ts = jnp.zeros((1, FRAMES), jnp.float32)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, ts, x)
        trees.append({k: v.shape for k, v in
                      flatten_dict(unfreeze(shapes), sep="/").items()})
    assert trees[0] == trees[1]
    model = build(kind, use_checkpoint=True)[0]
    names = flax_names(model)
    assert sorted(names.values()) == sorted(trees[1])
    assert sorted(trees[1]) == sorted(golden_flat(kind))
    flat = to_flax(model.state_dict(), names)
    assert {k: v.shape for k, v in flat.items()} == trees[1]


@pytest.mark.parametrize("params_from", ["module", "dict"])
@pytest.mark.parametrize("kind", ["blur", "bicubic"])
def test_remat_is_exact(kind, params_from):
    """Loss and gradients with remat on and off, through the training
    wrapper. ``dict``: the module keeps a seeded random init and the
    goldens' weights come in as ``params`` (``functional_call``), so a
    recompute on the module's own tensors would change every gradient
    (the run on the module's weights below shows by how much)."""
    model, d, apply, batch = build(kind)
    t, noise = torch.tensor([700]), torch.from_numpy(rand(4, 1, FRAMES, 64,
                                                          64, 3))
    if params_from == "dict":
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in model.state_dict().items()
                  if k in dict(model.named_parameters())}
        model.random_init(seed=5, scale=0.05)
    else:
        params = dict(model.named_parameters())
    out = {}
    for remat in (False, True):
        model.use_checkpoint = remat
        out[remat] = loss_and_grads(d, apply, params, batch, t, noise)
    (loss0, g0), (loss1, g1) = out[False], out[True]
    assert abs(float(loss1) - float(loss0)) <= REMAT_TOL * abs(float(loss0))
    for k, g in g0.items():
        assert (g1[k] - g).abs().max() <= REMAT_TOL * g.abs().max(), k
    if params_from == "dict":
        own = dict(model.named_parameters())
        _, g_own = loss_and_grads(d, apply, own, batch, t, noise)
        moved = max(float((g_own[k] - g).abs().max() / g.abs().max())
                    for k, g in g0.items() if g.abs().max() > 0)
        assert moved > 1e-2, moved


def test_wrap_blur_train_conditioning():
    """The wrapper hands the model the original-schedule index as int64
    for every frame, ``low_res_input`` and ``rnn_input`` (by default the
    conditioning), with ``params`` in place of the module's tensors."""
    model, d, apply, batch = build("blur")
    x_t = torch.from_numpy(rand(6, 1, FRAMES, 64, 64, 3))
    ts = torch.tensor([[3, 3, 3]])
    params = {k: v * 0.5 for k, v in model.named_parameters()}
    with torch.no_grad():
        got = apply(params, x_t, ts, batch)
        got_default = apply(params, x_t, ts, {"low_res_input":
                                              batch["low_res_input"]})
        for k, v in model.named_parameters():
            v.mul_(0.5)
        ref = model(x_t, ts.to(torch.int64), batch["low_res_input"],
                    rnn_input=batch["rnn_input"])
        ref_default = model(x_t, ts, batch["low_res_input"])
    assert got.shape == (1, FRAMES, 64, 64, 6)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(got_default, ref_default, rtol=0, atol=0)
    assert not torch.equal(got, got_default)


def blur_train_step(device, heads=8, x_scale=1.0):
    """One ``make_train_step`` of the goldens' gaussian BlurUNet with remat
    on ``device``, t = 700 and the noise fixed, ``x_start`` scaled by
    ``x_scale``. Returns (model, state, metrics)."""
    model, d, apply, batch = build("blur", device, use_checkpoint=True,
                                   num_head_channels=heads)
    batch["x_start"] = batch["x_start"] * x_scale
    cfg = TrainConfig(lr=1e-4, ema_rates=(0.9999,))
    state = create_train_state(dict(model.named_parameters()), cfg)
    noise = torch.from_numpy(rand(4, 1, FRAMES, 64, 64, 3)).to(device)
    state, met = make_train_step(d, apply, cfg)(
        state, batch, t=torch.tensor([700], device=device), noise=noise)
    return model, state, met


def ulp_jump(device, grads, heads=8):
    """Each gradient's largest change (cpu tensors) over three reruns of
    the step: ``x_start`` moved by one float32 ulp up, and down, and the
    same input summed in another order (4 threads on the CPU; on the card,
    a plain rerun: cuDNN's backward may reorder its sums). That is the
    resolution of one implementation's gradients at this input."""
    jump = {k: torch.zeros(()) for k in grads}
    threads = torch.get_num_threads()
    for scale, n in ((1 + 1e-7, threads), (1 - 1e-7, threads), (1.0, 4)):
        torch.set_num_threads(n)
        try:
            moved = blur_train_step(device, heads, scale)[2]["grads"]
        finally:
            torch.set_num_threads(threads)
        for k, g in grads.items():
            jump[k] = torch.maximum(
                jump[k], (moved[k].cpu() - g.cpu()).abs().max())
    return jump


def assert_grads_within(grads, ref, jump):
    """Each gradient within 1e-4 of max(its largest |ref|, GRAD_FLOOR of
    the largest |ref| of all), or within twice its ``jump``; the second
    rule for at most MAX_JUMPY of the tensors. All cpu tensors, keyed
    alike."""
    g_max = max(float(r.abs().max()) for r in ref.values())
    jumpy = []
    for k, r in ref.items():
        tol = 1e-4 * max(float(r.abs().max()), GRAD_FLOOR * g_max)
        err = float((grads[k] - r).abs().max())
        if err > tol:
            assert err <= 2 * float(jump[k]), (k, err, tol, float(jump[k]))
            jumpy.append(k)
    assert len(jumpy) <= MAX_JUMPY * len(ref), jumpy


def test_blur_train_step_matches_flair_tpu(monkeypatch):
    """One step of the goldens' gaussian BlurUNet (LEARNED_RANGE: the loss
    holds the VB term; VSR++ at 64², so K1's plain backward runs; the
    attention's plain backward), remat on both sides, against JAX with the
    same t and noise (``randint`` / ``normal`` patched as
    tests/test_torch_train.py does). JAX's gradients are read from its
    first moment, mu = 0.1·g."""
    import jax
    import jax.numpy as jnp

    from flair_tpu.diffusion import make_task_diffusion as j_task
    from flair_tpu.diffusion import map_timesteps, scale_timesteps
    from flair_tpu.models.adm import BlurUNet as JBlur
    from flair_tpu.train import TrainConfig as JCfg
    from flair_tpu.train import create_train_state as j_state
    from flair_tpu.train import make_train_step as j_step
    from flair_tpu.utils.checkpoint import flatten_params, unflatten_params

    model, state, met = blur_train_step("cpu")
    flat = golden_flat("blur")
    jd = j_task("gaussian", "1000")
    jm = JBlur(**BLUR_KW, dcn_patch_size=None, use_checkpoint=True)

    def apply_fn(p, x_t, ts, batch):
        t_orig = scale_timesteps(jd, map_timesteps(jd, ts)).astype(jnp.int32)
        return jm.apply(p, x_t, t_orig, batch["low_res_input"],
                        rnn_input=batch["rnn_input"])

    jcfg = JCfg(lr=1e-4, ema_rates=(0.9999,))
    noise = rand(4, 1, FRAMES, 64, 64, 3)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k:
                        jnp.asarray([700], jnp.int32))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=None, dtype=jnp.float32:
                        jnp.asarray(noise, dtype))
    batch = {"x_start": clip(1, 1, FRAMES, 64),
             "low_res_input": clip(2, 1, FRAMES, 64),
             "rnn_input": clip(3, 1, FRAMES, 64)}
    jst, jmet = jax.jit(j_step(jd, apply_fn, jcfg))(
        j_state(unflatten_params(flat), jcfg),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    monkeypatch.undo()

    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)
    names = flax_names(model)
    assert all(g is not None for g in met["grads"].values())
    g_port = to_flax(met["grads"], names)
    g_jax = {k: np.asarray(v) / np.float32(0.1) for k, v in
             flatten_params(jst.opt_state[0][0].mu).items()}
    assert set(g_port) == set(g_jax) == set(flat)
    jump = {names[k]: v for k, v in ulp_jump("cpu", met["grads"]).items()}
    assert_grads_within({k: torch.from_numpy(v) for k, v in g_port.items()},
                        {k: torch.from_numpy(v) for k, v in g_jax.items()},
                        jump)
    e_port = to_flax(state.ema_params[0], names)
    e_jax = flatten_params(jst.ema_params[0])
    for k in g_jax:
        np.testing.assert_allclose(e_port[k], np.asarray(e_jax[k]), rtol=0,
                                   atol=1e-7, err_msg=k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_blur_train_step_matches_cpu(cuda_device):
    """The same step with 32-channel heads (K2 takes D = 32 / 64) on the
    card (K1 and K2 forwards, recomputed under remat; their plain float32
    backwards) against the CPU, f32 with TF32 off: loss and grad_norm
    within 1e-5 relative, the gradients under ``assert_grads_within`` with
    the card's own ulp jump."""
    from flair_tpu_torch.ops.attention import flash_attention
    from flair_tpu_torch.ops.dcn import deform_conv2d_raw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = deform_conv2d_raw.launches, flash_attention.launches
    _, _, met_g = blur_train_step(cuda_device, heads=32)
    launched = (deform_conv2d_raw.launches - saved[0],
                flash_attention.launches - saved[1])
    jump = ulp_jump(cuda_device, met_g["grads"], heads=32)
    _, _, met_c = blur_train_step("cpu", heads=32)
    torch.backends.cudnn.allow_tf32 = True
    assert launched[0] > 0 and launched[1] > 0, launched
    for k in ("loss", "grad_norm"):
        assert abs(float(met_g[k]) - float(met_c[k])) <= 1e-5 * abs(
            float(met_c[k])), k
    assert_grads_within({k: g.cpu() for k, g in met_g["grads"].items()},
                        met_c["grads"], jump)
