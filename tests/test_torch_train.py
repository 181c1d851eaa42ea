"""Port training (flair_tpu_torch.train, ops.ema, ops.patch) against
flair_tpu, float32 on the CPU.

- ``ema_update`` and ``patchify`` / ``unpatchify`` / ``process_patched``
  over every merge and padding mode: equal to JAX to 1e-6.
- The optimizer alone on the same gradients against
  ``flair_tpu.train.loop.make_optimizer`` (clip on and off, anneal on and
  off, weight decay), five steps: parameters and moments to 1e-7 relative
  (3e-7 with the clip).
- One whole training step of the goldens' x8 BicubicUNet (VSR++ on, so K1's
  plain backward runs) against ``flair_tpu.train.make_train_step`` with the
  same t and noise: loss and grad_norm to 1e-5 relative, every gradient to
  1e-4 (of the floor ``GRAD_FLOOR`` explains), the updated parameters and
  the EMA stream.
- Microbatches of one clip against the whole batch.
- ``TrainRunner``: save at step 2, resume, two more steps equal four
  straight steps bit for bit; quartile keys logged; a saved model and its
  EMA stream load through ``utils.checkpoint.load_params``; cuda by default.
- The round-robin merge of ``interpolate_skipped_frames`` against JAX's
  with the same stub interpolator.
- The training modules import neither JAX, flax, optax nor the JAX
  package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flair_tpu_torch.diffusion import get_named_beta_schedule, make_diffusion
from flair_tpu_torch.models.sr3 import BicubicUNet
from flair_tpu_torch.ops import patch as tpatch
from flair_tpu_torch.ops.dcn import deform_conv2d_raw
from flair_tpu_torch.ops.ema import ema_update
from flair_tpu_torch.pipeline.wrappers import wrap_bicubic_train
from flair_tpu_torch.train import (
    TrainConfig, TrainRunner, create_train_state, interpolate_skipped_frames,
    make_optimizer, make_train_step)
from flair_tpu_torch.utils.checkpoint import load_params
from flair_tpu_torch.utils.convert import flax_names, from_flax, to_flax

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_KW = dict(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
                 attn_res=(32,), vsrpp_res=(64,), image_size=64,
                 num_frames=3, head_dim=8)
# the smallest BicubicUNet with every module, VSR++ included (the DCN takes
# 32-channel features), for the step-count tests
SMALL_KW = dict(GOLDEN_KW, attn_res=(8,), vsrpp_res=(16,), image_size=16)
# Gradients are compared to 1e-4 of max(their own largest entry, GRAD_FLOOR
# of the model's largest). The floor: 14 parameters have a gradient that is
# zero in exact arithmetic (the temporal attention's key biases, under a
# softmax; the 3-D blocks' in_conv bias and emb_proj, ahead of a GroupNorm),
# which each package computes as rounding noise ~1e-8 of the model's
# largest; and the VSR++ and SPyNet gradients pass through bilinear sampling
# at flows near zero, where the derivative changes at every pixel boundary:
# moving the port's own input by 1e-6 moves them by up to 5e-6 of the
# model's largest gradient (2e-4 of their own), as far as they sit from
# JAX's.
GRAD_FLOOR = 0.2


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


# ---------------------------------------------------------------- (b) ----


def test_ema_update_matches_flair_tpu():
    from flair_tpu.ops.ema import ema_update as j_ema

    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    ema = {k: rand(i, *s) for i, (k, s) in enumerate(shapes.items())}
    par = {k: rand(10 + i, *s) for i, (k, s) in enumerate(shapes.items())}
    ref = j_ema(ema, par, 0.999)
    streams = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    assert ema_update(streams, {k: torch.from_numpy(v) for k, v in
                                par.items()}, 0.999) is streams
    as_list = [torch.from_numpy(ema[k].copy()) for k in shapes]
    ema_update(as_list, [torch.from_numpy(par[k]).double() for k in shapes],
               0.999)
    for i, k in enumerate(shapes):
        np.testing.assert_allclose(streams[k].numpy(), ref[k], atol=1e-6)
        assert as_list[i].dtype == torch.float32
        np.testing.assert_allclose(as_list[i].numpy(), ref[k], atol=1e-6)


@pytest.mark.parametrize("padding", ["constant", "edge", "reflect"])
@pytest.mark.parametrize("merge", ["mean", "linear", "mid", "max", "min"])
def test_patch_roundtrip_matches_flair_tpu(merge, padding):
    from flair_tpu.ops import patch as jpatch

    x = rand(5, 2, 5, 13, 11, 2)
    block, stride = (3, 8, 6), (2, 5, 4)
    jb, jmeta = jpatch.patchify(jnp.asarray(x), block, stride, padding)
    tb, tmeta = tpatch.patchify(torch.from_numpy(x), block, stride, padding)
    assert tmeta["padded_shape"] == tuple(jmeta["padded_shape"])
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    # blocks changed blockwise, so the merge mode matters in the overlaps
    fn_j = lambda b: jnp.tanh(b) * 2 + b.mean()          # noqa: E731
    fn_t = lambda b: torch.tanh(b) * 2 + b.mean()        # noqa: E731
    jm = jax.lax.map(fn_j, jb)
    tm = torch.stack([fn_t(b) for b in tb])
    np.testing.assert_allclose(
        tpatch.unpatchify(tm, tmeta, merge).numpy(),
        np.asarray(jpatch.unpatchify(jm, jmeta, merge)), atol=1e-6)
    np.testing.assert_allclose(
        tpatch.process_patched(torch.from_numpy(x), fn_t, block, stride,
                               merge, padding).numpy(),
        np.asarray(jpatch.process_patched(jnp.asarray(x), fn_j, block, stride,
                                          merge, padding)), atol=1e-6)


# ---------------------------------------------------------------- (d) ----


@pytest.mark.parametrize("grad_clip,anneal,wd", [
    (0.0, 0, 0.0), (1.5, 0, 0.0), (0.0, 3, 0.0), (1.5, 3, 0.01)])
def test_optimizer_matches_optax(grad_clip, anneal, wd):
    """Five updates on the same gradients (their global norm crosses the
    clip threshold from step to step; the anneal reaches lr 0 at step 3):
    parameters and both moments to 1e-7 relative to each tensor's
    largest entry; 3e-7 with the clip, whose global norm sums in another
    order than XLA's (one ulp of the norm moves every clipped gradient)."""
    from flair_tpu.train.loop import TrainConfig as JCfg
    from flair_tpu.train.loop import make_optimizer as j_make

    shapes = {"w": (4, 3, 3, 3), "b": (4,), "d": (6, 5)}
    params = {k: rand(i, *s) for i, (k, s) in enumerate(shapes.items())}
    kw = dict(lr=1e-2, weight_decay=wd, grad_clip=grad_clip,
              lr_anneal_steps=anneal)
    tx_j = j_make(JCfg(**kw))
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    st_j = tx_j.init(p_j)
    tx_t = make_optimizer(TrainConfig(**kw))
    p_t = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st_t = tx_t.init(p_t)
    for step in range(5):
        scale = (0.2, 1.0, 0.05, 2.0, 0.5)[step]
        grads = {k: rand(100 * step + i, *s, scale=scale)
                 for i, (k, s) in enumerate(shapes.items())}
        upd, st_j = tx_j.update({k: jnp.asarray(v) for k, v in grads.items()},
                                st_j, p_j)
        p_j = {k: p_j[k] + upd[k] for k in p_j}
        tx_t.update_(p_t, {k: torch.from_numpy(v) for k, v in grads.items()},
                     st_t)
    adam = st_j[-1][0]
    tol = 3e-7 if grad_clip else 1e-7
    assert st_t.count == int(adam.count) == 5
    for k in shapes:
        for mine, ref in ((p_t[k], p_j[k]), (st_t.mu[k], adam.mu[k]),
                          (st_t.nu[k], adam.nu[k])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                       atol=tol * np.abs(ref).max())


# ------------------------------------------------------------- (e), (f) ----


def golden_model():
    flat = dict(np.load(os.path.join(ROOT, "goldens", "x8_s64",
                                     "params.npz")))
    model = BicubicUNet(**GOLDEN_KW)
    model.load_state_dict(from_flax(flat))
    return model, flat


def x8_diffusion():
    return make_diffusion(get_named_beta_schedule("face_bicubic", 2000),
                          device="cpu")


def test_trainable_parameters_are_the_flax_tree():
    """The trainable tensors are the flax params, name for name (the
    temporal position embeddings and SPyNet's normalisation stay buffers:
    constants in flax), and every parameter reaches the loss."""
    model, flat = golden_model()
    names = flax_names(model)
    assert sorted(names.values()) == sorted(flat)
    assert {k for k, _ in model.named_buffers()} >= {
        "down_1.temp_attn.t_mid", "spynet.mean"}


def test_train_step_matches_flair_tpu(monkeypatch):
    """One step of the goldens' x8 model (f32; VSR++ at 64², so the DCN's
    plain backward runs; JAX with the exact DCN, ``dcn_patch_size=None``)
    with the same t and noise (JAX's ``randint`` / ``normal`` patched to
    return them, as tests/test_goldens.py does).

    - loss and grad_norm within 1e-5 relative;
    - each gradient within 1e-4 of max(its largest entry, GRAD_FLOOR of
      the model's largest);
    - Adam's first update is ±lr wherever |g| ≫ eps, so a gradient's sign
      decides it: the updated parameters are compared where |g_jax| is
      above that gradient's tolerance (both signs agree there: 30 % of
      the entries), within 1e-2·lr; the EMA stream everywhere, within
      1e-7.
    JAX's gradients are read from its first moment, mu = 0.1·g."""
    from flair_tpu.diffusion import make_diffusion as j_make_diffusion
    from flair_tpu.diffusion import sr3_noise_level
    from flair_tpu.diffusion.schedules import get_named_beta_schedule as j_bs
    from flair_tpu.models.sr3 import BicubicUNet as JBicubicUNet
    from flair_tpu.train import TrainConfig as JCfg
    from flair_tpu.train import create_train_state as j_state
    from flair_tpu.train import make_train_step as j_step
    from flair_tpu.utils.checkpoint import flatten_params, unflatten_params

    lr = 1e-4
    model, flat = golden_model()
    x0, low = clip(1, 1, 3, 64), clip(2, 1, 3, 64)
    noise = rand(3, 1, 3, 64, 64, 3)
    t = np.array([700])

    d = x8_diffusion()
    cfg = TrainConfig(lr=lr, ema_rates=(0.9999,))
    step = make_train_step(d, wrap_bicubic_train(d, model), cfg)
    state = create_train_state(dict(model.named_parameters()), cfg)
    launches = deform_conv2d_raw.launches
    state, met = step(state, {"x_start": torch.from_numpy(x0),
                              "low_res_input": torch.from_numpy(low)},
                      t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    assert deform_conv2d_raw.launches == launches   # the CPU runs the twin

    jd = j_make_diffusion(j_bs("face_bicubic", 2000))
    jm = JBicubicUNet(**GOLDEN_KW, temporal_attn=True,
                      cross_frame_module=True, dcn_patch_size=None)

    def apply_fn(p, x_t, ts, batch):
        lv = sr3_noise_level(jd, ts.reshape(-1)).reshape(ts.shape)
        return jm.apply(p, x_t, lv, batch["low_res_input"],
                        rnn_input=batch["low_res_input"])

    jcfg = JCfg(lr=lr, ema_rates=(0.9999,))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k:
                        jnp.asarray(t, jnp.int32))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=None, dtype=jnp.float32:
                        jnp.asarray(noise, dtype))
    jst, jmet = jax.jit(j_step(jd, apply_fn, jcfg))(
        j_state(unflatten_params(flat), jcfg),
        {"x_start": jnp.asarray(x0), "low_res_input": jnp.asarray(low)},
        jax.random.PRNGKey(1))
    monkeypatch.undo()

    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)
    np.testing.assert_array_equal(met["t"].numpy(), np.asarray(jmet["t"]))
    names = flax_names(model)
    assert all(g is not None for g in met["grads"].values())
    g_port = to_flax(met["grads"], names)
    g_jax = {k: np.asarray(v) / np.float32(0.1) for k, v in
             flatten_params(jst.opt_state[0][0].mu).items()}
    assert set(g_port) == set(g_jax) == set(flat)
    g_max = max(np.abs(g).max() for g in g_jax.values())
    p_port = to_flax(state.params, names)
    p_jax = flatten_params(jst.params)
    e_port = to_flax(state.ema_params[0], names)
    e_jax = flatten_params(jst.ema_params[0])
    n_live = 0
    for k, gj in g_jax.items():
        tol = 1e-4 * max(np.abs(gj).max(), GRAD_FLOOR * g_max)
        assert np.abs(g_port[k] - gj).max() <= tol, k
        live = np.abs(gj) > tol
        n_live += int(live.sum())
        np.testing.assert_allclose(p_port[k][live], np.asarray(p_jax[k])[live],
                                   rtol=0, atol=1e-2 * lr, err_msg=k)
        np.testing.assert_allclose(e_port[k], np.asarray(e_jax[k]), rtol=0,
                                   atol=1e-7, err_msg=k)
    assert n_live > 0.25 * sum(v.size for v in flat.values())   # 30 %


def small_setup(seed=0):
    model = BicubicUNet(**SMALL_KW)
    model.random_init(seed=seed, scale=0.05)
    return model, x8_diffusion()


def test_microbatches_match_the_whole_batch():
    """B = 2 in microbatches of one clip (grad / 2 accumulated in order)
    against the whole batch, same t and noise: loss, per-clip losses and
    grad_norm within 1e-5 relative, every gradient within 1e-5 of
    max(its largest entry, GRAD_FLOOR of the model's largest)."""
    out = {}
    x0, low = clip(4, 2, 3, 16), clip(5, 2, 3, 16)
    noise, t = rand(6, 2, 3, 16, 16, 3), torch.tensor([120, 1700])
    for micro in (-1, 1):
        model, d = small_setup()
        cfg = TrainConfig(microbatch=micro)
        state = create_train_state(dict(model.named_parameters()), cfg)
        _, out[micro] = make_train_step(d, wrap_bicubic_train(d, model), cfg)(
            state, {"x_start": torch.from_numpy(x0),
                    "low_res_input": torch.from_numpy(low)},
            t=t, noise=torch.from_numpy(noise))
    whole, micro = out[-1], out[1]
    for k in ("loss", "loss_each", "grad_norm"):
        torch.testing.assert_close(micro[k], whole[k], rtol=1e-5, atol=0)
    g_max = max(g.abs().max() for g in whole["grads"].values())
    for k, g in whole["grads"].items():
        err = (micro["grads"][k] - g).abs().max()
        assert err <= 1e-5 * max(g.abs().max(), GRAD_FLOOR * g_max), k


# ---------------------------------------------------------------- (g) ----


def batches(seed=0, b=1, t=3, s=16):
    rs = np.random.default_rng(seed)
    while True:
        yield {"x_start": rs.uniform(-1, 1, (b, t, s, s, 3)).astype(np.float32),
               "low_res_input": rs.uniform(-1, 1, (b, t, s, s, 3)).astype(
                   np.float32)}


def make_runner(ckpt, **kw):
    model, d = small_setup()
    cfg = TrainConfig(lr=1e-3, ema_rates=(0.99, 0.9))
    return TrainRunner(d, wrap_bicubic_train(d, model), cfg, model,
                       ckpt_dir=ckpt, device="cpu", **kw), model


def assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    pairs = [(a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu)]
    pairs += list(zip(a.ema_params, b.ema_params))
    for x, y in pairs:
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_runner_resume_repeats_a_straight_run(tmp_path, monkeypatch):
    """run_loop returns after the save at step 2 (DIFFUSION_TRAINING_TEST);
    a new runner resumes from state_000002 and runs two more steps: the
    state then equals four straight steps bit for bit (the generator state
    is saved with the step). The quartile keys are logged; the saved model
    and EMA stream load through load_params and name the flax tree."""
    from flair_tpu_torch.utils import logging as logger

    logger.configure(str(tmp_path / "logs"), format_strs=["json"])
    ckpt = str(tmp_path / "ckpts")
    runner, model = make_runner(ckpt, log_interval=100, save_interval=2)
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    data = batches()
    runner.run_loop(data, max_steps=10)
    assert runner.step == 2 and runner.state.step == 2
    saved = os.path.join(ckpt, "state_000002")
    assert sorted(os.listdir(saved)) == ["ema_0.npz", "ema_1.npz",
                                         "model.npz", "train_state.npz"]
    kvs = logger.get_current().name2val
    assert any(k.startswith("loss_q") for k in kvs), sorted(kvs)
    for f, stream in (("model", runner.state.params),
                      ("ema_1", runner.state.ema_params[1])):
        sd = load_params(os.path.join(saved, f + ".npz"), "bicubic_unet")
        assert sd.keys() == stream.keys()
        for k in sd:
            assert torch.equal(sd[k], stream[k]), (f, k)
    with np.load(os.path.join(saved, "model.npz")) as f:
        assert sorted(f.files) == sorted(flax_names(model).values())

    monkeypatch.delenv("DIFFUSION_TRAINING_TEST")
    resumed, _ = make_runner(ckpt, save_interval=100)
    assert resumed.resume_step == 2
    assert_states_equal(resumed.state, runner.state)
    resumed.run_loop(data, max_steps=2)
    assert resumed.state.step == 4

    straight, _ = make_runner(str(tmp_path / "straight"), save_interval=100)
    straight.run_loop(batches(), max_steps=4)
    assert_states_equal(resumed.state, straight.state)


def test_runner_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    model, d = small_setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainRunner(d, wrap_bicubic_train(d, model), TrainConfig(), model)


def test_runner_skip_needs_an_interpolator(tmp_path):
    runner, _ = make_runner(str(tmp_path), skip=2)
    with pytest.raises(ValueError, match="interpolator"):
        runner.run_step(next(batches()))


# ---------------------------------------------------------------- (h) ----


def test_interpolate_skipped_frames_matches_flair_tpu(monkeypatch):
    """The round-robin merge with one stub interpolator on both sides
    (f0·(1-a) + f1·a for a = k/skip): originals at every skip-th frame,
    the interpolated frames between, equal to JAX's."""
    import flair_tpu.models.amt as amt
    from flair_tpu.train import interpolate_skipped_frames as j_interp

    def stub_np(f0, f1, skip, xp):
        a = xp.arange(1, skip).reshape(1, skip - 1, 1, 1, 1) / skip
        return f0[:, None] * (1 - a) + f1[:, None] * a

    monkeypatch.setattr(amt, "interpolate",
                        lambda model, params, f0, f1, skip:
                        stub_np(f0, f1, skip, jnp))
    low = clip(7, 2, 4, 8)
    ref = np.asarray(j_interp(None, None, jnp.asarray(low), 3))
    out = interpolate_skipped_frames(
        lambda f0, f1, skip: stub_np(f0, f1, skip, torch),
        torch.from_numpy(low), 3)
    assert out.shape == (2, 10, 8, 8, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    np.testing.assert_array_equal(out[:, ::3].numpy(), low)


def test_training_modules_import_neither_jax_nor_flair_tpu():
    code = (
        "import sys\n"
        "import flair_tpu_torch.train, flair_tpu_torch.ops.patch\n"
        "import flair_tpu_torch.ops.ema, flair_tpu_torch.utils.logging\n"
        "import flair_tpu_torch.diffusion.losses\n"
        "import flair_tpu_torch.diffusion.resample\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'flair_tpu', 'optax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
