"""Port multi-device restoration and training (``restore_video(mesh=)``,
``make_train_step(mesh=)``, ``TrainRunner(mesh=)``) against flair_tpu and
the unsharded port, float32 on the CPU, on worlds of 2 and 4 gloo ranks
(``parallel.LocalWorld``, spawned once each for the module; rank functions
in tests/torch_parallel_cases.py, which imports no JAX).

8. ``restore_video(mesh=)`` with a 2-way frame mesh at the goldens' x8 and
   gaussian configurations (5 frames, windows of 4 overlapping by 1, the
   tail padded: 2 frames a rank, DDIM 2), zero noise: equal to the port's
   unsharded run within SHARDED_TOL and ≥ 45 dB PSNR against JAX's
   ``restore_video`` (unsharded), as tests/test_torch_pipeline.py. With one
   torch generator the sharded run draws its noise as the unsharded one
   does, and a window the mesh does not divide runs whole on every rank.
9. ``TrainRunner(mesh=)`` with 2 ``data`` ranks, one step of
   ``dryrun_multichip``'s 16² x8 model (__graft_entry__.py:149-162) at the
   goldens' widths (its own 16 channels are no DCN instance) on a
   B = 2, T = 2 batch, against JAX's ``make_train_step`` on the whole
   batch with the t and noise the runner's generator drew: loss and
   grad_norm to 1e-5 relative, every gradient to 1e-4 of max(its largest
   entry, GRAD_FLOOR of the model's largest), the updated parameters where
   the gradient is live, the EMA stream.
10. The same step frame-sharded on a (data 2 × frame 2) mesh (4 ranks, one
    frame each), against the same JAX step.
11. Save after two steps on the first rank only (one write, the others
    none), every rank resuming for a third: the state equals three
    straight steps bit for bit, on every rank.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 300.0
# port sharded against port unsharded on the same noise, max abs over the
# [0, 1] clip. The sharded norms take var = E[x²] − mean² (JAX's sharded
# formula, norms.py:43-47) where the unsharded ones take two passes; that
# rounding, carried through the DDIM steps and the DCN's bilinear
# sampling, moves single pixels by some 1e-5
SHARDED_TOL = 5e-5
GRAD_FLOOR = 0.2     # as tests/test_torch_train.py
LR = 1e-4


def spawn(n, tmp_path_factory):
    from flair_tpu_torch.parallel import LocalWorld

    init = tmp_path_factory.mktemp(f"world{n}") / "init"
    return LocalWorld(n, str(init), threads=1, timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    with spawn(2, tmp_path_factory) as w:
        yield w


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    with spawn(4, tmp_path_factory) as w:
        yield w


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(1.0 / mse))


def golden(name):
    gold = os.path.join(ROOT, "goldens", name)
    with open(os.path.join(gold, "meta.json")) as f:
        meta = json.load(f)
    return (np.load(os.path.join(gold, "degraded01.npy")), meta,
            dict(np.load(os.path.join(gold, "params.npz"))))


TASKS = {"x8_bicubic": "x8_s64", "gaussian": "gaussian_s64"}


def task_kw(task, meta):
    """The goldens' guidance at 64² (tests/test_torch_pipeline.py)."""
    kw = dict(output_size=64, input_size=64 // meta["factor"], steps="ddim2",
              w=meta["w"], rho=0.35 if task == "x8_bicubic" else meta["rho"],
              zeta=meta["zeta"], tau=0, noise_level=meta.get("noise_level",
                                                            0.0))
    if task == "x8_bicubic":
        kw["vsrpp_bg_weight"] = 0.0
    return kw


def jax_restore(monkeypatch, task, flat, kw, clip):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from flair_tpu import diffusion as jd
    from flair_tpu.models.adm import BlurUNet
    from flair_tpu.models.sr3 import BicubicUNet
    from flair_tpu.pipeline import video as jvideo
    from flair_tpu.pipeline.wrappers import wrap_bicubic_model, wrap_blur_model
    from flair_tpu.utils.checkpoint import unflatten_params

    cfg = dataclasses.replace(jvideo.TASK_CONFIGS[task], **kw)
    d = jd.make_task_diffusion(cfg.task, cfg.steps)
    if task == "x8_bicubic":
        apply = wrap_bicubic_model(d, BicubicUNet(**cases.GOLDEN_X8_KW),
                                   unflatten_params(flat))
    else:
        apply = wrap_blur_model(d, BlurUNet(**cases.GOLDEN_BLUR_KW,
                                            dcn_patch_size=None),
                                unflatten_params(flat))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=None, dtype=jnp.float32:
                        jnp.zeros(shape if shape is not None else (), dtype))
    out = jvideo.restore_video(
        clip, cfg, apply, diffusion=d,
        guidance=jd.GuidanceConfig(use_aux=False, w=cfg.w, rho=cfg.rho,
                                   tau=0, zeta=cfg.zeta,
                                   noise_level=cfg.noise_level),
        win=4, overlap=1, sampler="ddim")
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("task", sorted(TASKS))
def test_restore_video_sharded_matches_unsharded_and_flair_tpu(
        monkeypatch, world2, task):
    clip, meta, flat = golden(TASKS[task])
    kw = task_kw(task, meta)
    args = (task, flat, kw, clip, 4, 1, True, "zeros")
    world2.submit(cases.restore_whole, *args, True)
    whole, _ = cases.restore_whole(*args, False)
    sharded = world2.collect()
    want = jax_restore(monkeypatch, task, flat, kw, clip)
    assert want.shape == whole.shape == (5, 64, 64, 3)
    for out, gathered in sharded:
        # two windows, each gathers its sample (2 frames × 64² × 3 f32)
        # after the model's VSR++ states and halos
        assert gathered > 2 * 2 * 64 * 64 * 3 * 4
        gap = np.abs(out - whole).max()
        assert gap <= SHARDED_TOL, gap
        p = psnr(out, want)
        assert p >= 45.0, p


def test_restore_video_draws_noise_as_unsharded_and_runs_odd_windows_whole(
        world2):
    """One torch generator, 6 frames, windows of 4 overlapping by 1, the
    tail NOT padded: the first window splits 2 ways, the 3-frame tail does
    not and runs whole on both ranks; the run equals the unsharded one."""
    _, meta, flat = golden("x8_s64")
    clip = np.random.default_rng(3).uniform(0, 1, (6, 8, 8, 3)).astype(
        np.float32)
    args = ("x8_bicubic", flat, task_kw("x8_bicubic", meta), clip, 4, 1,
            False, 11)
    world2.submit(cases.restore_whole, *args, True)
    whole, _ = cases.restore_whole(*args, False)
    for out, _ in world2.collect():
        gap = np.abs(out - whole).max()
        assert gap <= SHARDED_TOL, gap


def small_batch(seed, b=2, t=2, s=16):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, s), np.linspace(0, 1, s),
                         indexing="ij")

    def clip(ph):
        return np.tanh(np.sin(4 * yy[..., None] + 3 * xx[..., None] + ph)
                       + 0.1 * rng.standard_normal((b, t, s, s, 3))
                       ).astype(np.float32)

    return {"x_start": clip(rng.uniform(0, 6.28, (b, t, 1, 1, 3))),
            "low_res_input": clip(rng.uniform(0, 6.28, (b, t, 1, 1, 3)))}


@pytest.fixture(scope="module")
def jax_step():
    """JAX's ``make_train_step`` on small_batch(0) from the small model's
    seed-0 weights, with the t and noise a seed-0 torch generator draws
    first (as the runner's does): its state, metrics and t."""
    import jax
    import jax.numpy as jnp

    from flair_tpu.diffusion import make_diffusion, sr3_noise_level
    from flair_tpu.diffusion.schedules import get_named_beta_schedule
    from flair_tpu.models.sr3 import BicubicUNet
    from flair_tpu.train import TrainConfig, create_train_state, make_train_step
    from flair_tpu.utils.checkpoint import unflatten_params
    from flair_tpu_torch.diffusion.resample import uniform_sample
    from flair_tpu_torch.utils.convert import flax_names, to_flax

    batch = small_batch(0)
    model = cases.small_model(0)
    flat = to_flax(dict(model.named_parameters()), flax_names(model))
    gen = torch.Generator().manual_seed(0)
    t, _ = uniform_sample(gen, 2, 2000, device="cpu")
    noise = torch.randn(batch["x_start"].shape, generator=gen).numpy()
    jd = make_diffusion(get_named_beta_schedule("face_bicubic", 2000))
    jm = BicubicUNet(**cases.SMALL_KW, temporal_attn=True,
                     cross_frame_module=True, dcn_patch_size=None)

    def apply_fn(p, x_t, ts, b):
        lv = sr3_noise_level(jd, ts.reshape(-1)).reshape(ts.shape)
        return jm.apply(p, x_t, lv, b["low_res_input"],
                        rnn_input=b["low_res_input"])

    cfg = TrainConfig(lr=LR, ema_rates=(0.9999,))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint",
                   lambda key, shape, lo, hi, *a, **k:
                   jnp.asarray(t.numpy(), jnp.int32))
        mp.setattr(jax.random, "normal",
                   lambda key, shape=None, dtype=jnp.float32:
                   jnp.asarray(noise, dtype))
        st, met = jax.jit(make_train_step(jd, apply_fn, cfg))(
            create_train_state(unflatten_params(flat), cfg),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(1))
    return st, met, t.numpy()


def assert_step_matches_flair_tpu(results, st, met, t):
    """Each rank's runner after one step against JAX's: see the module
    docstring (9). JAX's gradients are read from its first moment."""
    from flair_tpu.utils.checkpoint import flatten_params

    g_jax = {k: np.asarray(v) / np.float32(0.1) for k, v in
             flatten_params(st.opt_state[0][0].mu).items()}
    p_jax = flatten_params(st.params)
    e_jax = flatten_params(st.ema_params[0])
    g_max = max(np.abs(g).max() for g in g_jax.values())
    for res in results:
        m = res["metrics"][0]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(met[k]), rtol=1e-5)
        np.testing.assert_allclose(m["loss_each"], np.asarray(met["loss_each"]),
                                   rtol=1e-5)
        np.testing.assert_array_equal(m["t"], t)
        assert set(res["mu"]) == set(g_jax)
        n_live = 0
        for k, gj in g_jax.items():
            tol = 1e-4 * max(np.abs(gj).max(), GRAD_FLOOR * g_max)
            gp = res["mu"][k] / np.float32(0.1)
            assert np.abs(gp - gj).max() <= tol, k
            live = np.abs(gj) > tol
            n_live += int(live.sum())
            np.testing.assert_allclose(res["params"][k][live],
                                       np.asarray(p_jax[k])[live], rtol=0,
                                       atol=1e-2 * LR, err_msg=k)
            np.testing.assert_allclose(res["ema"][k], np.asarray(e_jax[k]),
                                       rtol=0, atol=1e-7, err_msg=k)
        # the updated parameters were compared on 21 % of the entries
        assert n_live > 0.15 * sum(v.size for v in g_jax.values())
    for res in results[1:]:   # the ranks stay replicas of each other
        for k, v in res["params"].items():
            np.testing.assert_array_equal(v, results[0]["params"][k])


def test_runner_data_parallel_matches_flair_tpu(jax_step, world2, tmp_path):
    results = world2.run(cases.runner_steps, ("data",), (2,),
                         str(tmp_path / "ckpt"), [small_batch(0)])
    assert_step_matches_flair_tpu(results, *jax_step)


def test_runner_frame_parallel_matches_flair_tpu(jax_step, world4, tmp_path):
    results = world4.run(cases.runner_steps, ("data", "frame"), (2, 2),
                         str(tmp_path / "ckpt"), [small_batch(0)])
    assert_step_matches_flair_tpu(results, *jax_step)


def test_runner_saves_on_the_first_rank_and_resumes_on_every_rank(
        world2, tmp_path):
    batches = [small_batch(i) for i in range(3)]
    mesh = (("data",), (2,))
    straight = world2.run(cases.runner_steps, *mesh, str(tmp_path / "a"),
                          batches)
    resumed = world2.run(cases.runner_steps, *mesh, str(tmp_path / "b"),
                         batches, 2)
    assert [len(r["writes"]) for r in resumed] == [1, 0]
    assert [r["files"] for r in resumed] == [["state_000002"]] * 2
    for a, b in zip(straight, resumed):
        assert b["resume_step"] == 2 and a["resume_step"] == 0
        assert (a["step"], a["count"]) == (b["step"], b["count"]) == (3, 3)
        np.testing.assert_array_equal(a["generator"], b["generator"])
        for key in ("params", "mu", "ema"):
            for k, v in a[key].items():
                np.testing.assert_array_equal(b[key][k], v, err_msg=k)
        for ma, mb in zip(a["metrics"], b["metrics"]):
            assert float(ma["loss"]) == float(mb["loss"])
