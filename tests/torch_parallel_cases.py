"""Rank functions for the port's multi-rank tests
(tests/test_torch_parallel*.py), run by ``flair_tpu_torch.parallel.
LocalWorld`` on gloo ranks spawned on the CPU.

Every rank gets the same numpy inputs, builds the mesh it needs, and
returns numpy results. This module imports no JAX: the spawned ranks import
it, and JAX stays in the test bodies.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from flair_tpu_torch.parallel import (
    all_gather_frames, frame_sharded, frame_sharded_temporal_attention,
    halo_exchange_frames, make_mesh, replicate_params, set_frame_group,
    shard, shard_batch, sum_over_mesh_)

# dryrun_multichip's 16² x8 model (__graft_entry__.py:149-162) at the
# goldens' widths, tests/test_torch_train.py's SMALL_KW: its 16 channels
# and 2 deform groups are no DCN instance (Cout 32 / 64 / 128)
SMALL_KW = dict(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
                attn_res=(8,), vsrpp_res=(16,), image_size=16, res_blocks=1,
                num_frames=3, head_dim=8)
# the goldens' x8 BicubicUNet and gaussian BlurUNet (tests/test_torch_pipeline.py)
GOLDEN_X8_KW = dict(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
                    attn_res=(32,), vsrpp_res=(64,), image_size=64,
                    res_blocks=1, num_frames=3, head_dim=8)
GOLDEN_BLUR_KW = dict(image_size=64, in_channels=6, model_channels=32,
                      out_channels=6, num_res_blocks=1,
                      attention_resolutions=(2,), rnn_resolutions=(1,),
                      channel_mult=(1, 2), num_heads=1, num_head_channels=8,
                      use_scale_shift_norm=True, temporal_frames=5)


def frame_mesh():
    return make_mesh(None, axes=("frame",), shape=(dist.get_world_size(),))


# ------------------------------------------------------------ (1) halo ----


def halo_blocks(x, halo, edge, layout):
    """Each rank's haloed block of x (B, T, H, W, C) split over a frame
    mesh of the whole world: ``layout`` "btc" passes (B, T_local, ...),
    "nchw" the port's (B·T_local, C, H, W) with ``b``. A ValueError comes
    back as its message."""
    mesh = frame_mesh()
    xl = shard(torch.from_numpy(x), mesh, [(1, "frame")])
    group = mesh.get_group("frame")
    try:
        if layout == "btc":
            return halo_exchange_frames(xl, halo, group, edge=edge).numpy()
        b, t, h, w, c = xl.shape
        v = xl.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
        out = halo_exchange_frames(v, halo, group, edge=edge, b=b)
        assert out.is_contiguous(memory_format=torch.channels_last)
        return out.permute(0, 2, 3, 1).reshape(b, -1, h, w, c).numpy()
    except ValueError as e:
        return f"ValueError: {e}"


def frame_sharded_mean3(x, shape):
    """``frame_sharded`` of a 3-frame temporal mean (replicate-padded in
    the op) on a (data, frame) mesh of ``shape``: the whole output."""
    mesh = make_mesh(None, axes=("data", "frame"), shape=shape)

    def mean3(v):
        p = torch.cat([v[:, :1], v, v[:, -1:]], 1)
        return (p[:, :-2] + p[:, 1:-1] + p[:, 2:]) / 3

    return frame_sharded(mean3, mesh, halo=1)(torch.from_numpy(x)).numpy()


# ------------------------------------------------------- (2) group_norm ----


def group_norm_blocks(x, groups, weight, bias):
    """``group_norm(group=)`` of each rank's frames of x (B, T, H, W, C)."""
    from flair_tpu_torch.ops.norms import group_norm

    mesh = frame_mesh()
    xl = shard(torch.from_numpy(x), mesh, [(1, "frame")])
    return group_norm(xl, groups, torch.from_numpy(weight),
                      torch.from_numpy(bias),
                      group=mesh.get_group("frame")).numpy()


# ------------------------------------------ (3) Conv3d, ResBlock(dims=3) ----


def _max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def temporal_module_errors(kind, seed, b, t, c, hw):
    """A seeded ``Conv3d`` / ``ResBlock(dims=3)`` on x (B·T, C, H, W): the
    forward and the gradients (input and every parameter, the ranks' losses
    summing to the unsharded loss) under a frame group of the whole world
    against the unsharded module on every rank. Returns the largest
    errors, each over the largest |value| it is compared with."""
    from flair_tpu_torch.models.blocks import ResBlock
    from flair_tpu_torch.models.common import Conv3d

    torch.manual_seed(seed)
    if kind == "conv3d":
        mod = Conv3d(c, c, (3, 1, 1))
        extra = ()
    else:
        mod = ResBlock(c, c, 4 * c, dims=3, kernel_size=3)
        # zero-init out_conv would hide the second conv: make it live
        with torch.no_grad():
            mod.out_conv.weight.normal_(0, 0.1)
        extra = (torch.randn(b * t, 4 * c),)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, t, c, hw, hw)).astype(
        np.float32))
    wt = torch.from_numpy(rng.standard_normal((b, t, c, hw, hw)).astype(
        np.float32))
    params = list(mod.parameters())

    def run(xv, wv, emb, bb):
        xv = xv.reshape(-1, c, hw, hw).clone().requires_grad_(True)
        out = mod(xv, *emb, bb) if emb else mod(xv, bb)
        loss = (out * wv.reshape(out.shape)).sum()
        grads = torch.autograd.grad(loss, [xv] + params)
        return out, grads

    ref_out, ref_g = run(x, wt, extra, b)
    mesh = frame_mesh()
    cut = [(1, "frame")]
    emb_l = tuple(shard(e.reshape(b, t, -1), mesh, cut).reshape(-1, 4 * c)
                  for e in extra)
    set_frame_group(mod, mesh.get_group("frame"))
    try:
        out, g = run(shard(x, mesh, cut), shard(wt, mesh, cut), emb_l, b)
    finally:
        set_frame_group(mod, None)
    g_params = [v.clone() for v in g[1:]]
    sum_over_mesh_(g_params, mesh)
    tl = t // mesh.size()
    mine = lambda v: shard(v.reshape(b, t, *v.shape[1:]), mesh, cut  # noqa
                           ).reshape(b * tl, *v.shape[1:])
    # parameter gradients over the largest of them all: the in_conv bias
    # and emb_proj sit ahead of a GroupNorm, so theirs are zero in exact
    # arithmetic and come out as rounding noise
    g_max = max(float(r.abs().max()) for r in ref_g[1:])
    return {"forward": _max_rel(out, mine(ref_out)),
            "grad_x": _max_rel(g[0], mine(ref_g[0])),
            "grad_params": max(float((a - r).abs().max()) for a, r in
                               zip(g_params, ref_g[1:])) / g_max}


def shift_window_norm_raises():
    from flair_tpu_torch.models.temporal import TemporalAttention

    attn = TemporalAttention(16, num_frames=3, norm_type="shift_window_norm")
    set_frame_group(attn, frame_mesh().get_group("frame"))
    try:
        attn(torch.zeros(4, 16, 2, 2), 1)
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------------ (4) temporal attention ----


def temporal_attention_whole(state, x, shape, channels, num_frames, heads):
    """``frame_sharded_temporal_attention`` of a port TemporalAttention
    with ``state`` on a (data, frame) mesh of ``shape``; the whole output,
    and whether the module's frame group was reset after the call."""
    from flair_tpu_torch.models.temporal import TemporalAttention

    attn = TemporalAttention(channels, num_frames=num_frames,
                             num_heads=heads)
    attn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    mesh = make_mesh(None, axes=("data", "frame"), shape=shape)
    out = frame_sharded_temporal_attention(attn, mesh)(torch.from_numpy(x))
    return out.detach().numpy(), attn.frame_group is None


# ------------------------------------------------------ (5) mesh shapes ----


def mesh_facts():
    """Shapes, axis names, this rank's coordinates and its groups' ranks
    for the default mesh and every 2-D split of the world, then the
    errors of a wrong size or shape."""
    n = dist.get_world_size()
    facts = {}
    for shape in [None] + [(d, n // d) for d in (1, 2, 4) if n % d == 0]:
        mesh = make_mesh(None if shape else n, shape=shape)
        facts[str(shape)] = {
            "shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "coords": tuple(mesh.get_local_rank(a)
                            for a in mesh.mesh_dim_names),
            "groups": tuple(tuple(dist.get_process_group_ranks(
                mesh.get_group(a))) for a in mesh.mesh_dim_names)}
    errors = []
    for kw in (dict(n_devices=n + 1), dict(shape=(n, 2)),
               dict(axes=("frame",), shape=(n, 1))):
        try:
            make_mesh(**kw)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    facts["errors"] = errors
    return facts


# --------------------------------------------- (6) data-parallel grads ----


def data_parallel_grad(w_by_rank, x):
    """mean((x @ w)²) with x's rows split over a ``data`` mesh of the whole
    world, w set to the first rank's by ``replicate_params``: the gradient
    under the training step's rule (each rank's mean over its share
    divided by the mesh size, summed over the mesh), and the w used."""
    mesh = make_mesh()
    w = torch.from_numpy(w_by_rank[dist.get_rank()]).requires_grad_(True)
    replicate_params(mesh, [w])
    xl = shard_batch(mesh, torch.from_numpy(x))
    loss = torch.mean((xl @ w) ** 2) / mesh.size()
    (g,) = torch.autograd.grad(loss, [w])
    sum_over_mesh_([g], mesh)
    return g.numpy(), w.detach().numpy()


# ----------------------------------------------- (7) sampler under mesh ----


def guided_sampler_whole(noise, x0_lr, z, pin_values, shape):
    """The port's guided sampler (x8, 3 steps, SRConv consistency, the
    first frame pinned) on a (data, frame) mesh of ``shape`` with a stub
    denoiser that couples frames (a roll over the whole clip's frames):
    each rank samples its block; the whole result."""
    from flair_tpu_torch.diffusion import GuidanceConfig, make_task_diffusion
    from flair_tpu_torch.diffusion.sampler import guided_sample_steps
    from flair_tpu_torch.operators.factory import (get_operator,
                                                   make_restore_fn_p)

    mesh = make_mesh(None, axes=("data", "frame"), shape=shape)
    group = mesh.get_group("frame")
    d = make_task_diffusion("x8_bicubic", "3", device="cpu")
    b, t, s = noise.shape[:3]
    restore = make_restore_fn_p("x8_bicubic",
                                get_operator("x8_bicubic", s, device="cpu"))
    local = lambda v: shard_batch(mesh, torch.from_numpy(v))  # noqa: E731
    lr_l = local(x0_lr)
    tl = t // mesh.size(1)
    lo = mesh.get_local_rank("frame") * tl

    def restore_fn(v):
        flat = v.reshape((-1,) + v.shape[2:])
        return restore(flat, lr_l.reshape(flat.shape[0], -1)).reshape(v.shape)

    def model_fn(x, tt):
        whole = all_gather_frames(x, group, 1)
        return 0.1 * x + 0.05 * torch.roll(whole, 1, dims=1)[:, lo:lo + tl]

    pin = torch.zeros((b, t, 1, 1, 1), dtype=torch.bool)
    pin[:, :1] = True
    out = guided_sample_steps(
        d, model_fn, local(noise),
        GuidanceConfig(use_aux=False, w=0.85, rho=0.85),
        restore_fn=restore_fn, pin_mask=shard_batch(mesh, pin),
        pin_values=local(pin_values),
        noise_fn=lambda shp: local(z))
    out = all_gather_frames(out, group, 1)
    return all_gather_frames(out, mesh.get_group("data"), 0).numpy()


# -------------------------------------------- (8) restore_video(mesh=) ----


def restore_whole(task, flat, cfg_kw, clip, win, overlap, pad_tail, noise,
                  sharded):
    """The port's ``restore_video`` of ``clip`` with the goldens' small
    model of ``task`` (``flat``, flax names) and ``TaskConfig`` fields
    ``cfg_kw``, DDIM, face off, on the CPU, under a frame mesh of the whole
    world when ``sharded``. ``noise``: "zeros" (``noise_fn``) or a torch
    generator seed. Returns the clip and the bytes this rank gathered."""
    import dataclasses

    from flair_tpu_torch.diffusion import GuidanceConfig, make_task_diffusion
    from flair_tpu_torch.models.adm import BlurUNet
    from flair_tpu_torch.models.sr3 import BicubicUNet
    from flair_tpu_torch.pipeline.video import TASK_CONFIGS, restore_video
    from flair_tpu_torch.pipeline.wrappers import (wrap_bicubic_model,
                                                   wrap_blur_model)
    from flair_tpu_torch.utils.convert import (from_flax_bicubic_unet,
                                               from_flax_blur_unet)

    cfg = dataclasses.replace(TASK_CONFIGS[task], **cfg_kw)
    if task == "x8_bicubic":
        model = BicubicUNet(**GOLDEN_X8_KW)
        model.load_state_dict(from_flax_bicubic_unet(flat))
        wrap = wrap_bicubic_model
    else:
        model = BlurUNet(**GOLDEN_BLUR_KW)
        model.load_state_dict(from_flax_blur_unet(flat))
        wrap = wrap_blur_model
    d = make_task_diffusion(cfg.task, cfg.steps, device="cpu")
    g = GuidanceConfig(use_aux=False, w=cfg.w, rho=cfg.rho, tau=0,
                       zeta=cfg.zeta, noise_level=cfg.noise_level)
    kw = (dict(noise_fn=lambda s: np.zeros(s, np.float32))
          if noise == "zeros" else
          dict(generator=torch.Generator().manual_seed(int(noise))))
    all_gather_frames.bytes = 0
    out = restore_video(clip, cfg, wrap(d, model), diffusion=d, guidance=g,
                        win=win, overlap=overlap, pad_tail=pad_tail,
                        sampler="ddim", device="cpu",
                        mesh=frame_mesh() if sharded else None, **kw)
    return out, all_gather_frames.bytes


# --------------------------------------------- (9)-(11) TrainRunner ----


def small_model(seed):
    from flair_tpu_torch.models.sr3 import BicubicUNet

    model = BicubicUNet(**SMALL_KW)
    model.random_init(seed=seed, scale=0.05)
    return model


def runner_steps(axes, shape, ckpt_dir, batches, steps_before_save=None):
    """A ``TrainRunner(mesh=)`` of the small x8 model (each rank initialised
    from its own seed, so ``replicate_params`` must make them agree) on a
    mesh of ``axes`` and ``shape``, running ``batches`` (whole, the same on
    every rank) with the runner's generator (seed 0). With
    ``steps_before_save``: save after that many steps, then a new runner on
    the same directory resumes and runs the rest. Returns the metrics of
    each step, the final parameters, moments and EMA stream (flax names),
    the generator state, and this rank's count of checkpoint writes."""
    from flair_tpu_torch.diffusion import (get_named_beta_schedule,
                                           make_diffusion)
    from flair_tpu_torch.pipeline.wrappers import wrap_bicubic_train
    from flair_tpu_torch.train import TrainConfig, TrainRunner
    from flair_tpu_torch.train import runner as runner_module
    from flair_tpu_torch.utils.convert import to_flax

    torch.set_num_threads(1)
    mesh = make_mesh(None, axes=axes, shape=shape)
    d = make_diffusion(get_named_beta_schedule("face_bicubic", 2000),
                       device="cpu")
    cfg = TrainConfig(lr=1e-4, ema_rates=(0.9999,))
    writes = []
    save = runner_module.save_pytree
    runner_module.save_pytree = lambda *a: (writes.append(a[0]), save(*a))

    def new_runner():
        model = small_model(dist.get_rank())
        return TrainRunner(d, wrap_bicubic_train(d, model), cfg, model,
                           ckpt_dir=ckpt_dir, device="cpu", mesh=mesh,
                           generator=torch.Generator().manual_seed(0))

    try:
        runner, metrics = new_runner(), []
        for i, batch in enumerate(batches):
            if i == steps_before_save:
                runner.save()
                runner = new_runner()
            host = runner.run_step(batch)
            metrics.append({k: host[k] for k in ("loss", "grad_norm",
                                                 "loss_each", "t")})
    finally:
        runner_module.save_pytree = save
    st = runner.state
    flat = lambda v: to_flax(v, runner.names)  # noqa: E731
    return {"metrics": metrics, "params": flat(st.params),
            "mu": flat(st.opt_state.mu), "ema": flat(st.ema_params[0]),
            "count": st.opt_state.count, "step": st.step,
            "resume_step": runner.resume_step,
            "generator": runner.generator.get_state().numpy(),
            "writes": writes, "files": sorted(os.listdir(ckpt_dir))
            if os.path.isdir(ckpt_dir) else []}
