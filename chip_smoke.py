"""GPU smoke run of the flair_tpu_torch port: builds the CUDA kernels, holds
each against its plain PyTorch version, and drives the port's main paths
(x8_bicubic and gaussian guided DDIM, face prior off) at full width on one
card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernel_dcn,kernel_flash

Phases, one JSON line each (a record per shape for the kernels):
  device       card name, power limit (nvidia-smi)
  build        nvcc of every source in flair_tpu_torch/csrc/, one after the
               other
  kernel_dcn   csrc/dcn_raw.cu vs ops/deform.py at both main-path shapes,
               max residue magnitude 5 (x8 path) and 10 (gaussian path)
  kernel_flash csrc/flash_attn.cu vs ops/attention.dot_product_attention at
               the BlurUNet's three attention shapes (bf16) and one f32 row
  slice_small  the x8 test configuration on cuda (kernel) vs cpu (plain)
  slice_small_blur  the gaussian and jpeg test configurations (goldens'
               widths, 32-channel heads) on cuda (both kernels) vs cpu
  slice_full   full-width BicubicUNet, 13-frame 64² clip → 512², ddim25
  slice_full_gaussian  full-width BlurUNet, 10-frame 128² clip → 512²,
               gaussian task, ddim25
  profile_step (only when asked for) one denoiser call of each full-width
               model under torch.profiler: device time by kernel, idle share

Then, on the lines before the last: one {"kernels": [...]} record and the
card as nvidia-smi names it. The last line is the {"ok": ...} record.
With no CUDA device the script exits non-zero before printing any result.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from flair_tpu_torch.diffusion import GuidanceConfig, make_task_diffusion
from flair_tpu_torch.models.adm import BlurUNet
from flair_tpu_torch.models.registry import get_model
from flair_tpu_torch.models.sr3 import BicubicUNet
from flair_tpu_torch.ops.attention import dot_product_attention, flash_attention
from flair_tpu_torch.ops.dcn import deform_conv2d_raw
from flair_tpu_torch.ops.deform import deform_conv2d_raw_plain
from flair_tpu_torch.pipeline.video import (
    TASK_CONFIGS, init_from_degraded, restore_video, rnn_input_for,
    window_slices)
from flair_tpu_torch.pipeline.wrappers import wrap_bicubic_model, wrap_blur_model
from flair_tpu_torch.utils import build
from flair_tpu_torch.utils.convert import (
    from_flax_bicubic_unet, from_flax_blur_unet)

ALL_PHASES = ("device", "build", "kernel_dcn", "kernel_flash", "slice_small",
              "slice_small_blur", "slice_full", "slice_full_gaussian")
EXTRA_PHASES = ("profile_step",)
ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BW = 3.35e12       # H100 SXM HBM3 bytes/s (data sheet)
PEAK_BF16 = 989e12     # dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12       # float32 outside the tensor cores
DCN_MRMS = (10.0, 5.0)  # max residue magnitude: BlurUNet sites, SR3 sites
DCN_G = 16
DCN_SHAPES = ((512, 128, 64), (256, 256, 128))   # (H=W, Cin, Cout), B=1
DCN_TOL = 3e-2         # max abs error, bf16 kernel vs f32 plain, unit outputs
DCN_TOL_REL = 1e-2     # the same over the largest |output|: bf16 rounding
# K2 at the BlurUNet's attention sites, one 10-frame window, D = 64:
# (S, heads, dtype, calls per denoiser step)
FLASH_N, FLASH_D = 10, 64
FLASH_SHAPES = ((1024, 4, torch.bfloat16, 5), (256, 8, torch.bfloat16, 5),
                (64, 8, torch.bfloat16, 6), (256, 8, torch.float32, 0))
# max abs / max rel (over the largest |output|) error against the f32 plain
# twin: bf16 rounds P before P·V and rounds the output; f32 differs by the
# order of its sums and exp2f
FLASH_TOL = {torch.bfloat16: (1e-2, 2e-2), torch.float32: (1e-5, 1e-5)}
SMALL_PSNR_DB = 50.0   # cuda kernel vs cpu plain, f32 end to end
FULL_STEPS = "ddim25"
SLEEP_CYCLES_PER_CALL = 400_000   # ~0.2 ms at the H100's SM clock
DCN_PER_STEP = {"slice_full": 108, "slice_full_gaussian": 180}
FLASH_PER_STEP = {"slice_full": 0, "slice_full_gaussian": 16}


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, batches: int = 5) -> float:
    """Device time of one ``fn`` call: the median over ``batches`` of the
    CUDA-event time of ``reps`` back-to-back calls, divided by ``reps``,
    after ``warmup`` calls. Each batch is queued behind a sleep kernel, so
    the host enqueues it while the card waits and the events time the
    kernels, not the host's launch latency (tens of µs a call, more than a
    small kernel takes)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return float(np.median(times))


# ---------------------------------------------------------------- phases ----


def phase_device(ctx):
    ctx["smi"] = nvidia_smi()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": ctx["smi"],
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build(ctx):
    """One blocking nvcc per source, one after the other: the whole build
    takes about 10 s, too little for parallel builds to matter."""
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.time()
    logs = {n: build.compile_source(n) for n in names}
    secs = time.time() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit({"phase": "build", "sources": names, "seconds": round(secs, 3),
          "ptxas": ptxas})


def dcn_inputs(h, cin, cout, seed, device):
    """Main-path-shaped raw DCN inputs: smooth flows of a few pixels plus
    tanh residues, bf16 x and raw blocks, seeded."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    a, gk = 2, DCN_G * 9
    yy = torch.arange(h, device=device).view(1, h, 1, 1) / h
    xx = torch.arange(h, device=device).view(1, 1, h, 1) / h
    ph = torch.rand((1, 1, 1, a), generator=gen, device=device) * 6.28
    flow_y = (3.0 * torch.sin(2 * math.pi * (yy + xx) + ph)).expand(
        1, h, h, a).contiguous()
    flow_x = (3.0 * torch.cos(2 * math.pi * (yy - 2 * xx) + ph)).expand(
        1, h, h, a).contiguous()
    bf = torch.bfloat16
    x = randn(1, h, h, cin).to(bf)
    raw = randn(1, h, h, 3 * gk).to(bf)        # one NHWC tensor, as vsrpp
    res_y, res_x, mlog = raw[..., :gk], raw[..., gk:2 * gk], raw[..., 2 * gk:]
    weight = randn(cout, cin, 3, 3, scale=1.0 / math.sqrt(9 * cin))
    bias = randn(cout, scale=0.1)
    return x, res_y, res_x, mlog, flow_y, flow_x, weight, bias


def dcn_bound_ms(h, cin, cout, x_bytes):
    px = h * h
    gk = DCN_G * 9
    nbytes = (px * cin * x_bytes + 3 * px * gk * x_bytes + 2 * px * 2 * 4
              + px * cout * x_bytes + 9 * cin * cout * 4 + cout * 4)
    flops = 2.0 * px * 9 * cin * cout
    t_bytes = nbytes / MEM_BW * 1e3
    t_ops = flops / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


def phase_kernel_dcn(ctx):
    dev = torch.device("cuda")
    rows = []
    for mrm in DCN_MRMS:
        for i, (h, cin, cout) in enumerate(DCN_SHAPES):
            args = dcn_inputs(h, cin, cout, seed=100 + i, device=dev)
            x, ry, rx, ml, fy, fx, w, b = args
            saved = deform_conv2d_raw.launches
            out = deform_conv2d_raw(*args, mrm)
            torch.cuda.synchronize()
            with torch.no_grad():
                ref = deform_conv2d_raw_plain(x.float(), ry.float(), rx.float(),
                                              ml.float(), fy, fx, w, b, mrm)
            err = (out.float() - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            ms = cuda_ms(lambda: deform_conv2d_raw(*args, mrm), reps=20)
            plain_ms = cuda_ms(lambda: deform_conv2d_raw_plain(*args, mrm),
                               reps=3, warmup=1, batches=1)
            deform_conv2d_raw.launches = saved   # comparisons do not count
            bound, by, nbytes, flops = dcn_bound_ms(h, cin, cout, 2)
            row = {"shape": f"x(1,{h},{h},{cin})->{cout}", "mrm": mrm,
                   "max_abs_err": err, "max_rel_err": rel, "tol_abs": DCN_TOL,
                   "tol_rel": DCN_TOL_REL, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "bytes": nbytes, "flop": flops,
                   "tflops": flops / ms / 1e9, "card": ctx["smi"]}
            emit({"phase": "kernel_dcn", **row})
            rows.append(row)
            if not (err <= DCN_TOL and rel <= DCN_TOL_REL):
                raise AssertionError(
                    f"dcn kernel disagrees at {row['shape']} M={mrm}: "
                    f"abs {err} (tol {DCN_TOL}), rel {rel} (tol {DCN_TOL_REL})")
    ctx["dcn_rows"] = rows


def flash_bound_ms(bh, s, d, dtype):
    """q, k, v read once and o written once; 4·BH·S²·D FLOP for the two
    products, at the tensor-core bf16 rate or the CUDA-core f32 rate."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * bh * s * d * elt
    flops = 4.0 * bh * s * s * d
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_bytes = nbytes / MEM_BW * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


def phase_kernel_flash(ctx):
    """K2 on views of a packed seeded qkv, as the attention blocks give it,
    against the f32 plain twin on the same inputs; times of the kernel, of
    the plain twin in the working dtype, and of one SDPA call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rows = []
    for i, (s, heads, dtype, per_step) in enumerate(FLASH_SHAPES):
        n, d = FLASH_N, FLASH_D
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        qkv = torch.randn((n, s, heads * 3 * d), generator=gen,
                          device=dev).to(dtype)
        q, k, v = qkv.view(n, s, heads, 3, d).unbind(dim=3)
        saved = flash_attention.launches
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = dot_product_attention(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ms = cuda_ms(lambda: flash_attention(q, k, v), reps=20)
        plain_ms = cuda_ms(lambda: dot_product_attention(q, k, v), reps=20)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh), reps=20)
        flash_attention.launches = saved    # comparisons do not count
        bound, by, nbytes, flops = flash_bound_ms(n * heads, s, d, dtype)
        tol_abs, tol_rel = FLASH_TOL[dtype]
        row = {"shape": f"qkv({n},{s},{heads}x3x{d})", "dtype": str(dtype),
               "calls_per_step": per_step, "max_abs_err": err,
               "max_rel_err": rel, "tol_abs": tol_abs, "tol_rel": tol_rel,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "flop": flops, "tflops": flops / ms / 1e9, "card": ctx["smi"]}
        emit({"phase": "kernel_flash", **row})
        rows.append(row)
        if not (err <= tol_abs and rel <= tol_rel):
            raise AssertionError(f"flash kernel disagrees at {row['shape']} "
                                 f"{dtype}: abs {err} (tol {tol_abs}), "
                                 f"rel {rel} (tol {tol_rel})")
    ctx["flash_rows"] = rows


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def golden(name):
    gold = os.path.join(ROOT, "goldens", name)
    with open(os.path.join(gold, "meta.json")) as f:
        meta = json.load(f)
    return gold, meta, dict(np.load(os.path.join(gold, "params.npz")))


def small_restore(device):
    """The CPU tests' configuration: goldens/x8_s64 weights and clip (5
    frames, 8² → 64²), windows of 3 overlapping by 1, 4 DDIM steps, noise
    from one numpy seed. Returns the restored (5, 64, 64, 3) clip."""
    gold, _, flat = golden("x8_s64")
    cfg = dataclasses.replace(TASK_CONFIGS["x8_bicubic"], output_size=64,
                              input_size=8, steps="ddim4")
    d = make_task_diffusion(cfg.task, cfg.steps, device=device)
    model = BicubicUNet(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
                        attn_res=(32,), vsrpp_res=(64,), image_size=64,
                        num_frames=3, head_dim=8)
    model.load_state_dict(from_flax_bicubic_unet(flat))
    model.to(device).eval()
    rng = np.random.default_rng(0)
    return restore_video(
        np.load(os.path.join(gold, "degraded01.npy")), cfg,
        wrap_bicubic_model(d, model), diffusion=d,
        guidance=GuidanceConfig(use_aux=False, w=cfg.w, rho=cfg.rho, tau=0),
        win=3, overlap=1, sampler="ddim", device=device,
        noise_fn=lambda shape: rng.standard_normal(shape).astype(np.float32))


def small_blur_restore(task, device):
    """The gaussian / jpeg CPU tests' configuration: goldens/<task>_s64
    weights and clip (5 frames, 16² → 64²) with 32-channel attention heads
    (so K2 has an instance), windows of 3 overlapping by 1, 4 DDIM steps,
    numpy-seeded noise. Returns the restored (5, 64, 64, 3) clip."""
    gold, meta, flat = golden(f"{task}_s64")
    cfg = dataclasses.replace(
        TASK_CONFIGS[task], output_size=64, input_size=16, steps="ddim4",
        w=meta["w"], rho=meta["rho"], zeta=meta["zeta"], tau=meta["tau"],
        noise_level=meta["noise_level"], jpeg_qf=meta.get("jpeg_qf", -1))
    d = make_task_diffusion(cfg.task, cfg.steps, device=device)
    model = BlurUNet(image_size=64, model_channels=32, num_res_blocks=1,
                     attention_resolutions=(2,), rnn_resolutions=(1,),
                     channel_mult=(1, 2), num_head_channels=32)
    model.load_state_dict(from_flax_blur_unet(flat))
    model.to(device).eval()
    rng = np.random.default_rng(1)
    return restore_video(
        np.load(os.path.join(gold, "degraded01.npy")), cfg,
        wrap_blur_model(d, model), diffusion=d,
        guidance=GuidanceConfig(use_aux=False, w=cfg.w, rho=cfg.rho,
                                tau=cfg.tau, zeta=cfg.zeta,
                                noise_level=cfg.noise_level),
        win=3, overlap=1, sampler="ddim", device=device,
        noise_fn=lambda shape: rng.standard_normal(shape).astype(np.float32))


def cuda_vs_cpu(restore, name):
    """f32 with TF32 off: ``restore("cuda")`` through the kernels against
    ``restore("cpu")`` through their twins. Returns the phase record."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = deform_conv2d_raw.launches, flash_attention.launches
    t0 = time.time()
    out_gpu = restore("cuda")
    t_gpu = time.time() - t0
    launches = (deform_conv2d_raw.launches - saved[0],
                flash_attention.launches - saved[1])
    out_cpu = restore("cpu")
    deform_conv2d_raw.launches, flash_attention.launches = saved
    torch.backends.cudnn.allow_tf32 = True
    return {"phase": name, "psnr_db_cuda_vs_cpu": psnr(out_gpu, out_cpu),
            "min_psnr_db": SMALL_PSNR_DB, "dcn_launches": launches[0],
            "flash_launches": launches[1], "seconds_cuda": round(t_gpu, 3),
            "shape": list(out_gpu.shape)}


def phase_slice_small(ctx):
    """The x8 CPU test configuration (goldens' widths, 64², 5 frames, 4
    DDIM steps), f32 everywhere, on cuda through the kernel and on cpu
    through the plain version."""
    rec = cuda_vs_cpu(small_restore, "slice_small")
    emit(rec)
    if not (rec["psnr_db_cuda_vs_cpu"] >= SMALL_PSNR_DB
            and rec["dcn_launches"] > 0):
        raise AssertionError(f"slice_small failed its checks: {rec}")


def phase_slice_small_blur(ctx):
    """The gaussian and jpeg CPU test configurations on cuda (both
    kernels) against cpu (both twins)."""
    for task in ("gaussian", "jpeg"):
        rec = cuda_vs_cpu(lambda dev: small_blur_restore(task, dev),
                          "slice_small_blur")
        rec["task"] = task
        emit(rec)
        if not (rec["psnr_db_cuda_vs_cpu"] >= SMALL_PSNR_DB
                and rec["dcn_launches"] > 0 and rec["flash_launches"] > 0):
            raise AssertionError(f"slice_small_blur failed its checks: {rec}")


def run_full(ctx, name, task, model, make_apply, clip):
    """One main path at full width: every kernel count set to 0 just
    before ``restore_video``, read just after, and held to the expected
    launches per denoiser step × steps × windows."""
    dev = torch.device("cuda")
    cfg = dataclasses.replace(TASK_CONFIGS[task], steps=FULL_STEPS)
    d = make_task_diffusion(cfg.task, cfg.steps, device=dev)
    model_apply = make_apply(d)
    n_windows = len(window_slices(clip.shape[0]))
    steps = d.num_timesteps
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    deform_conv2d_raw.launches = flash_attention.launches = 0
    t0 = time.time()
    out = restore_video(clip, cfg, model_apply, diffusion=d,
                        sampler="ddim", device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = {"dcn_raw": deform_conv2d_raw.launches,
                "flash_attn": flash_attention.launches}
    expect = {"dcn_raw": DCN_PER_STEP[name] * steps * n_windows,
              "flash_attn": FLASH_PER_STEP[name] * steps * n_windows}
    out_size = TASK_CONFIGS[task].output_size
    rec = {"phase": name, "task": task, "steps": FULL_STEPS,
           "windows": n_windows, "shape": list(out.shape),
           "finite": bool(np.isfinite(out).all()),
           "min": float(out.min()), "max": float(out.max()),
           "launches": launches, "launches_expected": expect,
           "seconds_total": round(secs, 3),
           "seconds_per_window": round(secs / n_windows, 3),
           "ms_per_step": secs / (steps * n_windows) * 1e3,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "card": ctx["smi"]}
    emit(rec)
    ctx.setdefault("launches", {})[name] = launches
    ctx.setdefault("full", {})[name] = (task, model, model_apply, clip)
    if not (rec["shape"] == [clip.shape[0], out_size, out_size, 3]
            and rec["finite"] and rec["min"] >= 0.0 and rec["max"] <= 1.0
            and launches == expect):
        raise AssertionError(f"{name} failed its checks: {rec}")


def phase_slice_full(ctx):
    """Full-width BicubicUNet (registry defaults), seeded random weights at
    0.02, bf16 trunk; one 13-frame 64² clip restored to 512² by x8 guided
    DDIM (two windows: the tail padded, overlap pinned)."""
    model = get_model("bicubic_unet", dtype=torch.bfloat16)
    model.random_init(seed=0, scale=0.02)
    model.to("cuda").eval()
    clip = np.random.default_rng(0).uniform(
        0, 1, (13, 64, 64, 3)).astype(np.float32)
    run_full(ctx, "slice_full", "x8_bicubic", model,
             lambda d: wrap_bicubic_model(d, model), clip)


def phase_slice_full_gaussian(ctx):
    """Full-width BlurUNet (registry defaults), seeded random weights at
    0.02, bf16 trunk; one 10-frame 128² clip restored to 512² by gaussian
    guided DDIM (one window)."""
    model = get_model("blur_unet", dtype=torch.bfloat16)
    model.random_init(seed=0, scale=0.02)
    model.to("cuda").eval()
    clip = np.random.default_rng(0).uniform(
        0, 1, (10, 128, 128, 3)).astype(np.float32)
    run_full(ctx, "slice_full_gaussian", "gaussian", model,
             lambda d: wrap_blur_model(d, model), clip)


KERNEL_CLASSES = (   # first match wins, on the lower-cased kernel name
    ("dcn_raw (K1)", ("dcn_raw",)),
    ("flash_attn (K2)", ("flash_fwd",)),
    ("convolution", ("fprop", "conv", "dgrad")),
    ("matmul", ("gemm", "gemv", "cutlass")),
    ("grid_sample", ("sampler",)),
    ("softmax", ("softmax",)),
    ("reduction / norm", ("reduce", "norm", "welford")),
    ("cat / copy", ("cat", "copy")),
    ("elementwise", ("elementwise",)),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def phase_profile_step(ctx):
    """One denoiser call of each full-width model at a window's shape under
    torch.profiler: device time by kernel and by class of kernel, each
    hand-written kernel's share, and the idle share of the call's wall
    time."""
    dev = torch.device("cuda")
    for name, (task, model, model_apply, clip) in ctx["full"].items():
        cfg = TASK_CONFIGS[task]
        frames = torch.as_tensor(clip[None, :10], device=dev)
        init = init_from_degraded(frames, cfg)
        rnn = rnn_input_for(frames, init, cfg)
        x = torch.randn(init.shape, generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
        with torch.no_grad():
            flows = model_apply.flows_fn(rnn)
            call = lambda: model_apply(x, 0, init, rnn, None, flows)  # noqa: E731
            call()
            torch.cuda.synchronize()
            act = [torch.profiler.ProfilerActivity.CPU,
                   torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=act) as prof:
                t0 = time.time()
                call()
                torch.cuda.synchronize()
                wall_ms = (time.time() - t0) * 1e3
        by_name = {}
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
        busy = sum(by_name.values())
        by_class = {}
        for k, v in by_name.items():
            by_class[kernel_class(k)] = by_class.get(kernel_class(k), 0.0) + v
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        emit({"phase": "profile_step", "path": name, "wall_ms": wall_ms,
              "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
              "dcn_ms": by_class.get("dcn_raw (K1)", 0.0),
              "flash_ms": by_class.get("flash_attn (K2)", 0.0),
              "class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
              "top_kernels_ms": [[k[:120], v] for k, v in top],
              "card": ctx["smi"]})
        if busy <= 0:
            raise AssertionError("profile_step: the profiler saw no device time")


def kernel_record(name, source, replaces, rows, launches):
    """One entry of the ``kernels`` line: the numbers of the first shape
    (the main path's costliest), every shape beside them."""
    keys = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get("slice_full_gaussian"),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
            "library_ms": rows[0].get("library_ms"),
            "shapes": [{k: r.get(k) for k in keys} | {"mrm": r.get("mrm"),
                                                      "dtype": r.get("dtype")}
                       for r in rows]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of " + ", ".join(ALL_PHASES + EXTRA_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    ctx: dict = {}
    for name in ["device"] + [p for p in phases if p != "device"]:
        globals()[f"phase_{name}"](ctx)
    launches = {"dcn_raw": {}, "flash_attn": {}}
    for path, counts in ctx.get("launches", {}).items():
        for kern, n in counts.items():
            launches[kern][path] = n
    kernels = []
    if "kernel_dcn" in phases:
        kernels.append(kernel_record(
            "dcn_raw", "flair_tpu_torch/csrc/dcn_raw.cu",
            "flair_tpu/ops/dcn_pallas.py:50", ctx["dcn_rows"],
            launches["dcn_raw"]))
    if "kernel_flash" in phases:
        kernels.append(kernel_record(
            "flash_attn", "flair_tpu_torch/csrc/flash_attn.cu",
            "flair_tpu/ops/attention.py:53", ctx["flash_rows"],
            launches["flash_attn"]))
    if kernels:
        emit({"kernels": kernels})
    print(ctx["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()},
          **({} if phases == list(ALL_PHASES) else {"phases": phases})})
    return 0


if __name__ == "__main__":
    sys.exit(main())
