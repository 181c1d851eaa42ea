"""GPU smoke run of the flair_tpu_torch port: builds the CUDA kernels, holds
each against its plain PyTorch version, and drives the port's main path
(x8_bicubic guided DDIM, face prior off) at full width on one card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernel_dcn

Phases, one JSON line each:
  device      card name, power limit (nvidia-smi)
  build       nvcc of every source in flair_tpu_torch/csrc/
  kernel_dcn  csrc/dcn_raw.cu vs ops/deform.py at both main-path shapes
  slice_small the small test configuration on cuda (kernel) vs cpu (plain)
  slice_full  full-width BicubicUNet, 13-frame 64² clip → 512², ddim25
  profile_step (only when asked for) one denoiser call of slice_full's
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

from flair_tpu_torch.diffusion import GuidanceConfig, make_task_diffusion
from flair_tpu_torch.models.registry import get_model
from flair_tpu_torch.models.sr3 import BicubicUNet
from flair_tpu_torch.ops.dcn import deform_conv2d_raw
from flair_tpu_torch.ops.deform import deform_conv2d_raw_plain
from flair_tpu_torch.pipeline.video import (
    TASK_CONFIGS, init_from_degraded, restore_video, window_slices)
from flair_tpu_torch.pipeline.wrappers import wrap_bicubic_model
from flair_tpu_torch.utils import build
from flair_tpu_torch.utils.convert import from_flax_bicubic_unet

ALL_PHASES = ("device", "build", "kernel_dcn", "slice_small", "slice_full")
EXTRA_PHASES = ("profile_step",)
MEM_BW = 3.35e12       # H100 SXM HBM3 bytes/s (data sheet)
PEAK_BF16 = 989e12     # dense bf16 tensor-core FLOP/s
DCN_MRM = 5.0
DCN_G = 16
DCN_SHAPES = ((512, 128, 64), (256, 256, 128))   # (H=W, Cin, Cout), B=1
DCN_TOL = 3e-2         # max abs error, bf16 kernel vs f32 plain, unit outputs
DCN_TOL_REL = 1e-2     # the same over the largest |output|: bf16 rounding
SMALL_PSNR_DB = 50.0   # cuda kernel vs cpu plain, f32 end to end
FULL_STEPS = "ddim25"


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


# ---------------------------------------------------------------- phases ----


def phase_device(ctx):
    ctx["smi"] = nvidia_smi()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": ctx["smi"],
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build(ctx):
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
    for i, (h, cin, cout) in enumerate(DCN_SHAPES):
        args = dcn_inputs(h, cin, cout, seed=100 + i, device=dev)
        x, ry, rx, ml, fy, fx, w, b = args
        saved = deform_conv2d_raw.launches
        out = deform_conv2d_raw(*args, DCN_MRM)
        torch.cuda.synchronize()
        with torch.no_grad():
            ref = deform_conv2d_raw_plain(x.float(), ry.float(), rx.float(),
                                          ml.float(), fy, fx, w, b, DCN_MRM)
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ms = cuda_ms(lambda: deform_conv2d_raw(*args, DCN_MRM), reps=20)
        plain_ms = cuda_ms(
            lambda: deform_conv2d_raw_plain(*args, DCN_MRM), reps=3, warmup=1)
        deform_conv2d_raw.launches = saved   # comparison launches do not count
        bound, by, nbytes, flops = dcn_bound_ms(h, cin, cout, 2)
        row = {"shape": f"x(1,{h},{h},{cin})->{cout}", "max_abs_err": err,
               "max_rel_err": rel, "tol_abs": DCN_TOL,
               "tol_rel": DCN_TOL_REL, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "bytes": nbytes, "flop": flops,
               "tflops": flops / ms / 1e9, "card": ctx["smi"]}
        emit({"phase": "kernel_dcn", **row})
        rows.append(row)
        if not (err <= DCN_TOL and rel <= DCN_TOL_REL):
            raise AssertionError(f"dcn kernel disagrees at {row['shape']}: "
                                 f"abs {err} (tol {DCN_TOL}), "
                                 f"rel {rel} (tol {DCN_TOL_REL})")
    ctx["dcn_rows"] = rows


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def small_restore(device):
    """The CPU tests' configuration: goldens/x8_s64 weights and clip (5
    frames, 8² → 64²), windows of 3 overlapping by 1, 4 DDIM steps, noise
    from one numpy seed. Returns the restored (5, 64, 64, 3) clip."""
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "x8_s64")
    cfg = dataclasses.replace(TASK_CONFIGS["x8_bicubic"], output_size=64,
                              input_size=8, steps="ddim4")
    d = make_task_diffusion(cfg.task, cfg.steps, device=device)
    model = BicubicUNet(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
                        attn_res=(32,), vsrpp_res=(64,), image_size=64,
                        num_frames=3, head_dim=8)
    model.load_state_dict(from_flax_bicubic_unet(
        dict(np.load(os.path.join(gold, "params.npz")))))
    model.to(device).eval()
    rng = np.random.default_rng(0)
    return restore_video(
        np.load(os.path.join(gold, "degraded01.npy")), cfg,
        wrap_bicubic_model(d, model), diffusion=d,
        guidance=GuidanceConfig(use_aux=False, w=cfg.w, rho=cfg.rho, tau=0),
        win=3, overlap=1, sampler="ddim", device=device,
        noise_fn=lambda shape: rng.standard_normal(shape).astype(np.float32))


def phase_slice_small(ctx):
    """The CPU test configuration (goldens' widths, 64², 5 frames, 4 DDIM
    steps), f32 everywhere, on cuda through the kernel and on cpu through
    the plain version."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = deform_conv2d_raw.launches
    t0 = time.time()
    out_gpu = small_restore("cuda")
    t_gpu = time.time() - t0
    launches = deform_conv2d_raw.launches - saved
    out_cpu = small_restore("cpu")
    deform_conv2d_raw.launches = saved
    torch.backends.cudnn.allow_tf32 = True
    p = psnr(out_gpu, out_cpu)
    emit({"phase": "slice_small", "psnr_db_cuda_vs_cpu": p,
          "min_psnr_db": SMALL_PSNR_DB, "dcn_launches": launches,
          "seconds_cuda": round(t_gpu, 3), "shape": list(out_gpu.shape)})
    if not (p >= SMALL_PSNR_DB and launches > 0):
        raise AssertionError(f"slice_small: {p} dB, {launches} launches")


def phase_slice_full(ctx):
    """Full-width BicubicUNet (registry defaults), seeded random weights at
    0.02, bf16 trunk; one 13-frame 64² clip restored to 512² by x8 guided
    DDIM (two windows: the tail padded, overlap pinned)."""
    dev = torch.device("cuda")
    cfg = TASK_CONFIGS["x8_bicubic"]
    d = make_task_diffusion(cfg.task, FULL_STEPS, device=dev)
    model = get_model("bicubic_unet", dtype=torch.bfloat16)
    model.random_init(seed=0, scale=0.02)
    model.to(dev).eval()
    model_apply = wrap_bicubic_model(d, model)
    clip = np.random.default_rng(0).uniform(
        0, 1, (13, 64, 64, 3)).astype(np.float32)
    n_windows = len(window_slices(clip.shape[0]))
    steps = d.num_timesteps
    torch.cuda.reset_peak_memory_stats()
    deform_conv2d_raw.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out = restore_video(clip, cfg, model_apply, diffusion=d, sampler="ddim",
                        device=dev, generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = deform_conv2d_raw.launches
    expect = 108 * steps * n_windows
    rec = {"phase": "slice_full", "steps": FULL_STEPS,
           "windows": n_windows,
           "shape": list(out.shape), "finite": bool(np.isfinite(out).all()),
           "min": float(out.min()), "max": float(out.max()),
           "dcn_launches": launches, "dcn_launches_expected": expect,
           "seconds_total": round(secs, 3),
           "seconds_per_window": round(secs / n_windows, 3),
           "ms_per_step": secs / (steps * n_windows) * 1e3,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "card": ctx["smi"]}
    emit(rec)
    ctx["dcn_launches_main"] = launches
    ctx["full"] = (model, model_apply, d, clip)
    if not (rec["shape"] == [13, 512, 512, 3] and rec["finite"]
            and rec["min"] >= 0.0 and rec["max"] <= 1.0
            and launches == expect):
        raise AssertionError(f"slice_full failed its checks: {rec}")


KERNEL_CLASSES = (   # first match wins, on the lower-cased kernel name
    ("dcn_raw (K1)", ("dcn_raw",)),
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
    """One denoiser call of slice_full's model at a window's shape under
    torch.profiler: device time by kernel and by class of kernel, the DCN's
    share, and the idle share of the call's wall time."""
    model, model_apply, d, clip = ctx["full"]
    dev = torch.device("cuda")
    cfg = TASK_CONFIGS["x8_bicubic"]
    frames = torch.as_tensor(clip[None, :10], device=dev)
    init = init_from_degraded(frames, cfg)
    x = torch.randn(init.shape, generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    with torch.no_grad():
        flows = model_apply.flows_fn(init)
        call = lambda: model_apply(x, 0, init, init, None, flows)  # noqa: E731
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
    dcn = sum(v for k, v in by_name.items() if "dcn_raw" in k)
    by_class = {}
    for k, v in by_name.items():
        by_class[kernel_class(k)] = by_class.get(kernel_class(k), 0.0) + v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "profile_step", "wall_ms": wall_ms, "device_ms": busy,
          "idle_share": 1.0 - busy / wall_ms, "dcn_ms": dcn,
          "dcn_share_of_device": dcn / busy if busy else None,
          "class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
          "top_kernels_ms": [[k[:120], v] for k, v in top],
          "card": ctx["smi"]})
    if busy <= 0:
        raise AssertionError("profile_step: the profiler saw no device time")


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
    if "kernel_dcn" in phases:
        rows = ctx["dcn_rows"]
        kern = {
            "name": "dcn_raw", "route": "cuda",
            "source": "flair_tpu_torch/csrc/dcn_raw.cu",
            "replaces": "flair_tpu/ops/dcn_pallas.py:50",
            "launches": ctx.get("dcn_launches_main"),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
            "library_ms": None,
            "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "max_abs_err")} for r in rows],
        }
        emit({"kernels": [kern]})
    print(ctx["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()},
          **({} if phases == list(ALL_PHASES) else {"phases": phases})})
    return 0


if __name__ == "__main__":
    sys.exit(main())
