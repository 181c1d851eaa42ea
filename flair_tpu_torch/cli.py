"""Command-line interface: restore a folder of PNG frames on the GPU.

    python -m flair_tpu_torch.cli x8_bicubic --input-dir frames/ \\
        --output-dir out/ --sampler ddim --steps 25

Counterpart of ``flair_tpu/cli.py`` with its four tasks (x8_bicubic,
x16_bicubic, gaussian, jpeg), flags, defaults and output layout
(``<output-dir>/0000.png``..., or ``<output-dir>/<clip>/`` with
``--input-dirs``). Where it differs:

- ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions
  in float32). Without CUDA the default raises; nothing falls back.
- ``--sampler`` takes ``steps``, ``scan``, ``scan_p`` and ``ddim``: the
  first three are the JAX package's dispatch forms of one ddpm ρ rule, and
  all run the port's ``steps`` loop.
- ``--exact-dcn`` is accepted and changes nothing: the port's deformable
  conv is exact.
- ``--input-dir`` has no default; give it or ``--input-dirs``.
- ``--checkpoint`` is loaded for the task's model by name, so an upstream
  ``.pt`` / ``.pth`` works as well as a flat flax ``.npz``.
- PNGs are read and written by ``utils.png``, not cv2; there is no XLA
  compile cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys
from pathlib import Path

import numpy as np
import torch

from .diffusion import make_task_diffusion
from .face.helper import FaceRestoreHelper
from .models.codeformer import CodeFormer
from .models.parsenet import ParseNet
from .models.registry import get_model
from .models.retinaface import RetinaFace, RetinaFaceDetector
from .pipeline.video import TASK_CONFIGS, restore_video, scale_tau
from .pipeline.wrappers import (
    wrap_bicubic_model, wrap_blur_model, wrap_codeformer, wrap_parsenet)
from .utils.checkpoint import load_params
from .utils.device import resolve_device
from .utils.png import read_png, write_png

TASKS = ("x8_bicubic", "x16_bicubic", "gaussian", "jpeg")
# the JAX package's samplers: "steps", "scan" and "scan_p" are its dispatch
# forms of the ddpm ρ rule, which the port runs as one loop
SAMPLERS = {"steps": "steps", "scan": "steps", "scan_p": "steps",
            "ddim": "ddim"}


def load_frames(input_dir: str) -> np.ndarray:
    """Natural-sorted PNG frames → (T, h, w, 3) RGB in [0, 1]
    (video_sample.py:337-345)."""

    def natkey(p):
        return [int(s) if s.isdigit() else s for s in re.split(r"(\d+)", p.name)]

    paths = sorted(Path(input_dir).glob("*.png"), key=natkey)
    if not paths:
        raise FileNotFoundError(f"no PNG frames in {input_dir}")
    frames = [read_png(str(p)) for p in paths]
    return np.stack(frames).astype(np.float32) / 255.0


def save_frames(frames01: np.ndarray, output_dir: str) -> None:
    """(T, H, W, 3) [0, 1] → ``{i:04d}.png`` (video_sample.py:487-492)."""
    os.makedirs(output_dir, exist_ok=True)
    for i, f in enumerate(frames01):
        img = (np.clip(f, 0, 1) * 255).astype(np.uint8)
        write_png(str(Path(output_dir) / f"{i:04d}.png"), img)


def _dtype(dev: torch.device) -> torch.dtype:
    """bf16 on the card, float32 on the CPU."""
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def build_model(task: str, checkpoint: str | None, *, device=None):
    """The task's denoiser on ``device`` (default cuda), in eval mode, bf16
    on the card and float32 on the CPU.

    With ``checkpoint`` (a flat flax ``.npz`` or an upstream ``.pt`` /
    ``.pth``) its weights load strictly; without, seeded random weights
    (N(0, 0.02²), seed 0) give shape-correct runs."""
    dev = resolve_device(device)
    name = TASK_CONFIGS[task].model_name
    model = get_model(name, dtype=_dtype(dev))
    if checkpoint:
        model.load_state_dict(load_params(checkpoint, name), strict=True)
    else:
        model.random_init(seed=0, scale=0.02)
    return model.to(dev).eval()


def build_face_stack(task: str, *, checkpoint_dir: str | None = None,
                     output_size: int = 512, device=None):
    """RetinaFace ResNet50 → ``FaceRestoreHelper``, and the CodeFormer and
    ParseNet appliers, on ``device`` (reference: video_sample.py:332,
    351-359, 446-479). Weights load from ``checkpoint_dir``
    (``{retinaface,codeformer,parsenet}.{npz,pt,pth}``) when there; seeded
    random ones otherwise. The detector runs in float32; CodeFormer and
    ParseNet in bf16 on the card. ``task`` is taken, as the JAX package
    takes it, and not read: every task builds the same stack.

    Returns (face_helper, codeformer_apply, parsenet_apply)."""
    dev = resolve_device(device)

    def load(model, name, seed):
        paths = ([os.path.join(checkpoint_dir, name + ext)
                  for ext in (".npz", ".pt", ".pth", "")]
                 if checkpoint_dir else [])
        path = next((q for q in paths if os.path.exists(q)), None)
        if path:
            model.load_state_dict(load_params(path, name), strict=True)
        else:
            model.random_init(seed=seed, scale=0.02)
        return model.to(dev).eval()

    det = load(RetinaFace(network="resnet50"), "retinaface", 0)
    helper = FaceRestoreHelper(RetinaFaceDetector(det), face_size=output_size)
    cf = load(CodeFormer(dtype=_dtype(dev)), "codeformer", 1)
    pn = load(ParseNet(dtype=_dtype(dev)), "parsenet", 2)
    return helper, wrap_codeformer(cf), wrap_parsenet(pn)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="flair_tpu_torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="task", required=True)
    for task in TASKS:
        sp = sub.add_parser(task)
        sp.add_argument("--input-dir", default=None)
        sp.add_argument("--input-dirs", default=None,
                        help="comma-separated clip dirs restored BATCHED "
                             "(clips must share frame count and "
                             "resolution). Outputs go to "
                             "<output-dir>/<clip-name>/")
        sp.add_argument("--output-dir", default=f"./results/{task}")
        sp.add_argument("--checkpoint", default=None,
                        help="denoiser weights: flat flax .npz or upstream "
                             ".pt / .pth")
        sp.add_argument("--steps", default=None)
        sp.add_argument("--w", type=float, default=None)
        sp.add_argument("--rho", type=float, default=None)
        sp.add_argument("--noise-level", type=float, default=None)
        sp.add_argument("--zeta", type=float, default=None)
        sp.add_argument("--tau", type=int, default=None)
        sp.add_argument("--jpeg-qf", type=int, default=None)
        sp.add_argument("--frames", type=int, default=None,
                        help="restore only the first N frames")
        sp.add_argument("--exact-dcn", action="store_true",
                        help="accepted for the JAX CLI; the port's "
                             "deformable conv is always exact")
        sp.add_argument("--no-face", action="store_true",
                        help="disable the CodeFormer face prior")
        sp.add_argument("--face-checkpoint-dir", default=None,
                        help="dir with retinaface/codeformer/parsenet "
                             "weights (.npz, .pt or .pth)")
        sp.add_argument("--t-start", type=int, default=-1)
        sp.add_argument("--window", type=int, default=10)
        sp.add_argument("--overlap", type=int, default=3)
        sp.add_argument("--sampler", choices=tuple(SAMPLERS),
                        default="steps",
                        help="'steps' (and the JAX package's 'scan' / "
                             "'scan_p'): FLAIR's ddpm ρ rule; 'ddim': the "
                             "η-DDIM update, the fast serving path (pair "
                             "with --steps 25)")
        sp.add_argument("--eta", type=float, default=0.0,
                        help="DDIM stochasticity η (only with --sampler ddim)")
        sp.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> int:
    p = make_parser()
    args = p.parse_args(argv)
    if not (args.input_dir or args.input_dirs):
        p.error("give --input-dir or --input-dirs")
    dev = resolve_device(args.device)

    cfg = TASK_CONFIGS[args.task]
    steps = args.steps
    if steps is not None and args.sampler == "ddim" and steps.isdigit():
        # `--sampler ddim --steps 25` → the reference's exact-stride "ddimN"
        # respacing (respace.py:23-31)
        steps = f"ddim{steps}"
    overrides = {
        k: v
        for k, v in dict(
            steps=steps, w=args.w, rho=args.rho,
            noise_level=args.noise_level, zeta=args.zeta, tau=args.tau,
            jpeg_qf=args.jpeg_qf,
        ).items()
        if v is not None
    }
    if args.t_start != -1:
        overrides["t_start"] = args.t_start
    cfg = dataclasses.replace(cfg, **overrides)

    clip_names = None
    if args.input_dirs:
        dirs = [s.strip() for s in args.input_dirs.split(",") if s.strip()]
        clip_names = [Path(s).name or f"clip{i}" for i, s in enumerate(dirs)]
        # basenames can collide (/a/frames, /b/frames): disambiguate so one
        # clip's outputs do not overwrite another's
        seen: dict = {}
        for i, name in enumerate(clip_names):
            if name in seen:
                clip_names[i] = f"{name}_{i}"
            seen[name] = i
        clips = [load_frames(s) for s in dirs]
        if args.frames:
            clips = [c[: args.frames] for c in clips]
        shapes = {c.shape for c in clips}
        if len(shapes) != 1:
            p.error(f"--input-dirs clips differ in shape: {sorted(shapes)}")
        frames = np.stack(clips)  # (B, T, h, w, 3)
    else:
        frames = load_frames(args.input_dir)
        if args.frames:
            frames = frames[: args.frames]

    d = make_task_diffusion(cfg.task, cfg.steps, device=dev)
    if args.tau is None and d.num_timesteps != 100:
        # the demo's tau is in 100-respaced-step units: keep the same
        # FRACTION of the trajectory when the user respaces
        cfg = dataclasses.replace(cfg, tau=scale_tau(cfg.tau, d.num_timesteps))
    model = build_model(args.task, args.checkpoint, device=dev)
    wrap = (wrap_bicubic_model if cfg.model_name == "bicubic_unet"
            else wrap_blur_model)
    model_apply = wrap(d, model)

    face_helper = codeformer_apply = parsenet_apply = None
    if not args.no_face:
        face_helper, codeformer_apply, parsenet_apply = build_face_stack(
            args.task, checkpoint_dir=args.face_checkpoint_dir,
            output_size=cfg.output_size, device=dev)

    out = restore_video(
        frames, cfg, model_apply, diffusion=d,
        face_helper=face_helper,
        codeformer_apply=codeformer_apply,
        parsenet_apply=parsenet_apply,
        win=args.window, overlap=args.overlap,
        sampler=SAMPLERS[args.sampler], eta=args.eta, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0),
    )
    if clip_names is not None:
        for name, clip in zip(clip_names, out):
            save_frames(clip, os.path.join(args.output_dir, name))
        print(f"wrote {out.shape[0]} clips x {out.shape[1]} frames to "
              f"{args.output_dir}")
    else:
        save_frames(out, args.output_dir)
        print(f"wrote {out.shape[0]} frames to {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
