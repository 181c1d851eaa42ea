"""GPU smoke run of the flair_tpu_torch port: builds the CUDA kernels, holds
each against its plain PyTorch version, and drives the port's main paths
(x8_bicubic guided DDIM with the face prior on and off, gaussian) at full
width on one card, then the entry point itself (``flair_tpu_torch.cli``,
x8 with RetinaFace detection and jpeg, on PNG clips), training (with AMT
densifying ``skip = 2`` clips), the frame interpolators and DAVSRNet, the
alternative face models (VQFR, RestoreFormer, VQVAEGAN, BiSeNet,
YOLOv5-face), and the multi-device paths (frame-sharded restoration and
data- / frame-parallel training, as ranks sharing the card).

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernel_dcn,kernel_flash

Phases, one JSON line each (a record per shape for the kernels):
  device       card name, power limit (nvidia-smi)
  build        nvcc of every source in flair_tpu_torch/csrc/, all started
               together
  kernel_dcn   csrc/dcn_raw.cu vs ops/deform.py at both main-path shapes,
               max residue magnitude 5 (x8 path) and 10 (gaussian path),
               timed; then correctness-only rows (DCN_EDGE): ragged pixel
               counts, B = 2, raw blocks as views and as separate tensors,
               flows past every border, every Cout, Cin/G of 8 to 32;
               before them one timed float32 row at DAVSRNet's alignment
               shape (G = 8, (1, 256², 128) → 64, M = 10, DCN_F32_TOL);
               then gradient rows (the autograd Function: kernel forward,
               plain float32 backward, against the plain version's own
               autograd on float32 copies, all eight inputs, backward
               timed) at both main-path shapes in bf16, M = 5, and one f32;
               then the int8 instance (``int8_dots``, FLAIR_DCN_INT8) at
               both main-path shapes and M against its int8 twin
               (DCN_INT8_TOL, and DCN_INT8_SEPARATION: the kernel without
               the flag stays farther from the twin), timed beside the
               bf16 instance on the same inputs, with the quantise pass
               timed alone; then int8 correctness-only rows over
               DCN_INT8_EDGE, DCN_INT8_EXTRA and one f32-x row at
               DAVSRNet's shape
  kernel_flash csrc/flash_attn.cu vs ops/attention.dot_product_attention at
               the BlurUNet's three attention shapes (bf16) and one f32 row,
               timed beside SDPA (and the kernel SDPA ran, from the
               profiler); then correctness-only rows at ragged S on both
               sides of each query-tile switch and at D = 32, V a ramp;
               then gradient rows at S = 256 (bf16, f32)
  kernel_probe csrc/probe_dot.cu (tools/probe_int8.py's dot_kernel): the
               entry point ``python -m flair_tpu_torch.tools.probe_int8
               [uvp]`` in process at UVP 256 and 384 (its launches counted),
               then each of the three variants timed at the TPU constants
               (GRID 1024, REPS 32, BC 576) and held against its plain
               version there, beside REPS torch.bmm (bf16) /
               torch._int_mm (int8) calls, their layout copy timed apart,
               each with its share of the bound, and the int8 variants'
               speed-up over bf16 at each UVP; then correctness-only rows
               (PROBE_EDGE, PROBE_CHECK_GRID grid steps): one K tile, rings
               that never fill, BC of one block, REPS 1-3, ramps, int32
               sums at their extreme, quantised ties; then the quantised
               variant's SASS: every rounding inside its REPS loop
  kernel_norm  csrc/group_norm.cu (ops/norms.group_norm_act, SiLU, bf16)
               at the main path's NORM_SHAPES against the plain version in
               float32, timed beside the plain composition in bf16 (the
               models' old sequence of about ten passes), with its bound
               (3 S: x read twice, y written once, at 3.35 TB/s)
  kernel_vsrpp csrc/vsrpp_step.cu (ops/vsrpp_step: BasicVSR++'s per-frame
               glue) at the main path's VSRPP_SHAPES, bf16, and DAVSRNet's
               float32 width: the warp of the hidden pair, the bias passes
               after each conv (the offset head's 27·G channels included)
               and the gated tail, each against its plain version in
               float32, one launch a call, timed beside the plain
               composition in the working dtype and the bound (bytes read
               and written once at 3.35 TB/s)
  slice_small  the x8 test configuration on cuda (kernel) vs cpu (plain)
  slice_small_blur  the gaussian and jpeg test configurations (goldens'
               widths, 32-channel heads) on cuda (both kernels) vs cpu;
               SuperResModel and EncoderUNetModel at the CPU tests' size
               (tests/test_torch_adm.py), seeded random weights, cuda vs cpu
  slice_small_face  slice_small with the face prior on: small seeded
               CodeFormer / ParseNet at 64², fixed matrices, cuda vs cpu
  slice_small_train  one training step (``train.make_train_step``) of the
               goldens' x8 model, f32, B = 1, T = 3, 64², fixed t and noise,
               on cuda (K1, the norm kernel) vs cpu (plain): loss,
               grad_norm, every gradient, the updated parameters and the EMA
               stream; then the same for the goldens' gaussian BlurUNet with
               remat (32-channel heads: K1 and K2, each launched twice a
               site); the norm kernel 3 times a GroupNorm32 call
  train_full   the x8 BicubicUNet at the registry defaults training through
               ``train.TrainRunner`` (bf16 trunk, float32 parameters, AdamW,
               one EMA stream), B = 1, T = TRAIN_T at 512²: a warm-up step,
               TRAIN_STEPS timed steps (K1 launches per step held), the
               forward / backward split of one more pass by CUDA events,
               every gradient finite and non-zero; then a save, a new runner
               that resumes (its state equal to the saved one) and a step;
               then the same model with remat (``use_checkpoint``) at
               T = REMAT_T: a warm-up and one timed step, peak, K1 launches;
               then that row with skip = 2: 3 conditioning frames densified
               to REMAT_T by AMT-G inside TrainRunner, AMT's ms in the step,
               no AMT parameter with a gradient or optimizer state
  train_full_blur  the BlurUNet at the registry defaults with remat, bf16
               trunk, training through ``TrainRunner`` on the gaussian
               task's 1000-step schedule (LEARNED_RANGE: the VB term),
               B = 1, T = 5 at 512², conditioning built as restore_video's
               blur branch builds it: a warm-up, BLUR_STEPS timed steps (K1
               and K2 launches per step held), the forward / backward split,
               peak, every gradient finite and non-zero
  slice_small_interp  the CPU tests' SuperSloMo, tiny AMT and small
               DAVSRNet (K1 f32, G = 2) on cuda vs cpu, f32, TF32 off
  interp_full  AMT-G and SuperSloMo (registry defaults, f32) on one 512²
               pair at factor 2: ms a call, peak, outputs finite
  davsr_full   DAVSRNet at the registry defaults (f32, G = 8) on a 3-frame
               64² clip → 15 frames at 256²: K1 launches held (112), ms a
               forward, peak, output finite
  slice_full   full-width BicubicUNet, 13-frame 64² clip → 512², ddim25;
               in every slice_full* and training phase the BasicVSR++
               step kernels' launches are held to VSR++ calls (each remat
               recompute a call) × vsrpp_expected
  slice_full_int8  slice_full again with FLAIR_DCN_INT8=1: the same model,
               clip and noise through K1's int8 instance (5 400 int8
               launches, no bf16 one), ms a step beside slice_full's, peak,
               PSNR against slice_full's output (> SLICE_INT8_PSNR_DB,
               and not equal to it)
  slice_full_gaussian  full-width BlurUNet, 10-frame 128² clip → 512²,
               gaussian task, ddim25
  slice_full_face  slice_full with the face prior on: CodeFormer and
               ParseNet at the JAX defaults, bf16, bench.py's fixed matrix;
               face calls timed with CUDA events around each
  detector     RetinaFace ResNet50 (f32, seeded random weights) on one 512²
               frame: cuda (TF32 off) against cpu on the same weights
               (loc / conf / landms), network timed with CUDA events, host
               decode + NMS with perf_counter; detect_faces' boxes with NMS
               at 0.4 on a second seeded model whose scores spread, the
               threshold set where each passing score is DET_GAP errors
               from the next
  cli          flair_tpu_torch.cli.main in process, seeded random weights,
               on PNG clips written here: x8_bicubic --sampler ddim --steps
               25 with the face stack on (10 frames, 64²) and jpeg ... --no-face
               (10 frames, 128²); K1 / K2 launches held to the expected
               counts, 10 finite 512² PNGs read back per run
  slice_small_priors  the CPU tests' VQFR (Predict and Nearest),
               RestoreFormer, VQVAEGAN, BiSeNet, YOLOv5Face and the
               yolov5n-face YOLOv5FromConfig (tests/test_torch_alt_priors.py,
               tests/test_torch_face_parsers.py), seeded weights, and
               SuperResolution's operators, f32 with TF32 off, cuda vs cpu:
               equal codes (smallest top-2 margin printed), every output
               within PRIOR_TOL of its largest |value|, no K1 / K2 launch
  priors_full  vqfr, restoreformer, vqvaegan, bisenet and yolov5face at
               their registry defaults, seeded random weights at 0.02, f32,
               one PRIOR_SIZE² image: ms a forward (CUDA events, the median
               of 5 after a warm-up), peak memory, outputs finite, no K1 /
               K2 launch (the plain DCN in VQFR, plain attention), VQFR's
               plain-DCN ms a forward, YOLOv5-face's host decode + NMS of
               the PRIOR_DETS best-scoring anchors
  sharded_small  slice_small's x8 and gaussian restores with windows of 4
               (2 frames a rank) on SHARD_RANKS gloo ranks sharing this
               card (cuda:0) and on one NCCL rank (NCCL takes no two ranks
               on one card), f32, TF32 off, against one unsharded process:
               every rank's clip within SHARDED_SMALL_TOL, K1 (and K2)
               launched on every rank, the norm kernel on none (a frame
               group takes the plain norm)
  sharded_full  slice_full's x8 model on one 10-frame 64² window → 512²,
               ddim25, face off, unsharded, then split over SHARD_RANKS
               gloo ranks (5 frames each) on the same noise: PSNR >
               SHARDED_FULL_PSNR_DB, per rank ms a step, bytes gathered,
               K1 launches (the unsharded count: every rank runs the whole
               VSR++ recurrence), norm launches (none on a rank), peak, each
               VSR++ site's gather timed alone
  train_dp     train_full's remat x8 model, two steps at B = SHARD_RANKS,
               T = 2, 512² in this process, then two data-parallel steps
               through TrainRunner(mesh=) on SHARD_RANKS gloo ranks (B = 1
               each, the same generator): the second steps' loss,
               grad_norm and update against each other (TRAIN_DP_TOL), ms,
               peak, K1, the gradient all-reduce timed alone; then one f32
               step of the goldens' model on a (data 1 × frame 2) mesh
               against the unsharded one, as slice_small_train
  profile_step (only when asked for) one denoiser call of each full-width
               model, one face call, and one call of each interp_full /
               davsr_full / priors_full model, under torch.profiler: device
               time by kernel and by class, idle share

Then, on the lines before the last: the seconds each phase took, one
{"kernels": [...]} record and the card as nvidia-smi names it. The last line is the {"ok": ...} record.
With no CUDA device the script exits non-zero before printing any result.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from flair_tpu_torch import cli
from flair_tpu_torch.diffusion import (
    GuidanceConfig, get_named_beta_schedule, make_diffusion,
    make_task_diffusion, training_losses)
from flair_tpu_torch.face.helper import FaceRestoreHelper, make_face_fn_p
from flair_tpu_torch.models.adm import BlurUNet, EncoderUNetModel, SuperResModel
from flair_tpu_torch.models import vqfr as vqfr_module
from flair_tpu_torch.models.amt import interpolate, make_interpolator
from flair_tpu_torch.models.bisenet import BiSeNet
from flair_tpu_torch.models.blocks import AttentionBlock
from flair_tpu_torch.models.codeformer import CodeFormer
from flair_tpu_torch.models.common import random_init_
from flair_tpu_torch.models.parsenet import ParseNet
from flair_tpu_torch.models.registry import get_model
from flair_tpu_torch.models.restoreformer import RestoreFormer, VQVAEGAN
from flair_tpu_torch.models.retinaface import RetinaFace, RetinaFaceDetector
from flair_tpu_torch.models.sr3 import BicubicUNet
from flair_tpu_torch.models.superslomo import SuperSloMo
from flair_tpu_torch.models.vqfr import VQFRv2
from flair_tpu_torch.models.vsrpp import BasicVSRPP
from flair_tpu_torch.models.yolov5face import (
    YOLOV5N_FACE_CFG, YOLOv5Face, YOLOv5FromConfig, decode_predictions)
from flair_tpu_torch.operators import SuperResolution
from flair_tpu_torch.ops.attention import dot_product_attention, flash_attention
from flair_tpu_torch.ops.dcn import deform_conv2d_raw
from flair_tpu_torch.ops.norms import group_norm_act, group_norm_act_plain
from flair_tpu_torch.ops import vsrpp_step
from flair_tpu_torch.models.common import GroupNorm32
from flair_tpu_torch.ops.deform import (
    deform_conv2d_raw_plain, quantize_values)
from flair_tpu_torch.parallel import (
    LocalWorld, all_gather_frames, make_mesh, shard_batch, sum_over_mesh_)
from flair_tpu_torch.pipeline import video
from flair_tpu_torch.tools import probe_int8
from flair_tpu_torch.pipeline.video import (
    FRAME_SLICE_LEN, TASK_CONFIGS, init_from_degraded, restore_video,
    rnn_input_for, scale_tau, window_slices)
from flair_tpu_torch.pipeline.wrappers import (
    wrap_bicubic_model, wrap_bicubic_train, wrap_blur_model, wrap_blur_train,
    wrap_codeformer, wrap_parsenet)
from flair_tpu_torch.train import (
    TrainConfig, TrainRunner, create_train_state, make_train_step)
from flair_tpu_torch.utils import build
from flair_tpu_torch.utils import logging as train_log
from flair_tpu_torch.utils.convert import (
    from_flax_bicubic_unet, from_flax_blur_unet)
from flair_tpu_torch.utils.png import read_png, write_png

ALL_PHASES = ("device", "build", "kernel_dcn", "kernel_flash",
              "kernel_probe", "kernel_norm", "kernel_vsrpp", "slice_small",
              "slice_small_blur", "slice_small_face", "slice_small_train",
              "slice_small_interp", "train_full", "train_full_blur",
              "interp_full", "davsr_full", "slice_full", "slice_full_int8",
              "slice_full_gaussian", "slice_full_face", "detector", "cli",
              "slice_small_priors", "priors_full", "sharded_small",
              "sharded_full", "train_dp")
EXTRA_PHASES = ("profile_step",)
ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BW = 3.35e12       # H100 SXM HBM3 bytes/s (data sheet)
PEAK_BF16 = 989e12     # dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12       # float32 outside the tensor cores
PEAK_INT8 = 1979e12    # dense int8 tensor-core OP/s
DCN_MRMS = (10.0, 5.0)  # max residue magnitude: BlurUNet sites, SR3 sites
DCN_G = 16
DCN_SHAPES = ((512, 128, 64), (256, 256, 128))   # (H=W, Cin, Cout), B=1
DCN_TOL = 3e-2         # max abs error, bf16 kernel vs f32 plain, unit outputs
DCN_TOL_REL = 1e-2     # the same over the largest |output|: bf16 rounding
# K1 at DAVSRNet's alignments (davsr_full): float32, (H=W, Cin, Cout, G, M),
# timed; max abs / max rel (over the largest |output|) error against the f32
# plain twin, which sums the 9·Cin products in another order: 1e-5 of the
# largest output, whose magnitude is about 2 here, so 2e-5 abs
DCN_F32_ROW = (256, 128, 64, 8, 10.0)
DCN_F32_TOL = (2e-5, 1e-5)
# correctness-only K1 rows, bf16: (B, H, W, Cin, Cout, G, raw as views of one
# tensor, flow amplitude in px, M). Pixel counts and widths that no 128-pixel
# tile divides, Cin/G = 8 / 16 / 24 (groups straddle a 32-channel chunk) / 32,
# and flows of 12-40 px that carry samples past every border.
DCN_EDGE = ((1, 40, 72, 128, 64, 16, True, 3.0, 10.0),
            (2, 100, 100, 64, 32, 8, True, 12.0, 5.0),
            (1, 33, 65, 256, 128, 16, False, 12.0, 10.0),
            (2, 33, 65, 128, 64, 16, False, 12.0, 5.0),
            (1, 40, 72, 384, 128, 16, True, 3.0, 5.0),
            (1, 100, 100, 512, 64, 16, False, 3.0, 10.0),
            (2, 40, 72, 256, 128, 16, True, 40.0, 10.0))
# K1's int8 instance against its int8 twin on the same card tensors, max abs
# / max rel (over the largest |output|), unit outputs: both quantise x alike
# and sum integers exactly, but the kernel's approximate tanh / sigmoid move
# a few integer corner weights by one step of 1/127 and its f32 tap sums run
# in another order before the one rounding to bf16
DCN_INT8_TOL = (3e-2, 1e-2)
# and, on the same inputs, the kernel without int8_dots (the bf16 or f32
# instance: what a kernel that ignored the flag would give) at least this
# many times the int8 kernel's mean relative distance from the int8 twin,
# as tests/test_torch_dcn_int8.py holds the twin against JAX
DCN_INT8_SEPARATION = 1.5
DCN_INT8_EDGE = (1, 2, 4, 6)   # DCN_EDGE rows also checked with int8_dots
# and an f32-x row at Cin/G = 8 (float raw blocks, 8-channel items, ragged
# tiles, B = 2), which the DAVSR row (Cin/G = 16) does not reach:
# DCN_EDGE's fields, then x's dtype
DCN_INT8_EXTRA = ((2, 33, 65, 128, 64, 16, False, 12.0, 10.0,
                   torch.float32),)
# slice_full_int8 against slice_full, PSNR over the [0, 1] clip: the bar
# tests/test_goldens.py:86-87 sets for "the same restoration". It guards
# finiteness and range only: the random-weight trunk barely reads the
# aligned features, so int8 moves the output far less (97.4 dB on the
# H100) and no PSNR bar here could tell a wrong int8 kernel from a right
# one; kernel_dcn's int8 rows (DCN_INT8_SEPARATION) do that. The phase
# also requires the output to differ from slice_full's.
SLICE_INT8_PSNR_DB = 40.0
# kernel_probe: window heights (M = 5, 10), grid steps of the edge rows,
# and the bf16 variant's max abs error over the largest |output|: the tensor
# cores sum REPS·UVP = 8 192 / 12 288 products in their own f32 order
# against an exact float64 reference (1.4e-5 measured at 12 288)
PROBE_UVPS = (256, 384)
PROBE_CHECK_GRID = 4
PROBE_BF16_TOL = 5e-5
# correctness-only K3 rows: (probe variant, UVP, BC, REPS, operand pattern
# of probe_int8.make_inputs), PROBE_CHECK_GRID grid steps. One K tile and
# rings that never fill (UVP 64 / 128 / 192 at REPS 1-3, int8 K zero-padded
# to 128), BC of one block (192; 64 quantised), ramps whose 64 x 8 output
# blocks all differ, int32 sums at their extreme (+127 x -127), quantised
# ties.
PROBE_EDGE = tuple(
    row for v in range(3) for row in (
        (v, 64, probe_int8.BLOCK_ROWS[v], 1, "ramp"),
        (v, 128, 576, 2, "ramp"),
        (v, 192, probe_int8.BLOCK_ROWS[v], 3, "random"),
        (v, 256, 576, 32, "ramp"))) + (
    (1, 384, 576, 32, "extreme"), (2, 384, 576, 32, "extreme"),
    (2, 256, 576, 32, "half_steps"))
# K2 at the BlurUNet's attention sites, one 10-frame window, D = 64:
# (S, heads, dtype, calls per denoiser step)
FLASH_N, FLASH_D = 10, 64
FLASH_SHAPES = ((1024, 4, torch.bfloat16, 5), (256, 8, torch.bfloat16, 5),
                (64, 8, torch.bfloat16, 6), (256, 8, torch.float32, 0))
# max abs / max rel (over the largest |output|) error against the f32 plain
# twin: bf16 rounds P before P·V and rounds the output; f32 differs by the
# order of its sums and exp2f
FLASH_TOL = {torch.bfloat16: (1e-2, 2e-2), torch.float32: (1e-5, 1e-5)}
# correctness-only K2 rows, bf16, FLASH_N frames: (S, heads, D). The kernel
# takes 16 / 64 / 128-query tiles for S <= 64 / <= 256 / above; V is a ramp
# in (key, d), so a transposed V fragment cannot pass as plausible output.
FLASH_EDGE = (tuple((s, 4, 64) for s in (1, 63, 65, 127, 129, 1000))
              + tuple((s, 4, 32) for s in (50, 200, 1000)))
SMALL_PSNR_DB = 50.0   # cuda kernel vs cpu plain, f32 end to end
# gradient rows: (H=W, Cin, Cout, dtype); M = 5, the x8 path's
DCN_GRAD_ROWS = ((512, 128, 64, torch.bfloat16), (256, 256, 128, torch.bfloat16),
                 (256, 256, 128, torch.float32))
FLASH_GRAD_ROWS = ((256, 8, torch.bfloat16), (256, 8, torch.float32))
# each gradient against the plain version's float32 autograd, relative to
# its largest entry: f32 to the order of index_add's atomics, bf16 to the one
# rounding of the float32 gradient to bf16
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# training, cuda vs cpu and the port vs JAX (tests/test_torch_train.py):
# each gradient within 1e-4 of max(its largest entry, TRAIN_GRAD_FLOOR of the
# model's largest) — gradients that are zero in exact arithmetic come out as
# rounding noise, and those through bilinear sampling at flows near zero move
# by up to 5e-6 of the largest with a 1e-6 change of the input
TRAIN_GRAD_FLOOR = 0.2
TRAIN_LR = 1e-4
# train_full: frames per clip without remat (T = 5 keeps ~85 GiB of
# activations for the backward, more than the card holds: PERF.md §6)
# and timed steps; then REMAT_T frames with remat, one timed step
TRAIN_T = 3
TRAIN_STEPS = 3
REMAT_T = 5
# train_full_blur: the BlurUNet's temporal_frames, timed steps
BLUR_T = 5
BLUR_STEPS = 2
# slice_small_blur's SuperResModel / EncoderUNetModel rows: max abs error
# over the largest |output|, cuda (TF32 off) vs cpu, f32
SMALL_MODEL_TOL = 1e-5
# slice_small_interp: the CPU tests' SuperSloMo / tiny AMT / small DAVSRNet
# (tests/test_torch_{superslomo,amt,davsr}.py) and their tolerances, cuda
# (TF32 off) vs cpu: max abs for the interpolators' frames, max abs over
# the largest |output| for DAVSRNet
SMALL_AMT = dict(channels=(16, 24, 32, 48), skip_channels=16, num_flows=2,
                 corr_lvls=2, corr_radius=2)
SMALL_DAVSR = dict(n_iter=2, h_nc=8, mid_channels=32, num_blocks=1,
                   sf=(2, 2, 2), deform_groups=2)
INTERP_TOL = {"superslomo": 1e-5, "amt": 1e-4, "davsr": 1e-4}
# interp_full: one pair at this size, factor 2; davsr_full: a clip of
# DAVSR_T frames at DAVSR_SIZE² (→ 5·DAVSR_T frames at 4·DAVSR_SIZE²)
INTERP_SIZE = 512
DAVSR_T, DAVSR_SIZE = 3, 64
FULL_STEPS = "ddim25"
SLEEP_CYCLES_PER_CALL = 400_000   # ~0.2 ms at the H100's SM clock
DCN_PER_STEP = {"slice_full": 108, "slice_full_int8": 108,
                "slice_full_gaussian": 180,
                "slice_full_face": 108, "cli_x8": 108, "cli_jpeg": 180}
# kernel_norm: (H = W, C, G) of one 10-frame window, bf16 in and out, SiLU:
# x8's first and widest 512² norms, and at 32² its middle's 1 024 channels
# and its widest, the first decoder block's 2 048 (the cat of h and its
# skip); max error over the largest |output| against the plain version in
# float32 (one bf16 rounding of the output)
NORM_SHAPES = ((512, 64, 16), (512, 192, 16), (32, 1024, 16),
               (32, 2048, 16))
NORM_TOL_REL = 1e-2
# kernel_vsrpp: (H = W, C, dtype, G) of one VSR++ frame, B = 1: the main
# path's two levels (SR3 and ADM alike: 64 channels at 512², 128 at 256²,
# 16 deform groups), then DAVSRNet's float32 alignment width (G = 8); max
# error over the largest |output| against the plain version in float32
VSRPP_SHAPES = ((512, 64, torch.bfloat16, 16), (256, 128, torch.bfloat16, 16),
                (256, 64, torch.float32, 8))
VSRPP_TOL_REL = 1e-2
FLASH_PER_STEP = {"slice_full": 0, "slice_full_int8": 0,
                  "slice_full_gaussian": 16,
                  "slice_full_face": 0, "cli_x8": 0, "cli_jpeg": 16}
# the cli phase: (path, argv after the task's clip, frames, input size)
CLI_RUNS = (("cli_x8", ["x8_bicubic", "--sampler", "ddim", "--steps", "25"],
             10, 64),
            ("cli_jpeg", ["jpeg", "--sampler", "ddim", "--steps", "25",
                          "--no-face"], 10, 128))
CLI_STEPS = 25
DET_SIZE = 512
DET_TOL = 1e-4          # max abs, cuda (TF32 off) vs cpu, f32 outputs
DET_GAP = 10            # passing scores sit this many errors apart
DET_HEAD_SCALE = 0.01   # the box check's heads: scores spread about 0.5
DET_MIN_BOXES = 10      # anchors the box check's threshold must pass
FACE_MATRIX = np.array([[1.1, 0.08, 12.0], [-0.08, 1.1, -9.0]],
                       np.float32)   # bench.py:266-268
# SuperResModel / EncoderUNetModel at tests/test_torch_adm.py's size
# (32-channel heads: K2 takes D = 32 / 64)
SMALL_SR = dict(image_size=32, model_channels=32, num_res_blocks=1,
                attention_resolutions=(2,), rnn_resolutions=(1,),
                channel_mult=(1, 2), num_head_channels=32, temporal_frames=5)
SMALL_ENC = dict(image_size=32, in_channels=3, model_channels=32,
                 out_channels=10, num_res_blocks=1, attention_resolutions=(2,),
                 channel_mult=(1, 2), num_head_channels=32)
# the goldens' gaussian BlurUNet, with 32-channel heads for K2
SMALL_BLUR = dict(image_size=64, model_channels=32, num_res_blocks=1,
                  attention_resolutions=(2,), rnn_resolutions=(1,),
                  channel_mult=(1, 2), num_heads=1, num_head_channels=32,
                  temporal_frames=5)
# the small face models: 64² faces (a 16² latent), as tests/test_torch_pipeline.py
SMALL_CF = dict(dim_embd=64, n_head=4, n_layers=1, codebook_size=32,
                latent_size=256, connect_list=("32", "64"), nf=32,
                ch_mult=(1, 2, 2))
SMALL_PN = dict(in_size=64, out_size=64, min_feat_size=16, base_ch=16,
                res_depth=1, ch_range=(16, 64))
# slice_small_priors: the CPU tests' configurations
# (tests/test_torch_alt_priors.py, tests/test_torch_face_parsers.py); max
# abs error over the largest |output|, cuda (TF32 off) vs cpu
SMALL_VQFR = dict(base_channels=32, channel_multipliers=(1, 2),
                  num_enc_blocks=1, num_dec_blocks=1, code_dim=32,
                  inpfeat_dim=8, num_code=16, deformable_groups=2)
SMALL_RF = dict(n_embed=16, embed_dim=16, ch=32, ch_mult=(1, 2),
                num_res_blocks=1, attn_resolutions=(16,), z_channels=16,
                head_size=2, ex_multi_scale_num=1, resolution=32)
SMALL_VQVAE = dict(n_embed=32, embed_dim=16, ch=32, ch_mult=(1, 2),
                   num_res_blocks=1, attn_resolutions=(8,), z_channels=16,
                   resolution=16)
SMALL_YOLO = dict(width=8, depth=(1, 1, 1, 1))
PRIOR_TOL = 1e-5
# priors_full: one image at this size; YOLOv5-face's decode threshold is
# set so that about this many anchors pass it (the 0.02 random weights
# score every anchor near 0.25, in groups of equal scores, so a fixed
# threshold passes none or nearly all of the 16 128)
PRIOR_SIZE = 512
PRIOR_DETS = 200
# multi-device phases: gloo ranks sharing this card (plus one NCCL rank in
# sharded_small), each call joined within RANK_TIMEOUT seconds
SHARD_RANKS = 2
RANK_TIMEOUT = 600.0
SHARD_WIN = 4            # sharded_small's windows: 2 frames a rank
# max abs over the [0, 1] clip, sharded vs unsharded, f32 with TF32 off:
# the sharded norms' one-pass moments (E[x²] − mean²) round differently
# from the unsharded two passes, some 1e-5 after four DDIM steps
SHARDED_SMALL_TOL = 1e-4
SHARD_FULL_FRAMES = 10   # sharded_full: one window, 5 frames a rank
SHARDED_FULL_PSNR_DB = 40.0   # tests/test_goldens.py:86-87's bar
SHARD_TRAIN_T = 2        # train_dp: frames a clip, one clip a rank
SMALL_FRAME_T = 4        # train_dp's f32 (data 1 × frame 2) step
# train_dp, bf16 B = 2 in one process against B = 1 on each of two ranks:
# loss and grad_norm relative error, and the relative L2 error of the
# parameters' update (Adam's first update is ±lr where |g| ≫ eps, so the
# L2 error counts sign flips of small gradients: 0.1 is 0.25 % of them)
TRAIN_DP_TOL = {"rel_err": 1e-2, "update_rel_l2": 0.1}


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


def ptxas_report(log: str) -> dict:
    """Per kernel of one nvcc ``-Xptxas -v`` log: registers a thread, stack
    frame and spill bytes (stores + loads) and static shared memory, keyed
    by the kernel's demangled name without its parameter list (the mangled
    name where cu++filt is missing)."""
    rep, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
            rep[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            rep[fn]["stack_frame"] = int(m.group(1))
            rep[fn]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rep[fn]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            rep[fn]["static_smem"] = int(sm.group(1)) if sm else 0
    if not rep:
        return rep
    filt = os.path.join(os.path.dirname(build._nvcc()), "cu++filt")
    filt = filt if os.path.exists(filt) else shutil.which("c++filt")
    if filt is None:
        return rep
    r = subprocess.run([filt], input="\n".join(rep), capture_output=True,
                       text=True, timeout=60)
    names = r.stdout.splitlines()
    if r.returncode != 0 or len(names) != len(rep):
        return rep
    short = []
    for n in names:   # "void <unnamed>::f<(int)64, ...>(args)" -> "f<64, ...>"
        n = re.sub(r"\((?:unsigned )?\w+\)", "", n)
        n = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", n)
        short.append(n.split("(")[0].split(" ", 1)[-1])
    return dict(zip(short, rep.values()))


def phase_build(ctx):
    """One nvcc per source, all started together."""
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(build.compile_source, names)))
    secs = time.time() - t0
    emit({"phase": "build", "sources": names, "seconds": round(secs, 3),
          "ptxas": {n: ptxas_report(log) for n, log in logs.items()}})


def dcn_inputs(h, cin, cout, seed, device, b=1, w=None, g=DCN_G, amp=3.0,
               views=True, dtype=torch.bfloat16):
    """Raw DCN inputs, main-path-shaped by default: smooth flows of ``amp``
    pixels plus tanh residues, x and raw blocks in ``dtype``, seeded. The raw
    blocks are views of one NHWC tensor, as vsrpp gives them, or with
    ``views`` False three contiguous tensors."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = w or h

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    a, gk = 2, g * 9
    yy = torch.arange(h, device=device).view(1, h, 1, 1) / h
    xx = torch.arange(w, device=device).view(1, 1, w, 1) / w
    ph = torch.rand((1, 1, 1, a), generator=gen, device=device) * 6.28
    flow_y = (amp * torch.sin(2 * math.pi * (yy + xx) + ph)).expand(
        b, h, w, a).contiguous()
    flow_x = (amp * torch.cos(2 * math.pi * (yy - 2 * xx) + ph)).expand(
        b, h, w, a).contiguous()
    bf = dtype
    x = randn(b, h, w, cin).to(bf)
    if views:
        raw = randn(b, h, w, 3 * gk).to(bf)
        res_y, res_x, mlog = (raw[..., :gk], raw[..., gk:2 * gk],
                              raw[..., 2 * gk:])
    else:
        res_y, res_x, mlog = (randn(b, h, w, gk).to(bf) for _ in range(3))
    weight = randn(cout, cin, 3, 3, scale=1.0 / math.sqrt(9 * cin))
    bias = randn(cout, scale=0.1)
    return x, res_y, res_x, mlog, flow_y, flow_x, weight, bias


def dcn_bound_ms(h, cin, cout, x_bytes, g=DCN_G, peak=PEAK_BF16,
                 xq_bytes=None):
    """x, the three raw blocks, both flow planes and the output in the
    kernel's dtype (``x_bytes``; x itself in ``xq_bytes`` when given: 1 for
    the int8 instance), W and bias read once; 2·H·W·9·Cin·Cout FLOP at
    ``peak``."""
    px = h * h
    gk = g * 9
    xb = x_bytes if xq_bytes is None else xq_bytes
    nbytes = (px * cin * xb + 3 * px * gk * x_bytes + 2 * px * 2 * 4
              + px * cout * x_bytes + 9 * cin * cout * 4 + cout * 4)
    flops = 2.0 * px * 9 * cin * cout
    t_bytes = nbytes / MEM_BW * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


def dcn_error(args, mrm):
    """One kernel launch against the f32 plain twin on the same inputs:
    (max abs, max abs over the largest |output|). The launch is not
    counted."""
    x, ry, rx, ml, fy, fx, w, b = args
    saved = deform_conv2d_raw.launches
    out = deform_conv2d_raw(*args, mrm)
    torch.cuda.synchronize()
    deform_conv2d_raw.launches = saved
    with torch.no_grad():
        ref = deform_conv2d_raw_plain(x.float(), ry.float(), rx.float(),
                                      ml.float(), fy, fx, w, b, mrm)
    err = (out.float() - ref).abs().max().item()
    return err, err / ref.abs().max().item()


def dcn_int8_error(args, mrm):
    """One launch of the int8 instance against the int8 twin on the same
    card tensors, and one of the kernel without ``int8_dots``: a dict of
    the int8 kernel's max abs, max abs over the largest |output| and mean
    relative error, and the flag-less kernel's mean relative distance from
    the int8 twin. The launches are not counted."""
    saved = (deform_conv2d_raw.launches, deform_conv2d_raw.launches_int8)
    out = deform_conv2d_raw(*args, mrm, int8_dots=True)
    off = deform_conv2d_raw(*args, mrm)
    torch.cuda.synchronize()
    deform_conv2d_raw.launches, deform_conv2d_raw.launches_int8 = saved
    with torch.no_grad():
        ref = deform_conv2d_raw_plain(*args, mrm, int8_dots=True).float()
    scale = ref.abs().mean().item()
    err = (out.float() - ref).abs().max().item()
    return {"max_abs_err": err,
            "max_rel_err": err / ref.abs().max().item(),
            "mean_rel_err": (out.float() - ref).abs().mean().item() / scale,
            "mean_rel_flag_off": (off.float() - ref).abs().mean().item()
            / scale}


def check_int8_row(row):
    row.update(tol_abs=DCN_INT8_TOL[0], tol_rel=DCN_INT8_TOL[1],
               min_separation=DCN_INT8_SEPARATION)
    emit({"phase": "kernel_dcn", **row})
    if not (row["max_abs_err"] <= DCN_INT8_TOL[0]
            and row["max_rel_err"] <= DCN_INT8_TOL[1]
            and row["mean_rel_flag_off"]
            >= DCN_INT8_SEPARATION * row["mean_rel_err"]):
        raise AssertionError(f"dcn int8 instance disagrees: {row}")


def kernel_dcn_int8(ctx):
    """kernel_dcn's int8 rows: the main-path shapes at both M (the bf16
    rows' inputs), timed beside the bf16 instance, the quantise pass alone
    and the int8 twin; then DCN_INT8_EDGE and DAVSRNet's f32-x shape,
    checked only."""
    dev = torch.device("cuda")
    rows = []
    for mrm in DCN_MRMS:
        for i, (h, cin, cout) in enumerate(DCN_SHAPES):
            args = dcn_inputs(h, cin, cout, seed=100 + i, device=dev)
            errs = dcn_int8_error(args, mrm)
            saved = (deform_conv2d_raw.launches,
                     deform_conv2d_raw.launches_int8)
            ms_bf16 = cuda_ms(lambda: deform_conv2d_raw(*args, mrm), reps=20)
            ms = cuda_ms(lambda: deform_conv2d_raw(*args, mrm,
                                                   int8_dots=True), reps=20)
            quant_ms = cuda_ms(lambda: quantize_values(args[0]), reps=20)
            plain_ms = cuda_ms(lambda: deform_conv2d_raw_plain(
                *args, mrm, int8_dots=True), reps=3, warmup=1, batches=1)
            (deform_conv2d_raw.launches,
             deform_conv2d_raw.launches_int8) = saved
            bound, by, nbytes, flops = dcn_bound_ms(h, cin, cout, 2,
                                                    xq_bytes=1)
            row = {"shape": f"x(1,{h},{h},{cin})->{cout}", "dtype": "int8",
                   "mrm": mrm, **errs, "ms": ms, "ms_bf16_instance": ms_bf16,
                   "quantize_ms": quant_ms, "ms_minus_quantize": ms - quant_ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "bytes": nbytes, "flop": flops,
                   "tflops": flops / ms / 1e9, "card": ctx["smi"]}
            check_int8_row(row)
            rows.append(row)
    edge = ([DCN_EDGE[i] + (torch.bfloat16,) for i in DCN_INT8_EDGE]
            + list(DCN_INT8_EXTRA))
    for i, (b, h, w, cin, cout, g, views, amp, mrm, dt) in enumerate(edge):
        args = dcn_inputs(h, cin, cout, seed=600 + i, device=dev, b=b, w=w,
                          g=g, amp=amp, views=views, dtype=dt)
        row = {"shape": f"x({b},{h},{w},{cin})->{cout}",
               "dtype": "int8" if dt == torch.bfloat16 else "int8, f32 x",
               "G": g, "raw": "views" if views else "separate",
               "flow_px": amp, "mrm": mrm, **dcn_int8_error(args, mrm)}
        check_int8_row(row)
        rows.append(row)
    h, cin, cout, g, mrm = DCN_F32_ROW
    args = dcn_inputs(h, cin, cout, seed=300, device=dev, g=g,
                      dtype=torch.float32)
    row = {"shape": f"x(1,{h},{h},{cin})->{cout}", "dtype": "int8, f32 x",
           "G": g, "mrm": mrm, **dcn_int8_error(args, mrm)}
    check_int8_row(row)
    rows.append(row)
    ctx["dcn_int8_rows"] = rows


def phase_kernel_dcn(ctx):
    """K1 at the main-path shapes, timed beside its plain twin, then the
    float32 row at DAVSRNet's shape (DCN_F32_ROW), timed, then the
    DCN_EDGE rows, checked only."""
    dev = torch.device("cuda")
    rows = []
    for mrm in DCN_MRMS:
        for i, (h, cin, cout) in enumerate(DCN_SHAPES):
            args = dcn_inputs(h, cin, cout, seed=100 + i, device=dev)
            err, rel = dcn_error(args, mrm)
            saved = deform_conv2d_raw.launches
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
    h, cin, cout, g, mrm = DCN_F32_ROW
    args = dcn_inputs(h, cin, cout, seed=300, device=dev, g=g,
                      dtype=torch.float32)
    err, rel = dcn_error(args, mrm)
    saved = deform_conv2d_raw.launches
    ms = cuda_ms(lambda: deform_conv2d_raw(*args, mrm), reps=5)
    plain_ms = cuda_ms(lambda: deform_conv2d_raw_plain(*args, mrm), reps=3,
                       warmup=1, batches=1)
    deform_conv2d_raw.launches = saved
    bound, by, nbytes, flops = dcn_bound_ms(h, cin, cout, 4, g, PEAK_F32)
    row = {"shape": f"x(1,{h},{h},{cin})->{cout}", "dtype": "float32",
           "G": g, "mrm": mrm, "max_abs_err": err, "max_rel_err": rel,
           "tol_abs": DCN_F32_TOL[0], "tol_rel": DCN_F32_TOL[1], "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "bytes": nbytes, "flop": flops, "tflops": flops / ms / 1e9,
           "card": ctx["smi"]}
    emit({"phase": "kernel_dcn", **row})
    rows.append(row)
    if not (err <= DCN_F32_TOL[0] and rel <= DCN_F32_TOL[1]):
        raise AssertionError(f"dcn kernel (f32, G={g}) disagrees at "
                             f"{row['shape']}: abs {err}, rel {rel}")
    for i, (b, h, w, cin, cout, g, views, amp, mrm) in enumerate(DCN_EDGE):
        args = dcn_inputs(h, cin, cout, seed=400 + i, device=dev, b=b, w=w,
                          g=g, amp=amp, views=views)
        err, rel = dcn_error(args, mrm)
        row = {"shape": f"x({b},{h},{w},{cin})->{cout}", "G": g,
               "raw": "views" if views else "separate", "flow_px": amp,
               "mrm": mrm, "max_abs_err": err, "max_rel_err": rel,
               "tol_abs": DCN_TOL, "tol_rel": DCN_TOL_REL}
        emit({"phase": "kernel_dcn", **row})
        rows.append(row)
        if not (err <= DCN_TOL and rel <= DCN_TOL_REL):
            raise AssertionError(
                f"dcn kernel disagrees at {row['shape']} G={g} M={mrm}: "
                f"abs {err} (tol {DCN_TOL}), rel {rel} (tol {DCN_TOL_REL})")
    ctx["dcn_rows"] = rows
    ctx["dcn_grad_rows"] = []
    for i, (h, cin, cout, dtype) in enumerate(DCN_GRAD_ROWS):
        row = dcn_grad_row(h, cin, cout, dtype, seed=500 + i)
        row["card"] = ctx["smi"]
        emit({"phase": "kernel_dcn", **row})
        ctx["dcn_grad_rows"].append(row)
        if not max(row["max_rel_err"].values()) <= GRAD_TOL[dtype]:
            raise AssertionError(f"dcn gradients disagree at {row['shape']} "
                                 f"{dtype}: {row['max_rel_err']}")
    kernel_dcn_int8(ctx)


def grad_errors(names, grads, ref):
    """Each gradient's max abs error over the largest |reference| entry."""
    return {n: ((g.float() - r).abs().max() / r.abs().max()).item()
            for n, g, r in zip(names, grads, ref)}


def dcn_grad_row(h, cin, cout, dtype, seed, mrm=5.0):
    """The DCN autograd Function at a main-path shape: its gradients (K1
    forward, plain float32 backward) against the plain version's own
    autograd on float32 copies of the same inputs, for all eight inputs
    (the raw blocks views of one tensor, as VSR++ passes them), and the
    backward's device time. The launches do not count."""
    x, ry, rx, ml, fy, fx, w, b = dcn_inputs(h, cin, cout, seed,
                                             torch.device("cuda"))
    gk = ry.shape[-1]
    base = [x, torch.cat([ry, rx, ml], dim=-1), fy, fx, w, b]
    leaves = [t.to(dtype if i < 2 else t.dtype).detach().requires_grad_(True)
              for i, t in enumerate(base)]

    def run(ls):
        return deform_conv2d_raw(ls[0], *ls[1].split(gk, dim=-1), *ls[2:],
                                 mrm)

    saved = deform_conv2d_raw.launches
    out = run(leaves)
    deform_conv2d_raw.launches = saved
    cot = torch.randn(out.shape, generator=torch.Generator("cuda").manual_seed(
        seed), device="cuda").to(out.dtype)
    grads = torch.autograd.grad(out, leaves, cot, retain_graph=True)
    ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, cot,
                                             retain_graph=True),
                 reps=3, warmup=1, batches=3)
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    ref = torch.autograd.grad(
        deform_conv2d_raw_plain(ref_leaves[0],
                                *ref_leaves[1].split(gk, dim=-1),
                                *ref_leaves[2:], mrm),
        ref_leaves, cot.float())
    del out
    names = ("x", "res_y", "res_x", "mask_logits", "flow_y", "flow_x",
             "weight", "bias")
    split = lambda gs: [gs[0], *gs[1].split(gk, dim=-1), *gs[2:]]  # noqa: E731
    errs = grad_errors(names, split(grads), split(ref))
    return {"shape": f"x(1,{h},{h},{cin})->{cout}", "dtype": str(dtype),
            "mrm": mrm, "gradient": "K1 forward + plain float32 backward "
            "vs plain autograd", "max_rel_err": errs,
            "tol_rel": GRAD_TOL[dtype], "backward_ms": ms}


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


def flash_inputs(s, heads, d, dtype, seed, ramp=False):
    """q, k, v as views of one seeded packed (FLASH_N, S, heads·3·D) qkv, as
    the attention blocks give them; with ``ramp`` V is 2·key/(S-1) - 1 +
    d/(2D) + h/10 instead of noise."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((FLASH_N, s, heads, 3, d), generator=gen, device=dev)
    if ramp:
        key = torch.arange(s, device=dev).view(s, 1, 1) / max(s - 1, 1)
        col = torch.arange(d, device=dev).view(1, 1, d) / (2 * d)
        head = torch.arange(heads, device=dev).view(1, heads, 1) / 10
        qkv[..., 2, :] = 2 * key - 1 + col + head
    qkv = qkv.reshape(FLASH_N, s, heads * 3 * d).to(dtype)
    return qkv.view(FLASH_N, s, heads, 3, d).unbind(dim=3)


def flash_error(q, k, v):
    """One kernel launch against the f32 plain twin: (max abs, max abs over
    the largest |output|). The launch is not counted."""
    saved = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    flash_attention.launches = saved
    ref = dot_product_attention(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    return err, err / ref.abs().max().item()


def device_ms_by_kernel(prof) -> dict:
    """Device time (ms) by kernel name from a finished torch.profiler run."""
    by_name = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    return by_name


def main_kernel(fn) -> str:
    """The name of the device kernel that takes most of one ``fn`` call."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = device_ms_by_kernel(prof)
    return max(by_name, key=by_name.get)[:160] if by_name else "not measured"


def phase_kernel_flash(ctx):
    """K2 on views of a packed seeded qkv against the f32 plain twin on the
    same inputs; times of the kernel, of the plain twin in the working
    dtype, and of one SDPA call. Then the FLASH_EDGE rows, checked only."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for i, (s, heads, dtype, per_step) in enumerate(FLASH_SHAPES):
        n, d = FLASH_N, FLASH_D
        q, k, v = flash_inputs(s, heads, d, dtype, seed=200 + i)
        err, rel = flash_error(q, k, v)
        saved = flash_attention.launches
        ms = cuda_ms(lambda: flash_attention(q, k, v), reps=20)
        flash_attention.launches = saved    # comparisons do not count
        plain_ms = cuda_ms(lambda: dot_product_attention(q, k, v), reps=20)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731
        library_ms = cuda_ms(sdpa, reps=20)
        bound, by, nbytes, flops = flash_bound_ms(n * heads, s, d, dtype)
        tol_abs, tol_rel = FLASH_TOL[dtype]
        row = {"shape": f"qkv({n},{s},{heads}x3x{d})", "dtype": str(dtype),
               "calls_per_step": per_step, "max_abs_err": err,
               "max_rel_err": rel, "tol_abs": tol_abs, "tol_rel": tol_rel,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library_kernel": main_kernel(sdpa),
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "flop": flops, "tflops": flops / ms / 1e9, "card": ctx["smi"]}
        emit({"phase": "kernel_flash", **row})
        rows.append(row)
        if not (err <= tol_abs and rel <= tol_rel):
            raise AssertionError(f"flash kernel disagrees at {row['shape']} "
                                 f"{dtype}: abs {err} (tol {tol_abs}), "
                                 f"rel {rel} (tol {tol_rel})")
    tol_abs, tol_rel = FLASH_TOL[torch.bfloat16]
    for i, (s, heads, d) in enumerate(FLASH_EDGE):
        err, rel = flash_error(*flash_inputs(s, heads, d, torch.bfloat16,
                                             seed=300 + i, ramp=True))
        row = {"shape": f"qkv({FLASH_N},{s},{heads}x3x{d})",
               "dtype": str(torch.bfloat16), "v": "ramp", "max_abs_err": err,
               "max_rel_err": rel, "tol_abs": tol_abs, "tol_rel": tol_rel}
        emit({"phase": "kernel_flash", **row})
        rows.append(row)
        if not (err <= tol_abs and rel <= tol_rel):
            raise AssertionError(f"flash kernel disagrees at {row['shape']} "
                                 f"(ramp V): abs {err} (tol {tol_abs}), "
                                 f"rel {rel} (tol {tol_rel})")
    ctx["flash_rows"] = rows
    ctx["flash_grad_rows"] = []
    for i, (s, heads, dtype) in enumerate(FLASH_GRAD_ROWS):
        row = flash_grad_row(s, heads, FLASH_D, dtype, seed=600 + i)
        row["card"] = ctx["smi"]
        emit({"phase": "kernel_flash", **row})
        ctx["flash_grad_rows"].append(row)
        if not max(row["max_rel_err"].values()) <= GRAD_TOL[dtype]:
            raise AssertionError(f"flash gradients disagree at {row['shape']} "
                                 f"{dtype}: {row['max_rel_err']}")


def flash_grad_row(s, heads, d, dtype, seed):
    """The flash autograd Function on views of one packed qkv: its q, k, v
    gradients (K2 forward, plain float32 backward) against the plain
    twin's own autograd on a float32 copy, and the backward's device
    time. The launches do not count."""
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    packed = torch.randn((FLASH_N, s, heads * 3 * d), generator=gen,
                         device=dev).to(dtype).requires_grad_(True)

    def qkv(t):
        return t.view(FLASH_N, s, heads, 3, d).unbind(dim=3)

    saved = flash_attention.launches
    out = flash_attention(*qkv(packed))
    flash_attention.launches = saved
    cot = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
    (g,) = torch.autograd.grad(out, packed, cot, retain_graph=True)
    ms = cuda_ms(lambda: torch.autograd.grad(out, packed, cot,
                                             retain_graph=True), reps=20)
    ref_packed = packed.detach().float().requires_grad_(True)
    (r,) = torch.autograd.grad(dot_product_attention(*qkv(ref_packed)),
                               ref_packed, cot.float())
    errs = grad_errors(("q", "k", "v"), qkv(g), qkv(r))
    return {"shape": f"qkv({FLASH_N},{s},{heads}x3x{d})", "dtype": str(dtype),
            "gradient": "K2 forward + plain float32 backward vs plain "
            "autograd", "max_rel_err": errs, "tol_rel": GRAD_TOL[dtype],
            "backward_ms": ms}


def probe_library(a, b):
    """The probe's products by PyTorch: REPS ``torch.bmm`` calls (bf16, on
    a's transposed view, no copy) or REPS ``torch._int_mm`` calls (int8).
    ``_int_mm`` takes 2-D operands, so a goes to a row-major (GRID·BC, UVP)
    copy (for the quantised variant the quantisation is fused into it) and
    b to column-major (UVP, 128) ones, the layout of cuBLASLt's int8 GEMM:
    those copies are a function of their own, returned apart. Returns
    (products, copies or None, what the library calls are)."""
    reps = b.shape[0]
    if a.dtype == torch.bfloat16:
        at = a.mT
        bx = [b[r].expand(a.shape[0], -1, -1) for r in range(reps)]

        def bmms():
            for r in range(reps):
                torch.bmm(at, bx[r])
        return bmms, None, f"{reps} x torch.bmm"
    quant = a.dtype == torch.float32

    def copies():
        t = torch.round(a.mT * 127.0).to(torch.int8) if quant else a.mT
        return (t.contiguous().reshape(-1, a.shape[1]),
                [b[r].mT.contiguous().mT for r in range(reps)])

    at, bt = copies()

    def int_mms():
        for r in range(reps):
            torch._int_mm(at, bt[r])
    return int_mms, copies, (
        f"{reps} x torch._int_mm; copies: "
        + ("round(a.mT * 127).to(int8)" if quant else "a.mT")
        + ".contiguous(), b[r].mT.contiguous().mT")


def phase_kernel_probe(ctx):
    """K3 (csrc/probe_dot.cu): the probe's entry point in process at each
    UVP, its launches counted (the main path of this kernel); then each
    variant timed at the TPU constants beside the library's products (with
    its share of the bound, and the int8 variants' speed-up over bf16 at
    each UVP) and held against its plain version at that shape; then the
    PROBE_EDGE rows, checked only; then the quantised variant's machine
    code (probe_quantiser_sass)."""
    dev = torch.device("cuda")
    launches = {}
    for uvp in PROBE_UVPS:
        probe_int8.probe_dot.launches = 0
        rc = probe_int8.main([str(uvp)])
        torch.cuda.synchronize()
        launches[f"probe_{uvp}"] = probe_int8.probe_dot.launches
        # one warm-up and three timed calls a variant, one check
        if rc != 0 or launches[f"probe_{uvp}"] != 4 * len(
                probe_int8.VARIANTS) + 1:
            raise AssertionError(f"probe entry point at uvp={uvp}: rc {rc}, "
                                 f"launches {launches}")
    ctx["probe_launches"] = launches
    rows = []
    for uvp in PROBE_UVPS:
        for v, (name, (_, _, acc, quant)) in enumerate(
                probe_int8.VARIANTS.items()):
            a, b = probe_int8.make_inputs(name, probe_int8.GRID, uvp,
                                          seed=v, device=dev)
            saved = probe_int8.probe_dot.launches
            ms = cuda_ms(lambda: probe_int8.probe_dot(a, b, acc, quant),
                         reps=5)
            out = probe_int8.probe_dot(a, b, acc, quant)
            probe_int8.probe_dot.launches = saved
            plain_ms = cuda_ms(lambda: probe_int8.probe_dot_plain(
                a, b, acc, quant), reps=1, warmup=1, batches=1)
            ref = probe_int8.probe_dot_plain(a, b, acc, quant)
            err = (out.double() - ref.double()).abs().max().item()
            rel = err / ref.double().abs().max().item()
            del out, ref
            gemms, copies, lib_names = probe_library(a, b)
            lib_ms = cuda_ms(gemms, reps=1, warmup=1, batches=3)
            copy_ms = (cuda_ms(copies, reps=3, warmup=1, batches=3)
                       if copies else None)
            ops = probe_int8.op_count(probe_int8.GRID, uvp)
            nbytes = (a.numel() * a.element_size()
                      + b.numel() * b.element_size()
                      + probe_int8.GRID * probe_int8.BC * probe_int8.LANES
                      * 4)
            peak = PEAK_BF16 if acc == torch.float32 else PEAK_INT8
            t_ops, t_bytes = ops / peak * 1e3, nbytes / MEM_BW * 1e3
            tol = PROBE_BF16_TOL if acc == torch.float32 else 0.0
            row = {"phase": "kernel_probe", "dtype": name, "uvp": uvp,
                   "shape": f"a({probe_int8.GRID},{uvp},{probe_int8.BC}) "
                            f"b({probe_int8.REPS},{uvp},128)",
                   "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_kernel": lib_names, "library_copy_ms": copy_ms,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "pct_of_bound": 100 * max(t_ops, t_bytes) / ms,
                   "ops": ops, "bytes": nbytes,
                   "tops": ops / ms / 1e9, "card": ctx["smi"]}
            emit(row)
            rows.append(row)
            del a, b
            torch.cuda.empty_cache()
            if not rel <= tol:
                raise AssertionError(f"probe kernel disagrees: {row}")
        by = {r["dtype"]: r["ms"] for r in rows if r["uvp"] == uvp}
        names = list(probe_int8.VARIANTS)
        emit({"phase": "kernel_probe", "uvp": uvp,
              "speedup_over_bf16": {n: by[names[0]] / by[n]
                                    for n in names[1:]},
              "card": ctx["smi"]})
    for v, uvp, bc, reps, pattern in PROBE_EDGE:
        name = list(probe_int8.VARIANTS)[v]
        _, _, acc, quant = probe_int8.VARIANTS[name]
        a, b = probe_int8.make_inputs(name, PROBE_CHECK_GRID, uvp, reps=reps,
                                      bc=bc, seed=40 + len(rows), device=dev,
                                      pattern=pattern)
        saved = probe_int8.probe_dot.launches
        out = probe_int8.probe_dot(a, b, acc, quant)
        probe_int8.probe_dot.launches = saved
        ref = probe_int8.probe_dot_plain(a, b, acc, quant)
        err = (out.double() - ref.double()).abs().max().item()
        rel = err / ref.double().abs().max().item()
        tol = PROBE_BF16_TOL if acc == torch.float32 else 0.0
        row = {"dtype": name, "uvp": uvp, "pattern": pattern,
               "shape": f"a({PROBE_CHECK_GRID},{uvp},{bc}) b({reps},{uvp},128)",
               "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol}
        if pattern == "half_steps":
            x = a * 127.0
            row["ties"] = ((x - x.floor()) == 0.5).double().mean().item()
        emit({"phase": "kernel_probe", **row})
        rows.append(row)
        if not rel <= tol:
            raise AssertionError(f"probe kernel disagrees: {row}")
    ctx["probe_rows"] = rows
    sass = probe_quantiser_sass()
    emit({"phase": "kernel_probe", "quantiser_sass": sass})
    if not sass["roundings"] or sass["outside_loops"]:
        raise AssertionError(f"the quantised variant's roundings are not "
                             f"all inside its REPS loop: {sass}")


def probe_quantiser_sass() -> dict:
    """Where the quantised variant's roundings of a to int8 sit in its
    machine code (cuobjdump's SASS of probe_dot_wgmma<2>): the FADDs of
    1.5 * 2^23 (quant_s8) inside the span of a backward branch (a loop; the
    quantisers' only one is the REPS loop) and outside every one. Variant
    2 must round a's slice again every rep, as the TPU kernel does, so none
    may sit outside."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    lib = build.library_path(probe_int8.KERNEL)
    r = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {r.stderr.strip()}")
    funcs = [f for f in r.stdout.split("Function : ")[1:]
             if "probe_dot_wgmmaILi2E" in f.split("\n", 1)[0]]
    if len(funcs) != 1:
        raise RuntimeError(f"cuobjdump: {len(funcs)} quantised kernels")
    code = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
        r"/\*([0-9a-f]+)\*/\s+([^;]*);", funcs[0])]
    loops = []   # (target, branch) of each backward branch
    for addr, ins in code:
        m = re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    conv = [addr for addr, ins in code
            if re.match(r"(@!?P\w+\s+)?FADD\S*\s.*\b12582912\b", ins)]
    outside = [a for a in conv if not any(t <= a <= e for t, e in loops)]
    return {"roundings": len(conv), "outside_loops": len(outside),
            "loops": len(loops), "instructions": len(code)}


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def golden(name):
    gold = os.path.join(ROOT, "goldens", name)
    with open(os.path.join(gold, "meta.json")) as f:
        meta = json.load(f)
    return gold, meta, dict(np.load(os.path.join(gold, "params.npz")))


class FixedFaceHelper:
    """The face helper's interface without a detector: bench.py's fixed
    matrix for every frame."""

    def get_affine_matrices(self, frames01, **kw):
        return [FACE_MATRIX] * len(frames01)


class Counted:
    """A callable that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


class FaceProbe:
    """Within ``with``: the face function that ``restore_video`` builds
    (``video.make_face_fn_p``) counts its calls and brackets each with two
    CUDA events, so the face prior's device time is read in the run."""

    def __enter__(self):
        self.calls, self.events = 0, []
        self._make = make = video.make_face_fn_p

        def probed_make(*args, **kw):
            fn = make(*args, **kw)

            def face_fn(*fargs):
                self.calls += 1
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = fn(*fargs)
                ev[1].record()
                self.events.append(ev)
                return out

            return face_fn

        video.make_face_fn_p = probed_make
        return self

    def __exit__(self, *exc):
        video.make_face_fn_p = self._make

    def ms(self) -> list:
        """Each call's ms (after a synchronize)."""
        return [a.elapsed_time(b) for a, b in self.events]


def face_models(device, cf_kw, pn_kw, scale, dtype=torch.float32):
    """Seeded random CodeFormer and ParseNet on ``device``, wrapped as
    ``restore_video``'s counted appliers."""
    cf, pn = CodeFormer(**cf_kw, dtype=dtype), ParseNet(**pn_kw, dtype=dtype)
    cf.random_init(seed=1, scale=scale)
    pn.random_init(seed=2, scale=scale)
    return (Counted(wrap_codeformer(cf.to(device).eval())),
            Counted(wrap_parsenet(pn.to(device).eval())))


def small_restore(device, face=False, win=3, mesh=None):
    """The CPU tests' configuration: goldens/x8_s64 weights and clip (5
    frames, 8² → 64²), windows of ``win`` (3) overlapping by 1, 4 DDIM
    steps, noise from one numpy seed, under ``mesh`` if given. With
    ``face``, the face prior is on in every step: the SMALL_CF / SMALL_PN
    models at 0.1 (at 0.02 ParseNet gives one class everywhere),
    FACE_MATRIX, VSR++ background weights 0.93. Returns the restored
    (5, 64, 64, 3) clip."""
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
    kw = {}
    if face:
        cf, pn = face_models(device, SMALL_CF, SMALL_PN, scale=0.1)
        kw = dict(face_helper=FixedFaceHelper(), codeformer_apply=cf,
                  parsenet_apply=pn)
    return restore_video(
        np.load(os.path.join(gold, "degraded01.npy")), cfg,
        wrap_bicubic_model(d, model), diffusion=d,
        guidance=GuidanceConfig(use_aux=face, w=cfg.w, rho=cfg.rho, tau=0),
        win=win, overlap=1, sampler="ddim", device=device,
        noise_fn=lambda shape: rng.standard_normal(shape).astype(np.float32),
        mesh=mesh, **kw)


def small_blur_restore(task, device, win=3, mesh=None):
    """The gaussian / jpeg CPU tests' configuration: goldens/<task>_s64
    weights and clip (5 frames, 16² → 64²) with 32-channel attention heads
    (so K2 has an instance), windows of ``win`` (3) overlapping by 1, 4
    DDIM steps, numpy-seeded noise, under ``mesh`` if given. Returns the
    restored (5, 64, 64, 3) clip."""
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
        win=win, overlap=1, sampler="ddim", device=device,
        noise_fn=lambda shape: rng.standard_normal(shape).astype(np.float32),
        mesh=mesh)


def cuda_vs_cpu(restore, name):
    """f32 with TF32 off: ``restore("cuda")`` through the kernels against
    ``restore("cpu")`` through their twins. Returns the phase record and
    the cuda result."""
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
            "shape": list(out_gpu.shape)}, out_gpu


def phase_slice_small(ctx):
    """The x8 CPU test configuration (goldens' widths, 64², 5 frames, 4
    DDIM steps), f32 everywhere, on cuda through the kernel and on cpu
    through the plain version."""
    rec, _ = cuda_vs_cpu(small_restore, "slice_small")
    emit(rec)
    if not (rec["psnr_db_cuda_vs_cpu"] >= SMALL_PSNR_DB
            and rec["dcn_launches"] > 0):
        raise AssertionError(f"slice_small failed its checks: {rec}")


def phase_slice_small_blur(ctx):
    """The gaussian and jpeg CPU test configurations on cuda (both
    kernels) against cpu (both twins)."""
    for task in ("gaussian", "jpeg"):
        rec, _ = cuda_vs_cpu(lambda dev: small_blur_restore(task, dev),
                             "slice_small_blur")
        rec["task"] = task
        emit(rec)
        if not (rec["psnr_db_cuda_vs_cpu"] >= SMALL_PSNR_DB
                and rec["dcn_launches"] > 0 and rec["flash_launches"] > 0):
            raise AssertionError(f"slice_small_blur failed its checks: {rec}")
    phase_slice_small_models(ctx)


def small_model_row(name, model, args):
    """``model`` (f32, eval) on cuda with TF32 off against cpu on the same
    numpy ``args``: max abs error over the largest |cpu output|, and the
    kernel launches of the cuda call (comparisons: not counted)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = deform_conv2d_raw.launches, flash_attention.launches
    with torch.no_grad():
        out_c = model(*(torch.from_numpy(a) for a in args))
        model.to("cuda")
        out_g = model(*(torch.from_numpy(a).cuda() for a in args))
        torch.cuda.synchronize()
    launches = (deform_conv2d_raw.launches - saved[0],
                flash_attention.launches - saved[1])
    deform_conv2d_raw.launches, flash_attention.launches = saved
    torch.backends.cudnn.allow_tf32 = True
    rel = float((out_g.cpu() - out_c).abs().max() / out_c.abs().max())
    return {"phase": "slice_small_blur", "model": name,
            "shape": list(out_g.shape), "max_rel_err_cuda_vs_cpu": rel,
            "tol_rel": SMALL_MODEL_TOL, "dcn_launches": launches[0],
            "flash_launches": launches[1]}


def phase_slice_small_models(ctx):
    """SuperResModel and EncoderUNetModel (seeded random weights at 0.02)
    at the CPU tests' size, cuda (K1 / K2) against cpu."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 3, 32, 32, 3)).astype(np.float32)
    low = np.tanh(rng.standard_normal((1, 3, 16, 16, 3))).astype(np.float32)
    t = np.array([[17, 17, 17]], np.int64)
    sr = SuperResModel(**SMALL_SR)
    sr.random_init(seed=0, scale=0.02)
    enc = EncoderUNetModel(**SMALL_ENC)
    enc.random_init(seed=1, scale=0.02)
    for name, model, args, need in (
            ("superres_unet", sr, (x, t, low), (1, 1)),
            ("encoder_unet", enc, (x, t), (0, 1))):
        rec = small_model_row(name, model.eval(), args)
        emit(rec)
        if not (rec["max_rel_err_cuda_vs_cpu"] <= SMALL_MODEL_TOL
                and rec["dcn_launches"] >= need[0]
                and rec["flash_launches"] >= need[1]):
            raise AssertionError(f"slice_small_blur {name} failed: {rec}")


def phase_slice_small_face(ctx):
    """slice_small with the face prior on: crop, CodeFormer, ParseNet
    mask, blur and paste in every step, on cuda (K1, cuDNN, grid_sample)
    against cpu; the face-off cuda result beside it shows the prior
    changed the output."""
    rec, out_face = cuda_vs_cpu(lambda dev: small_restore(dev, face=True),
                                "slice_small_face")
    torch.backends.cudnn.allow_tf32 = False
    saved = deform_conv2d_raw.launches
    out_plain = small_restore("cuda")
    deform_conv2d_raw.launches = saved
    torch.backends.cudnn.allow_tf32 = True
    rec["psnr_db_face_vs_face_off"] = psnr(out_face, out_plain)
    emit(rec)
    if not (rec["psnr_db_cuda_vs_cpu"] >= SMALL_PSNR_DB
            and rec["dcn_launches"] > 0
            and rec["psnr_db_face_vs_face_off"] < SMALL_PSNR_DB):
        raise AssertionError(f"slice_small_face failed its checks: {rec}")


def x8_train_diffusion(device):
    """The x8 training schedule, as the JAX package trains it
    (``__graft_entry__.py``): face_bicubic, 2000 steps, unspaced."""
    return make_diffusion(get_named_beta_schedule("face_bicubic", 2000),
                          device=device)


def dcn_sites(model) -> int:
    return sum(isinstance(m, BasicVSRPP) for m in model.modules())


def attention_sites(model) -> int:
    """AttentionBlocks and AttentionBottleBlocks: one K2 call each."""
    return sum(isinstance(m, AttentionBlock) for m in model.modules())


def count_norm_calls(model):
    """([calls], hooks): forward pre-hooks counting ``model``'s GroupNorm32
    calls (a remat recompute calls again)."""
    calls = [0]

    def hook(mod, args):
        calls[0] += 1
    return calls, [m.register_forward_pre_hook(hook) for m in model.modules()
                   if isinstance(m, GroupNorm32)]


def small_train_step(device):
    """One ``make_train_step`` of the goldens' x8 model (f32) on ``device``,
    B = 1, T = 3, 64², t and noise fixed. Returns (model, state, metrics,
    {kernel: launches}, GroupNorm32 calls)."""
    _, _, flat = golden("x8_s64")
    model = BicubicUNet(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
                        attn_res=(32,), vsrpp_res=(64,), image_size=64,
                        num_frames=3, head_dim=8)
    model.load_state_dict(from_flax_bicubic_unet(flat))
    model.to(device)
    d = x8_train_diffusion(device)
    cfg = TrainConfig(lr=TRAIN_LR, ema_rates=(0.9999,))
    state = create_train_state(dict(model.named_parameters()), cfg)
    rng = np.random.default_rng(2)
    x0, low = (np.tanh(rng.standard_normal((1, 3, 64, 64, 3)))
               .astype(np.float32) for _ in range(2))
    noise = rng.standard_normal((1, 3, 64, 64, 3)).astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    saved = deform_conv2d_raw.launches, group_norm_act.launches
    deform_conv2d_raw.launches = group_norm_act.launches = 0
    reset_vsrpp_launches()
    calls, hooks = count_norm_calls(model)
    state, met = make_train_step(d, wrap_bicubic_train(d, model), cfg)(
        state, {"x_start": dev(x0), "low_res_input": dev(low)},
        t=dev(np.array([700])), noise=dev(noise))
    for h in hooks:
        h.remove()
    launches = {"dcn_raw": deform_conv2d_raw.launches,
                "group_norm": group_norm_act.launches, **vsrpp_launches()}
    deform_conv2d_raw.launches, group_norm_act.launches = saved
    return model, state, met, launches, calls[0]


def small_blur_train_step(device, x_scale=1.0):
    """One ``make_train_step`` of the goldens' gaussian BlurUNet with remat
    (SMALL_BLUR), f32, on ``device``: the gaussian task's 1000-step
    schedule, B = 1, T = 3, 64², separate ``rnn_input``, t and noise fixed,
    ``x_start`` scaled by ``x_scale``. Returns (model, state, metrics,
    {kernel: launches}, GroupNorm32 calls)."""
    _, _, flat = golden("gaussian_s64")
    model = BlurUNet(**SMALL_BLUR, use_checkpoint=True)
    model.load_state_dict(from_flax_blur_unet(flat))
    model.to(device)
    d = make_task_diffusion("gaussian", "1000", device=device)
    cfg = TrainConfig(lr=TRAIN_LR, ema_rates=(0.9999,))
    state = create_train_state(dict(model.named_parameters()), cfg)
    rng = np.random.default_rng(3)
    x0, low, rnn = (np.tanh(rng.standard_normal((1, 3, 64, 64, 3)))
                    .astype(np.float32) for _ in range(3))
    noise = rng.standard_normal((1, 3, 64, 64, 3)).astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    saved = (deform_conv2d_raw.launches, flash_attention.launches,
             group_norm_act.launches)
    deform_conv2d_raw.launches = flash_attention.launches = 0
    group_norm_act.launches = 0
    reset_vsrpp_launches()
    calls, hooks = count_norm_calls(model)
    state, met = make_train_step(d, wrap_blur_train(d, model), cfg)(
        state, {"x_start": dev(x0) * x_scale, "low_res_input": dev(low),
                "rnn_input": dev(rnn)},
        t=dev(np.array([700])), noise=dev(noise))
    for h in hooks:
        h.remove()
    launches = {"dcn_raw": deform_conv2d_raw.launches,
                "flash_attn": flash_attention.launches,
                "group_norm": group_norm_act.launches, **vsrpp_launches()}
    (deform_conv2d_raw.launches, flash_attention.launches,
     group_norm_act.launches) = saved
    return model, state, met, launches, calls[0]


def train_errors(st_g, met_g, st_c, met_c, jump=None):
    """A cuda training step against the cpu one: loss and grad_norm
    relative errors; each gradient's error over its bound, 1e-4 of
    max(its largest entry, TRAIN_GRAD_FLOOR of the model's largest), or
    twice its ``jump`` (name → the cuda step's own largest change over
    reruns) where that is larger, with the tensors that needed it; the updated parameters where |g_cpu| is above that bound
    (Adam's first update is ±lr there); the EMA stream."""
    g_max = max(g.abs().max().item() for g in met_c["grads"].values())
    err = {"grad": 0.0, "param": 0.0, "ema": 0.0}
    live, jumpy = 0, []
    for k, gc in met_c["grads"].items():
        gg = met_g["grads"][k].cpu()
        tol = 1e-4 * max(gc.abs().max().item(), TRAIN_GRAD_FLOOR * g_max)
        e = (gg - gc).abs().max().item()
        if jump is not None and tol < e <= 2 * float(jump[k]):
            tol = 2 * float(jump[k])
            jumpy.append(k)
        err["grad"] = max(err["grad"], e / tol)
        mask = gc.abs() > tol
        live += int(mask.sum())
        dp = (st_g.params[k].detach().cpu() - st_c.params[k].detach())[mask]
        if dp.numel():
            err["param"] = max(err["param"], dp.abs().max().item())
        err["ema"] = max(err["ema"], (st_g.ema_params[0][k].cpu()
                                      - st_c.ema_params[0][k]).abs().max()
                         .item())
    rel = {k: abs(float(met_g[k]) - float(met_c[k])) / abs(float(met_c[k]))
           for k in ("loss", "grad_norm")}
    return {"loss": float(met_g["loss"]), "grad_norm": float(met_g["grad_norm"]),
            "rel_err": rel, "grad_err_over_tol": err["grad"],
            "grads_on_ulp_jump": jumpy, "param_err": err["param"],
            "param_tol": 1e-2 * TRAIN_LR, "params_compared": live,
            "ema_err": err["ema"], "ema_tol": 1e-7}


def train_ok(rec) -> bool:
    return (max(rec["rel_err"].values()) <= 1e-5
            and rec["grad_err_over_tol"] <= 1.0
            and rec["param_err"] <= rec["param_tol"]
            and rec["ema_err"] <= rec["ema_tol"])


def phase_slice_small_train(ctx):
    """One training step of the goldens' x8 model on cuda (K1 and GroupNorm
    kernel forwards, their plain float32 backwards, cuDNN; the norm kernel
    launched 3 times a GroupNorm32 call) against cpu (plain), f32 with TF32
    off: loss and grad_norm within 1e-5 relative, every gradient within
    1e-4 of max(its largest entry, TRAIN_GRAD_FLOOR of the model's largest);
    the updated parameters where |g_cpu| is above that gradient's tolerance
    (Adam's first update is ±lr there), within 1e-2·lr; the EMA stream
    within 1e-7. Then the goldens' gaussian BlurUNet with remat (K1 and K2
    forwards, each run twice a site; the VB term) under the same checks,
    where a gradient may also differ by twice the card's own largest change
    over three reruns (x_start one ulp up, one down, and as it is;
    ``train_errors``: the BlurUNet's VSR++ / SPyNet gradients jump at
    leaky-ReLU kinks and integer sample positions, tests/test_torch_remat.py)
    for at most 5 % of the tensors."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    model, st_g, met_g, launches, norm_calls = small_train_step("cuda")
    secs = time.time() - t0
    _, st_c, met_c, *_ = small_train_step("cpu")
    # 2 branches × (T - 1) frames a VSR++ site; 3 launches a norm call;
    # the step kernels run under autograd as without it, T = 3
    expect = {"dcn_raw": 2 * 2 * dcn_sites(model),
              "group_norm": 3 * norm_calls,
              **vsrpp_expected(dcn_sites(model), 3)}
    rec = {"phase": "slice_small_train", "model": "x8_s64",
           **train_errors(st_g, met_g, st_c, met_c),
           "launches": launches, "launches_expected": expect,
           "seconds_cuda": round(secs, 3)}
    emit(rec)
    ctx.setdefault("launches", {})["slice_small_train"] = {
        **launches, "flash_attn": 0}
    if not (train_ok(rec) and launches == expect and norm_calls > 0):
        torch.backends.cudnn.allow_tf32 = True
        raise AssertionError(f"slice_small_train failed its checks: {rec}")

    t0 = time.time()
    model, st_g, met_g, launches, norm_calls = small_blur_train_step("cuda")
    secs = time.time() - t0
    # the card's own resolution: x_start one ulp up, one down, and a plain
    # rerun (cuDNN's backward may sum in another order)
    jump = {k: torch.zeros(()) for k in met_g["grads"]}
    for scale in (1 + 1e-7, 1 - 1e-7, 1.0):
        moved = small_blur_train_step("cuda", scale)[2]["grads"]
        for k, g in met_g["grads"].items():
            jump[k] = torch.maximum(jump[k], (moved[k] - g).abs().max().cpu())
    _, st_c, met_c, *_ = small_blur_train_step("cpu")
    torch.backends.cudnn.allow_tf32 = True
    # remat runs every region's forward twice: 2 branches × (T - 1) frames
    # a VSR++ site, one call an attention block, each twice; 3 launches a
    # norm call, recomputes included
    expect = {"dcn_raw": 2 * 2 * 2 * dcn_sites(model),
              "flash_attn": 2 * attention_sites(model),
              "group_norm": 3 * norm_calls,
              **vsrpp_expected(2 * dcn_sites(model), 3)}
    rec = {"phase": "slice_small_train", "model": "gaussian_s64 (remat)",
           **train_errors(st_g, met_g, st_c, met_c, jump),
           "tensors": len(jump), "launches": launches,
           "launches_expected": expect, "seconds_cuda": round(secs, 3)}
    emit(rec)
    ctx["launches"]["slice_small_train_blur"] = launches
    if not (train_ok(rec) and launches == expect
            and len(rec["grads_on_ulp_jump"]) <= 0.05 * len(jump)):
        raise AssertionError(f"slice_small_train (BlurUNet) failed: {rec}")


def forward_backward_ms(apply, d, params, batch, gen):
    """CUDA-event device times of one loss (forward) and of its gradients
    (backward) for ``batch``, as the training step takes them; nothing is
    updated."""
    x = batch["x_start"]
    b, tw = x.shape[:2]
    t = torch.randint(0, d.num_timesteps, (b,), generator=gen,
                      device=x.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    with torch.enable_grad():
        terms = training_losses(
            d, lambda x_t, t_b: apply(params, x_t, t_b[:, None].expand(b, tw),
                                      batch), x, t, gen)
        loss = terms["loss"].mean()
        ev[1].record()
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    ev[2].record()
    ev[2].synchronize()
    return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])


def states_equal(a, b) -> bool:
    if (a.step, a.opt_state.count) != (b.step, b.opt_state.count):
        return False
    pairs = [(a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu)]
    pairs += list(zip(a.ema_params, b.ema_params))
    return all(x.keys() == y.keys()
               and all(torch.equal(x[k], y[k]) for k in x) for x, y in pairs)


def phase_train_full(ctx):
    """The x8 BicubicUNet at the registry defaults (236.1 M parameters,
    seeded random weights at 0.02 as ``cli.build_model`` makes them, bf16
    trunk, float32 parameters) training through ``TrainRunner``: AdamW lr
    1e-4, one EMA stream (0.9999), the face_bicubic 2000-step schedule;
    B = 1, T = TRAIN_T, ``low_res_input`` the bicubic ×8 upsample of a 64²
    clip, ``x_start`` it plus noise at 0.1, 512². Each step's K1 / K2 /
    step-kernel counts are set to 0 just before ``run_step`` and read just
    after."""
    dev = torch.device("cuda")
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    model = get_model("bicubic_unet", dtype=torch.bfloat16)
    model.random_init(seed=0, scale=0.02)
    d = x8_train_diffusion(dev)
    cfg = TrainConfig(lr=TRAIN_LR, ema_rates=(0.9999,))
    apply = wrap_bicubic_train(d, model)
    batch, gen = x8_train_batch(TRAIN_T, dev)
    expect = {"dcn_raw": 2 * (TRAIN_T - 1) * dcn_sites(model),
              "flash_attn": 0, **vsrpp_expected(dcn_sites(model), TRAIN_T)}
    rec = {"phase": "train_full", "model": "bicubic_unet (registry defaults)",
           "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
           "batch": [1, TRAIN_T, 512, 512, 3], "launches_expected": expect}
    with tempfile.TemporaryDirectory() as tmp:
        train_log.configure(os.path.join(tmp, "log"), format_strs=["json"])
        ckpt = os.path.join(tmp, "ckpt")
        kw = dict(ckpt_dir=ckpt, device=dev, log_interval=10 ** 9,
                  save_interval=10 ** 9)
        runner = TrainRunner(d, apply, cfg, model, **kw)

        def step(r):
            return timed_step(r, batch)

        step_ms, launches, losses, norms = [], [], [], []
        for i in range(1 + TRAIN_STEPS):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            host, ms, n = step(runner)
            step_ms.append(ms)
            launches.append(n)
            losses.append(float(host["loss"]))
            norms.append(float(host["grad_norm"]))
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        bad = bad_gradients(host.pop("grads"))
        del host
        saved = deform_conv2d_raw.launches
        fwd_ms, bwd_ms = forward_backward_ms(apply, d, runner.state.params,
                                             batch, gen)
        deform_conv2d_raw.launches = saved     # comparisons do not count
        t0 = time.perf_counter()
        path = runner.save()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model2 = copy.deepcopy(model)
        resumed = TrainRunner(d, wrap_bicubic_train(d, model2), cfg, model2,
                              **kw)
        load_s = time.perf_counter() - t0
        same = (states_equal(resumed.state, runner.state)
                and torch.equal(resumed.generator.get_state(),
                                runner.generator.get_state())
                and resumed.resume_step == runner.step)
        del runner
        host, ms, n = step(resumed)
        rec.update({
            "step_ms": step_ms[1:], "warmup_ms": step_ms[0],
            "ms_per_step": float(np.median(step_ms[1:])),
            "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "backward_share": bwd_ms / float(np.median(step_ms[1:])),
            "update_ms": float(np.median(step_ms[1:])) - fwd_ms - bwd_ms,
            "launches_per_step": launches, "loss": losses,
            "grad_norm": norms, "params_without_gradient": bad,
            "checkpoint": os.path.basename(path), "save_s": save_s,
            "resume_s": load_s, "resumed_equal": same,
            "resumed_step": {"ms": ms, "launches": n,
                             "loss": float(host["loss"]),
                             "grad_norm": float(host["grad_norm"])},
            "allocated_before_gib": held_gib, "card": ctx["smi"]})
    grad_rows = {r["shape"]: r["backward_ms"]
                 for r in ctx.get("dcn_grad_rows", ())
                 if r["dtype"] == str(torch.bfloat16)}
    if len(grad_rows) == 2:
        # half the sites run at 512², half at 256²
        per_step = sum(grad_rows.values()) * expect["dcn_raw"] / 2
        rec["dcn_backward_ms_per_step"] = per_step
        rec["dcn_backward_share"] = per_step / rec["ms_per_step"]
    emit(rec)
    ctx.setdefault("launches", {})["train_full"] = launches[-1]
    del resumed, model, model2
    torch.cuda.empty_cache()
    finite = all(np.isfinite(v) for v in losses + norms
                 + [rec["resumed_step"]["loss"]])
    if not (finite and not bad and same
            and all(n == expect for n in launches)
            and rec["resumed_step"]["launches"] == expect):
        raise AssertionError(f"train_full failed its checks: {rec}")
    train_full_remat(ctx)


def timed_step(runner, batch):
    """One ``runner.run_step(batch)``, every kernel count set to 0 just
    before and read just after: (host metrics, wall ms, launches)."""
    torch.cuda.synchronize()
    deform_conv2d_raw.launches = flash_attention.launches = 0
    reset_vsrpp_launches()
    t0 = time.perf_counter()
    host = runner.run_step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return host, ms, {"dcn_raw": deform_conv2d_raw.launches,
                      "flash_attn": flash_attention.launches,
                      **vsrpp_launches()}


def bad_gradients(grads) -> dict:
    """The parameters whose gradient is missing, non-finite or zero."""
    bad = {k: ("None" if g is None else
               "non-finite" if not torch.isfinite(g).all() else
               "zero" if not g.abs().max() > 0 else None)
           for k, g in grads.items()}
    return {k: v for k, v in bad.items() if v is not None}


def x8_train_batch(frames, dev, clips=1):
    """train_full's batch: ``low_res_input`` the bicubic ×8 upsample of
    ``clips`` seeded 64² clips, ``x_start`` it plus noise at 0.1, clamped;
    and the generator, drawn on."""
    gen = torch.Generator(dev).manual_seed(1)
    clip64 = torch.rand((clips, frames, 64, 64, 3), generator=gen,
                        device=dev)
    low = init_from_degraded(clip64, TASK_CONFIGS["x8_bicubic"])
    x_start = torch.clamp(low + 0.1 * torch.randn(low.shape, generator=gen,
                                                  device=dev), -1, 1)
    return {"x_start": x_start, "low_res_input": low}, gen


def train_full_remat(ctx):
    """train_full's second row: the same x8 model with ``use_checkpoint``
    (every SR3LevelBlock recomputed in the backward) at T = REMAT_T, a
    warm-up step and one timed step through ``TrainRunner``: ms, peak,
    K1 launches (each level block's forward runs twice: 2 × 2 branches ×
    (T - 1) frames a VSR++ site)."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    model = get_model("bicubic_unet", dtype=torch.bfloat16,
                      use_checkpoint=True)
    model.random_init(seed=0, scale=0.02)
    d = x8_train_diffusion(dev)
    cfg = TrainConfig(lr=TRAIN_LR, ema_rates=(0.9999,))
    batch, _ = x8_train_batch(REMAT_T, dev)
    expect = {"dcn_raw": 2 * 2 * (REMAT_T - 1) * dcn_sites(model),
              "flash_attn": 0,
              **vsrpp_expected(2 * dcn_sites(model), REMAT_T)}
    with tempfile.TemporaryDirectory() as tmp:
        train_log.configure(os.path.join(tmp, "log"), format_strs=["json"])
        runner = TrainRunner(d, wrap_bicubic_train(d, model), cfg, model,
                             ckpt_dir=tmp, device=dev, log_interval=10 ** 9,
                             save_interval=10 ** 9)
        warm = timed_step(runner, batch)
        torch.cuda.reset_peak_memory_stats()
        host, ms, launches = timed_step(runner, batch)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        bad = bad_gradients(host.pop("grads"))
        del runner, host
    rec = {"phase": "train_full", "row": "remat",
           "model": "bicubic_unet (registry defaults, use_checkpoint)",
           "batch": [1, REMAT_T, 512, 512, 3], "warmup_ms": warm[1],
           "ms_per_step": ms, "peak_gib": peak,
           "launches_per_step": [warm[2], launches],
           "launches_expected": expect, "loss": float(warm[0]["loss"]),
           "params_without_gradient": bad,
           "allocated_before_gib": held_gib, "card": ctx["smi"]}
    emit(rec)
    ctx["launches"]["train_full_remat"] = launches
    del model
    torch.cuda.empty_cache()
    if not (launches == expect and warm[2] == expect and not bad
            and np.isfinite(rec["loss"])):
        raise AssertionError(f"train_full (remat) failed its checks: {rec}")
    train_full_skip(ctx)


class TimedInterpolator:
    """An ``interpolate(f0, f1, skip)`` callable that records CUDA events
    around each call; ``ms()`` gives each call's time."""

    def __init__(self, fn):
        self.fn, self.events = fn, []

    def __call__(self, f0, f1, skip):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.fn(f0, f1, skip)
        ev[1].record()
        self.events.append(ev)
        return out

    def ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def train_full_skip(ctx):
    """train_full's third row: the remat row's x8 model at T = REMAT_T with
    ``skip = 2``: ``low_res_input`` holds every other frame of the clip
    (3 at 512²) and AMT-G (registry defaults, f32, seeded random weights at
    0.02, ``amt.make_interpolator``) densifies it to REMAT_T inside
    ``TrainRunner``. A warm-up and one timed step: AMT's ms within the
    step (CUDA events), peak, K1 launches (AMT launches none), every UNet
    gradient finite and non-zero; no AMT parameter with a gradient, in the
    optimizer state or in the EMA stream, and AMT's weights unchanged."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    model = get_model("bicubic_unet", dtype=torch.bfloat16,
                      use_checkpoint=True)
    model.random_init(seed=0, scale=0.02)
    amt = get_model("amt")
    random_init_(amt, seed=3, scale=0.02)
    amt.to(dev)
    amt_before = [p.detach().clone() for p in amt.parameters()]
    interp = TimedInterpolator(make_interpolator(amt))
    d = x8_train_diffusion(dev)
    cfg = TrainConfig(lr=TRAIN_LR, ema_rates=(0.9999,))
    batch, _ = x8_train_batch(REMAT_T, dev)
    batch["low_res_input"] = batch["low_res_input"][:, ::2].contiguous()
    expect = {"dcn_raw": 2 * 2 * (REMAT_T - 1) * dcn_sites(model),
              "flash_attn": 0,
              **vsrpp_expected(2 * dcn_sites(model), REMAT_T)}
    with tempfile.TemporaryDirectory() as tmp:
        train_log.configure(os.path.join(tmp, "log"), format_strs=["json"])
        runner = TrainRunner(d, wrap_bicubic_train(d, model), cfg, model,
                             ckpt_dir=tmp, device=dev, log_interval=10 ** 9,
                             save_interval=10 ** 9, skip=2,
                             interpolate=interp)
        warm = timed_step(runner, batch)
        torch.cuda.reset_peak_memory_stats()
        host, ms, launches = timed_step(runner, batch)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        bad = bad_gradients(host.pop("grads"))
        amt_ids = {id(p) for p in amt.parameters()}
        st = runner.state
        in_state = sum(id(v) in amt_ids for stream in (
            st.params, st.opt_state.mu, st.opt_state.nu, *st.ema_params)
            for v in stream.values())
        del runner, host
    amt_ms = interp.ms()
    amt_grads = sum(p.grad is not None for p in amt.parameters())
    amt_same = all(torch.equal(p, q) for p, q in zip(amt.parameters(),
                                                     amt_before))
    rec = {"phase": "train_full", "row": "skip",
           "model": "bicubic_unet (registry defaults, use_checkpoint) + amt "
                    "(AMT-G, f32)",
           "batch": [1, REMAT_T, 512, 512, 3], "low_res_frames": 3,
           "skip": 2, "warmup_ms": warm[1], "ms_per_step": ms,
           "amt_ms": amt_ms[-1], "amt_ms_warmup": amt_ms[0],
           "amt_share": amt_ms[-1] / ms, "peak_gib": peak,
           "launches_per_step": [warm[2], launches],
           "launches_expected": expect, "loss": float(warm[0]["loss"]),
           "params_without_gradient": bad, "amt_params_with_grad": amt_grads,
           "amt_params_in_train_state": in_state,
           "amt_unchanged": amt_same, "allocated_before_gib": held_gib,
           "card": ctx["smi"]}
    emit(rec)
    ctx["launches"]["train_full_skip"] = launches
    del model, amt, amt_before
    torch.cuda.empty_cache()
    if not (launches == expect and warm[2] == expect and not bad
            and np.isfinite(rec["loss"]) and len(amt_ms) == 2
            and amt_grads == 0 and in_state == 0 and amt_same):
        raise AssertionError(f"train_full (skip) failed its checks: {rec}")


def phase_train_full_blur(ctx):
    """The BlurUNet at the registry defaults (M = 10, G = 16, VSR++ at 512²
    and 256², 16 attention sites; seeded random weights at 0.02, bf16
    trunk, float32 parameters) with ``use_checkpoint`` training through
    ``TrainRunner`` and ``wrap_blur_train``: AdamW lr 1e-4, one EMA stream
    (0.9999), the gaussian task's 1000-step face_blur schedule with
    LEARNED_RANGE (the loss adds the VB term); B = 1, T = BLUR_T at 512²,
    ``low_res_input`` / ``rnn_input`` built from a seeded 128² clip as
    restore_video's blur branch builds them, ``x_start`` the conditioning
    plus noise at 0.1, clamped. A warm-up step, BLUR_STEPS timed steps,
    each with its K1 / K2 counts set to 0 just before ``run_step`` and read
    just after, held to the expected launches (each remat'd region runs its
    forward twice); the forward / backward split of one more pass; peak;
    every gradient finite and non-zero."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    model = get_model("blur_unet", dtype=torch.bfloat16, use_checkpoint=True)
    model.random_init(seed=0, scale=0.02)
    d = make_task_diffusion("gaussian", "1000", device=dev)
    cfg = TrainConfig(lr=TRAIN_LR, ema_rates=(0.9999,))
    apply = wrap_blur_train(d, model)
    task = TASK_CONFIGS["gaussian"]
    gen = torch.Generator(dev).manual_seed(2)
    clip128 = torch.rand((1, BLUR_T, task.input_size, task.input_size, 3),
                         generator=gen, device=dev)
    low = init_from_degraded(clip128, task)
    rnn = rnn_input_for(clip128, low, task)
    x_start = torch.clamp(low + 0.1 * torch.randn(low.shape, generator=gen,
                                                  device=dev), -1, 1)
    batch = {"x_start": x_start, "low_res_input": low, "rnn_input": rnn}
    expect = {"dcn_raw": 2 * 2 * (BLUR_T - 1) * dcn_sites(model),
              "flash_attn": 2 * attention_sites(model),
              **vsrpp_expected(2 * dcn_sites(model), BLUR_T)}
    rec = {"phase": "train_full_blur",
           "model": "blur_unet (registry defaults, use_checkpoint)",
           "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
           "batch": [1, BLUR_T, 512, 512, 3], "launches_expected": expect}
    with tempfile.TemporaryDirectory() as tmp:
        train_log.configure(os.path.join(tmp, "log"), format_strs=["json"])
        runner = TrainRunner(d, apply, cfg, model, ckpt_dir=tmp, device=dev,
                             log_interval=10 ** 9, save_interval=10 ** 9)
        step_ms, launches, losses, norms = [], [], [], []
        for i in range(1 + BLUR_STEPS):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            host, ms, n = timed_step(runner, batch)
            step_ms.append(ms)
            launches.append(n)
            losses.append(float(host["loss"]))
            norms.append(float(host["grad_norm"]))
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        bad = bad_gradients(host.pop("grads"))
        del host
        saved = deform_conv2d_raw.launches, flash_attention.launches
        fwd_ms, bwd_ms = forward_backward_ms(apply, d, runner.state.params,
                                             batch, gen)
        deform_conv2d_raw.launches, flash_attention.launches = saved
        del runner
    med = float(np.median(step_ms[1:]))
    rec.update({
        "step_ms": step_ms[1:], "warmup_ms": step_ms[0], "ms_per_step": med,
        "forward_ms": fwd_ms, "backward_ms": bwd_ms,
        "backward_share": bwd_ms / med, "update_ms": med - fwd_ms - bwd_ms,
        "launches_per_step": launches, "loss": losses, "grad_norm": norms,
        "params_without_gradient": bad, "allocated_before_gib": held_gib,
        "card": ctx["smi"]})
    grad_rows = {r["shape"]: r["backward_ms"]
                 for r in ctx.get("dcn_grad_rows", ())
                 if r["dtype"] == str(torch.bfloat16)}
    if len(grad_rows) == 2:
        # plain DCN backwards (one a forward launch without remat): half at
        # 512², half at 256²; the rows are M = 5, the BlurUNet's M is 10
        per_step = sum(grad_rows.values()) * expect["dcn_raw"] / 4
        rec["dcn_backward_ms_per_step_m5_rows"] = per_step
        rec["dcn_backward_share"] = per_step / med
    emit(rec)
    ctx.setdefault("launches", {})["train_full_blur"] = launches[-1]
    del model
    torch.cuda.empty_cache()
    finite = all(np.isfinite(v) for v in losses + norms)
    if not (finite and not bad and all(n == expect for n in launches)):
        raise AssertionError(f"train_full_blur failed its checks: {rec}")


def moving_clip(frames, size, device, shift=2.0, seed=0):
    """(1, frames, size, size, 3) in [0.05, 0.95]: a smooth seeded pattern
    moving ``shift`` pixels a frame, made on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    ph = torch.rand(3, generator=gen) * 6.28
    fr = 0.1 + 0.3 * torch.rand(3, 2, generator=gen)
    yy = torch.arange(size, dtype=torch.float32).view(1, size, 1, 1)
    xx = torch.arange(size, dtype=torch.float32).view(1, 1, size, 1)
    t = torch.arange(frames, dtype=torch.float32).view(frames, 1, 1, 1)
    v = torch.sin(fr[:, 0] * yy + fr[:, 1] * (xx - shift * t) + ph)
    return (0.5 + 0.45 * v)[None].to(device)


def phase_slice_small_interp(ctx):
    """The CPU tests' SuperSloMo (factor 3, 32²), tiny AMT (``interpolate``
    at factor 2 on a 24×40 pair: the 16-padding) and small DAVSRNet (2
    frames at 32² → 4 at 64²; K1 f32 with 2 groups at each of its 12
    alignments), f32 with seeded random weights, on cuda (TF32 off) against
    cpu on the same inputs."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    clip = moving_clip(2, 32, "cpu")
    pair24 = moving_clip(2, 40, "cpu")[:, :, :24] * 2 - 1
    torch.manual_seed(0)
    models = {"superslomo": SuperSloMo(factor=3),
              "amt": get_model("amt", **SMALL_AMT),
              "davsr": get_model("davsr", **SMALL_DAVSR)}
    random_init_(models["davsr"], seed=1, scale=0.02)
    calls = {"superslomo": lambda m, dev: m(clip[:, 0].to(dev) * 2 - 1,
                                           clip[:, 1].to(dev) * 2 - 1),
             "amt": lambda m, dev: interpolate(m, pair24[:, 0].to(dev),
                                               pair24[:, 1].to(dev), 2),
             "davsr": lambda m, dev: m(clip.to(dev))}
    expect = {"superslomo": 0, "amt": 0, "davsr": 2 * 3 * 2}
    failed = []
    for name, model in models.items():
        model.eval()
        with torch.no_grad():
            ref = calls[name](model, "cpu")
            saved = deform_conv2d_raw.launches
            deform_conv2d_raw.launches = 0
            out = calls[name](model.to("cuda"), "cuda")
            torch.cuda.synchronize()
            launches = deform_conv2d_raw.launches
            deform_conv2d_raw.launches = saved
        err = (out.cpu() - ref).abs().max().item()
        if name == "davsr":
            err /= ref.abs().max().item()
        rec = {"phase": "slice_small_interp", "model": name,
               "shape": list(out.shape), "err_cuda_vs_cpu": err,
               "err_kind": "max rel" if name == "davsr" else "max abs",
               "tol": INTERP_TOL[name], "dcn_launches": launches,
               "dcn_launches_expected": expect[name]}
        emit(rec)
        if not (err <= INTERP_TOL[name] and launches == expect[name]):
            failed.append(name)
    torch.backends.cudnn.allow_tf32 = True
    if failed:
        raise AssertionError(f"slice_small_interp failed: {failed}")


def peak_ms(fn, reps=2):
    """``fn()`` once with the peak memory counter reset (returns its output
    and the peak in GiB), then its device time (``cuda_ms``)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = cuda_ms(fn, reps=reps, warmup=0, batches=3)
    return out, peak, ms


def phase_interp_full(ctx):
    """AMT-G (registry defaults) and SuperSloMo (defaults), f32, seeded
    random weights at 0.02, on one INTERP_SIZE² pair in 2-px motion:
    ``interpolate`` / the model at factor 2. ms a call (CUDA events), peak
    memory, every output finite."""
    dev = torch.device("cuda")
    pair = moving_clip(2, INTERP_SIZE, dev) * 2 - 1
    f0, f1 = pair[:, 0], pair[:, 1]
    models = {"amt": get_model("amt"), "superslomo": get_model("superslomo")}
    for i, m in enumerate(models.values()):
        random_init_(m, seed=10 + i, scale=0.02)
        m.to(dev).eval()
    runs = {"amt": functools.partial(interpolate, models["amt"], f0, f1, 2),
            "superslomo": functools.partial(models["superslomo"], f0, f1)}
    bad = []
    for name, fn in runs.items():
        deform_conv2d_raw.launches = flash_attention.launches = 0
        out, peak, ms = peak_ms(fn)
        rec = {"phase": "interp_full", "model": f"{name} (registry "
               "defaults, f32)", "params_m": sum(
                   p.numel() for p in models[name].parameters()) / 1e6,
               "input": [1, INTERP_SIZE, INTERP_SIZE, 3], "factor": 2,
               "shape": list(out.shape),
               "finite": bool(torch.isfinite(out).all()),
               "ms_per_call": ms, "peak_gib": peak,
               "kernel_launches": deform_conv2d_raw.launches
               + flash_attention.launches, "card": ctx["smi"]}
        emit(rec)
        if not (rec["finite"] and rec["shape"] == [1, 1, INTERP_SIZE,
                                                   INTERP_SIZE, 3]):
            bad.append(name)
    if ctx["profile"]:      # kept for profile_step
        ctx.setdefault("video_calls", {}).update(
            {f"{k}_{INTERP_SIZE}": v for k, v in runs.items()})
    del models, runs, m, fn, out
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"interp_full failed: {bad}")


def phase_davsr_full(ctx):
    """DAVSRNet at the registry defaults (n_iter 4, h_nc 64, 64 channels,
    5 blocks, sf (5, 4, 4), G = 8), f32, seeded random weights at 0.02, on a
    DAVSR_T-frame DAVSR_SIZE² clip in motion: the K1 count set to 0 just
    before one forward and read just after, held to 2 branches ×
    (5·DAVSR_T − 1) frames × n_iter; then ms a forward (CUDA events), peak,
    the output finite; K1's share from kernel_dcn's f32 row."""
    dev = torch.device("cuda")
    model = get_model("davsr")
    random_init_(model, seed=20, scale=0.02)
    model.to(dev).eval()
    clip = moving_clip(DAVSR_T, DAVSR_SIZE, dev)
    s0 = model.sf[0]
    expect = {"dcn_raw": 2 * (s0 * DAVSR_T - 1) * model.n_iter,
              "flash_attn": 0, **vsrpp_expected(model.n_iter, s0 * DAVSR_T)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    deform_conv2d_raw.launches = flash_attention.launches = 0
    reset_vsrpp_launches()
    with torch.no_grad():
        out = model(clip)
        torch.cuda.synchronize()
    launches = {"dcn_raw": deform_conv2d_raw.launches,
                "flash_attn": flash_attention.launches, **vsrpp_launches()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    saved = deform_conv2d_raw.launches
    with torch.no_grad():
        ms = cuda_ms(lambda: model(clip), reps=1, warmup=0, batches=3)
    deform_conv2d_raw.launches = saved      # timing runs do not count
    h = DAVSR_SIZE * model.sf[1]
    rec = {"phase": "davsr_full", "model": "davsr (registry defaults, f32)",
           "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
           "input": list(clip.shape), "shape": list(out.shape),
           "finite": bool(torch.isfinite(out).all()),
           "min": float(out.min()), "max": float(out.max()),
           "ms_per_forward": ms, "peak_gib": peak, "launches": launches,
           "launches_expected": expect, "card": ctx["smi"]}
    f32 = [r for r in ctx.get("dcn_rows", ()) if r.get("dtype") == "float32"]
    if f32:
        rec["dcn_ms_per_forward"] = f32[0]["ms"] * launches["dcn_raw"]
        rec["dcn_share"] = rec["dcn_ms_per_forward"] / ms
    emit(rec)
    ctx.setdefault("launches", {})["davsr_full"] = launches
    if ctx["profile"]:      # kept for profile_step
        ctx.setdefault("video_calls", {})["davsr"] = functools.partial(
            model, clip)
    del model
    torch.cuda.empty_cache()
    if not (rec["finite"] and launches == expect
            and rec["shape"] == [1, s0 * DAVSR_T, h, h, 3]):
        raise AssertionError(f"davsr_full failed its checks: {rec}")


def fan_in_init_(model, seed):
    """Seeded weights at the CPU tests' scales: kernels N(0, 1/fan_in)
    (VQFR's DCN offset convs included, so the DCNs sample off the grid),
    codebooks N(0, 1), norm scales 1 + N(0, 0.1²), biases N(0, 0.02²)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            v = torch.randn(p.shape, generator=gen)
            if name.endswith("embedding"):
                pass
            elif p.ndim >= 2:
                v /= math.sqrt(p[0].numel())
            elif name.endswith("weight"):
                v = 1.0 + 0.1 * v
            else:
                v *= 0.02
            p.copy_(v)
    return model.eval()


def top2_margin(scores) -> float:
    """The smallest gap between the best and second-best score of a row."""
    top = torch.sort(scores.double().reshape(-1, scores.shape[-1]),
                     dim=-1).values
    return float((top[:, -1] - top[:, -2]).min())


def nearest_margin(z, emb) -> float:
    """``top2_margin`` of the negated squared distances of each latent
    vector of ``z`` (B, C, H, W) to every code of ``emb``."""
    flat = z.double().permute(0, 2, 3, 1).reshape(-1, emb.shape[1])
    e = emb.double()
    d = (flat ** 2).sum(-1, keepdim=True) + (e ** 2).sum(-1) - 2 * flat @ e.T
    return top2_margin(-d)


def prior_outputs(name, out):
    """(named float outputs, code indices) of one small model's call."""
    if name.startswith("vqfr"):
        codes = out.get("quant_logit")
        return ({k: v for k, v in out.items()},
                None if codes is None else codes.argmax(-1))
    if name in ("restoreformer", "vqvaegan"):
        named = {"dec": out[0], "loss": out[1].reshape(1),
                 "perplexity": out[2][0].reshape(1)}
        if name == "restoreformer":
            named.update({f"hs_{k}": v for k, v in out[3].items()})
        return named, out[2][1]
    return {f"map{i}": v for i, v in enumerate(out)}, None


def phase_slice_small_priors(ctx):
    """The CPU tests' VQFR (both code selection modes), RestoreFormer,
    VQVAEGAN, BiSeNet, YOLOv5Face and yolov5n-face YOLOv5FromConfig, and
    SuperResolution's operators: seeded weights (``fan_in_init_``), f32
    with TF32 off, cuda against cpu on the same inputs. The codes must be
    equal (the smallest top-2 margin is printed), every output within
    PRIOR_TOL of its largest |value|, and no K1 / K2 launch."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    x32 = torch.rand(1, 3, 32, 32, generator=gen) * 2 - 1
    x16 = torch.rand(1, 3, 16, 16, generator=gen) * 2 - 1
    x64 = torch.rand(1, 3, 64, 64, generator=gen)
    cases = {
        "vqfr_predict": (VQFRv2(**SMALL_VQFR), x32),
        "vqfr_nearest": (VQFRv2(**SMALL_VQFR, code_selection_mode="Nearest"),
                         x32),
        "restoreformer": (RestoreFormer(**SMALL_RF), x32),
        "vqvaegan": (VQVAEGAN(**SMALL_VQVAE), x16),
        "bisenet": (BiSeNet(), x64),
        "yolov5face": (YOLOv5Face(**SMALL_YOLO), x64),
        "yolov5n": (YOLOv5FromConfig(YOLOV5N_FACE_CFG), x64)}
    failed = []
    for i, (name, (model, x)) in enumerate(cases.items()):
        fan_in_init_(model, seed=i)
        with torch.no_grad():
            ref, ref_codes = prior_outputs(name, model(x))
            if name == "vqfr_nearest":
                ref_codes = model.quantizer(model.encoder(x))[2]
            deform_conv2d_raw.launches = flash_attention.launches = 0
            model.to("cuda")
            out, codes = prior_outputs(name, model(x.cuda()))
            if name == "vqfr_nearest":
                codes = model.quantizer(model.encoder(x.cuda()))[2]
            torch.cuda.synchronize()
            launches = (deform_conv2d_raw.launches, flash_attention.launches)
            margin = None
            if name == "vqfr_predict":
                margin = top2_margin(ref["quant_logit"])
            elif name == "vqfr_nearest":
                margin = nearest_margin(model.cpu().encoder(x),
                                        model.quantizer.embedding)
            elif name in ("restoreformer", "vqvaegan"):
                model.cpu()
                z = model.quant_conv(model.encoder(x)["out"])
                margin = nearest_margin(z, model.quantize.embedding)
        errs = {k: float((out[k].cpu() - v).abs().max()
                         / v.abs().max().clamp_min(1e-30))
                for k, v in ref.items()}
        worst = max(errs, key=errs.get)
        rec = {"phase": "slice_small_priors", "model": name,
               "input": list(x.shape), "outputs": len(errs),
               "max_rel_err_cuda_vs_cpu": errs[worst], "worst_output": worst,
               "tol_rel": PRIOR_TOL, "dcn_launches": launches[0],
               "flash_launches": launches[1]}
        if ref_codes is not None:
            rec.update(codes_equal=bool(torch.equal(codes.cpu(), ref_codes)),
                       codes=int(ref_codes.numel()),
                       distinct_codes=int(ref_codes.unique().numel()),
                       min_top2_margin=margin)
        emit(rec)
        if not (errs[worst] <= PRIOR_TOL and launches == (0, 0)
                and rec.get("codes_equal", True)):
            failed.append(name)
    # SuperResolution (3 channels, 256², ×4): every operator
    op_c = SuperResolution(3, 256, 4, device="cpu")
    op_g = SuperResolution(3, 256, 4)
    v = torch.randn(2, 256 * 256 * 3, generator=gen)
    eps = torch.randn(2, 256 * 256 * 3, generator=gen)
    y = torch.randn(2, 64 * 64 * 3, generator=gen)
    errs = {}
    for name, args in (("V", (v,)), ("Vt", (v,)), ("U", (y,)), ("Ut", (y,)),
                       ("A", (v,)), ("At", (y,)), ("A_pinv", (y,)),
                       ("Lambda", (v, 1.0, 0.1, 0.9, 0.85)),
                       ("Lambda_noise", (v, 1.0, 0.1, 0.05, 0.85, eps))):
        ref = getattr(op_c, name)(*args)
        out = getattr(op_g, name)(*(a.cuda() if torch.is_tensor(a) else a
                                    for a in args))
        errs[name] = float((out.cpu() - ref).abs().max() / ref.abs().max())
    worst = max(errs, key=errs.get)
    emit({"phase": "slice_small_priors", "model": "super_resolution x4",
          "input": [2, 256, 256, 3], "max_rel_err_cuda_vs_cpu": errs[worst],
          "worst_output": worst, "tol_rel": PRIOR_TOL})
    if errs[worst] > PRIOR_TOL:
        failed.append("super_resolution")
    torch.backends.cudnn.allow_tf32 = True
    if failed:
        raise AssertionError(f"slice_small_priors failed: {failed}")


def yolo_threshold(maps, n):
    """The ``decode_predictions`` threshold that passes the number of
    anchors nearest ``n`` (at least one): a score of the maps, computed as
    the decode computes it (float32 sigmoids of objectness and class), so
    that the anchors above it are exactly those counted."""
    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    scores = np.concatenate([(sig(m[0, ..., 4::16]) * sig(m[0, ..., 15::16]))
                             .reshape(-1) for m in maps])
    vals, counts = np.unique(scores, return_counts=True)
    above = np.cumsum(counts[::-1])[::-1]     # scores >= vals[i]
    i = int(np.argmin(np.abs(above - n)))
    conf = (vals[i - 1] if i > 0
            else np.nextafter(vals[0], np.float32(-np.inf)))
    return float(conf), int(above[i])


class DCNTimer:
    """Within ``with``: every call of VQFR's plain deformable conv is
    bracketed by CUDA events; ``ms()`` sums their elapsed times."""

    def __enter__(self):
        self.pairs = []
        self._real = vqfr_module.modulated_deform_conv2d

        def timed(*args, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self._real(*args, **kw)
            e.record()
            self.pairs.append((s, e))
            return out

        vqfr_module.modulated_deform_conv2d = timed
        return self

    def __exit__(self, *exc):
        vqfr_module.modulated_deform_conv2d = self._real

    def ms(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def phase_priors_full(ctx):
    """The five alternative face models at their registry defaults, seeded
    random weights at 0.02, f32, on one PRIOR_SIZE² image: the K1 / K2
    counts set to 0 just before each first forward and read just after
    (0 each: VQFR's DCN and RestoreFormer's attention are the plain
    versions), the peak memory of that forward, then ms a forward (CUDA
    events, the median of 5 after a warm-up), every output finite; the
    peak counts the model's weights and its forward, not what earlier
    phases hold. VQFR:
    the plain DCN's ms in one more forward (CUDA events around each of its
    calls); YOLOv5-face: the host decode + NMS of its maps, the threshold
    set so that PRIOR_DETS anchors pass."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(30)
    x01 = torch.rand(1, 3, PRIOR_SIZE, PRIOR_SIZE, generator=gen).to(dev)
    runs = {"vqfr": lambda m: m(x01 * 2 - 1, fidelity_ratio=1.0),
            "restoreformer": lambda m: m(x01 * 2 - 1),
            "vqvaegan": lambda m: m(x01 * 2 - 1),
            "bisenet": lambda m: m(x01),
            "yolov5face": lambda m: m(x01)}
    bad = []
    for i, (name, run) in enumerate(runs.items()):
        model = get_model(name)
        random_init_(model, seed=40 + i, scale=0.02)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        model.to(dev).eval()
        torch.cuda.reset_peak_memory_stats()
        deform_conv2d_raw.launches = flash_attention.launches = 0
        with torch.no_grad():
            out = run(model)
            torch.cuda.synchronize()
        launches = {"dcn_raw": deform_conv2d_raw.launches,
                    "flash_attn": flash_attention.launches}
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        tensors = (list(out.values()) if isinstance(out, dict) else
                   [t for t in out if torch.is_tensor(t)]
                   + ([out[2][0]] if name in ("restoreformer", "vqvaegan")
                      else [])
                   + (list(out[3].values()) if name == "restoreformer"
                      else []))
        with torch.no_grad():
            ms = cuda_ms(functools.partial(run, model), reps=1, warmup=1,
                         batches=5)
        rec = {"phase": "priors_full", "model": f"{name} (registry defaults, "
               "f32)", "params_m": sum(p.numel() for p in
                                       model.parameters()) / 1e6,
               "input": list(x01.shape),
               "shapes": [list(t.shape) for t in tensors[:4]],
               "finite": all(bool(torch.isfinite(t).all()) for t in tensors),
               "ms_per_forward": ms, "peak_gib": peak, "launches": launches,
               "card": ctx["smi"]}
        if name == "vqfr":
            with torch.no_grad(), DCNTimer() as timer:
                run(model)
            rec["dcn_plain_calls"] = len(timer.pairs)
            rec["dcn_plain_ms_per_forward"] = timer.ms()
            rec["dcn_plain_share"] = rec["dcn_plain_ms_per_forward"] / ms
        if name == "yolov5face":
            maps = [o.permute(0, 2, 3, 1).cpu().numpy() for o in out]
            conf, passing = yolo_threshold(maps, PRIOR_DETS)
            t0 = time.perf_counter()
            dets = decode_predictions(maps, conf_thres=conf)
            rec["host_decode_ms"] = (time.perf_counter() - t0) * 1e3
            rec.update(conf_thres=conf, anchors_passing=passing,
                       detections_after_nms=int(len(dets)))
            rec["finite"] = rec["finite"] and bool(np.isfinite(dets).all())
        emit(rec)
        if not (rec["finite"] and launches == {"dcn_raw": 0,
                                               "flash_attn": 0}):
            bad.append(name)
        ctx.setdefault("launches", {})[f"priors_full_{name}"] = launches
        if ctx["profile"]:      # kept for profile_step
            ctx.setdefault("prior_calls", {})[f"{name}_{PRIOR_SIZE}"] = (
                functools.partial(run, model))
        del model, out, tensors
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"priors_full failed: {bad}")


def run_full(ctx, name, task, model, make_apply, clip, face=None,
             int8=False):
    """One main path at full width: every kernel count set to 0 just
    before ``restore_video``, read just after, and held to the expected
    launches per denoiser step × steps × windows. ``face``: (codeformer,
    parsenet) counted appliers, for the face prior with FixedFaceHelper;
    its calls are counted and timed in the run. ``int8``: with
    FLAIR_DCN_INT8=1 for the run (every K1 launch the int8 instance's).
    Returns the restored clip."""
    dev = torch.device("cuda")
    base = TASK_CONFIGS[task]
    d = make_task_diffusion(base.task, FULL_STEPS, device=dev)
    steps = d.num_timesteps
    # the demo's face window (tau = 5 of 100 steps), kept as a fraction of
    # the respaced schedule, as bench.py does
    cfg = dataclasses.replace(base, steps=FULL_STEPS,
                              tau=scale_tau(base.tau, steps))
    model_apply = make_apply(d)
    n_windows = len(window_slices(clip.shape[0]))
    kw, expect_face = {}, {}
    if face is not None:
        kw = dict(face_helper=FixedFaceHelper(), codeformer_apply=face[0],
                  parsenet_apply=face[1])
        face_steps = steps - cfg.tau     # tau <= t <= steps - 1
        expect_face = {"face_fn": face_steps * n_windows,
                       "codeformer": face_steps * n_windows,
                       "parsenet": (face_steps + 1) * n_windows}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    if int8:
        os.environ["FLAIR_DCN_INT8"] = "1"
    deform_conv2d_raw.launches = flash_attention.launches = 0
    deform_conv2d_raw.launches_int8 = group_norm_act.launches = 0
    reset_vsrpp_launches()
    for f in face or ():
        f.calls = 0
    t0 = time.time()
    try:
        with FaceProbe() as probe:
            out = restore_video(clip, cfg, model_apply, diffusion=d,
                                sampler="ddim", device=dev,
                                generator=torch.Generator(dev).manual_seed(0),
                                **kw)
            torch.cuda.synchronize()
    finally:
        os.environ.pop("FLAIR_DCN_INT8", None)
    secs = time.time() - t0
    launches = {"dcn_raw": deform_conv2d_raw.launches,
                "dcn_raw_int8": deform_conv2d_raw.launches_int8,
                "flash_attn": flash_attention.launches,
                "group_norm": group_norm_act.launches, **vsrpp_launches()}
    k1 = DCN_PER_STEP[name] * steps * n_windows
    norm_sites = sum(isinstance(m, GroupNorm32) for m in model.modules())
    expect = {"dcn_raw": 0 if int8 else k1,
              "dcn_raw_int8": k1 if int8 else 0,
              "flash_attn": FLASH_PER_STEP[name] * steps * n_windows,
              "group_norm": 3 * norm_sites * steps * n_windows,
              # every window is FRAME_SLICE_LEN frames (the tail padded)
              **vsrpp_expected(k1 // (2 * (FRAME_SLICE_LEN - 1)),
                               FRAME_SLICE_LEN)}
    out_size = base.output_size
    rec = {"phase": name, "task": task, "steps": FULL_STEPS,
           "windows": n_windows, "shape": list(out.shape),
           "finite": bool(np.isfinite(out).all()),
           "min": float(out.min()), "max": float(out.max()),
           "launches": launches, "launches_expected": expect,
           "seconds_total": round(secs, 3),
           "seconds_per_window": round(secs / n_windows, 3),
           "ms_per_step": secs / (steps * n_windows) * 1e3,
           "frames_per_s": clip.shape[0] / secs,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "card": ctx["smi"]}
    calls = {}
    if face is not None:
        calls = {"face_fn": probe.calls, "codeformer": face[0].calls,
                 "parsenet": face[1].calls}
        face_ms = probe.ms()
        rec.update({"face_calls": calls, "face_calls_expected": expect_face,
                    "face_ms_per_call_median": float(np.median(face_ms)),
                    "face_ms_per_call_min": min(face_ms),
                    "face_ms_per_call_max": max(face_ms),
                    "face_share_of_run": sum(face_ms) / 1e3 / secs})
        ctx["face"] = (face, clip)
    if int8:
        base_out, base_rec = ctx["full_out"]["slice_full"]
        rec.update({"ms_per_step_slice_full": base_rec["ms_per_step"],
                    "max_memory_allocated_gib_slice_full":
                        base_rec["max_memory_allocated_gib"],
                    "psnr_db_vs_slice_full": psnr(out, base_out),
                    "min_psnr_db": SLICE_INT8_PSNR_DB,
                    "differs_from_slice_full":
                        not np.array_equal(out, base_out)})
    emit(rec)
    ctx.setdefault("launches", {})[name] = launches
    if not int8:   # profile_step runs each model without the env variable
        ctx.setdefault("full", {})[name] = (task, model, model_apply, clip)
    ctx.setdefault("full_out", {})[name] = (out, rec)
    if not (rec["shape"] == [clip.shape[0], out_size, out_size, 3]
            and rec["finite"] and rec["min"] >= 0.0 and rec["max"] <= 1.0
            and launches == expect and calls == expect_face
            and rec.get("psnr_db_vs_slice_full", math.inf)
            > SLICE_INT8_PSNR_DB
            and rec.get("differs_from_slice_full", True)):
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


def phase_slice_full_int8(ctx):
    """slice_full with FLAIR_DCN_INT8=1: slice_full's model, clip and noise
    (its generator's seed), every K1 launch the int8 instance's; PSNR
    against slice_full's output. Needs slice_full earlier in the run."""
    if "slice_full" not in ctx.get("full_out", {}):
        raise AssertionError("slice_full_int8 needs slice_full's run first")
    task, model, _, clip = ctx["full"]["slice_full"]
    run_full(ctx, "slice_full_int8", task, model,
             lambda d: wrap_bicubic_model(d, model), clip, int8=True)


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


def phase_slice_full_face(ctx):
    """slice_full with the face prior on: the same BicubicUNet and clip,
    CodeFormer and ParseNet at the JAX defaults (512² faces), seeded random
    weights at 0.02, bf16; FixedFaceHelper gives every frame bench.py's
    matrix. The face runs in steps tau..24 of each window, tau =
    scale_tau(5, 25) = 1: 48 face and CodeFormer calls, and 50 ParseNet
    calls with the two that build each window's VSR++ weights."""
    model = get_model("bicubic_unet", dtype=torch.bfloat16)
    model.random_init(seed=0, scale=0.02)
    model.to("cuda").eval()
    clip = np.random.default_rng(0).uniform(
        0, 1, (13, 64, 64, 3)).astype(np.float32)
    face = face_models("cuda", {}, {}, scale=0.02, dtype=torch.bfloat16)
    run_full(ctx, "slice_full_face", "x8_bicubic", model,
             lambda d: wrap_bicubic_model(d, model), clip, face=face)


# ------------------------------------------------------- multi-device ----
# Ranks are LocalWorld processes on this card (gloo ranks share cuda:0;
# NCCL takes no two ranks on one card, so it runs as a world of one). They
# import this file and run the module-level rank_* functions below.


def world(ctx, backend="gloo", n=SHARD_RANKS):
    """The run's world of ``n`` ``backend`` ranks, started on first use
    (main closes it). This process's cached device memory is released
    first: the ranks allocate on the same card."""
    gc.collect()
    torch.cuda.empty_cache()
    worlds = ctx.setdefault("worlds", {})
    if (backend, n) not in worlds:
        init = os.path.join(ctx["tmp"], f"init_{backend}_{n}")
        worlds[(backend, n)] = LocalWorld(n, init, backend=backend,
                                          timeout=RANK_TIMEOUT)
    return worlds[(backend, n)]


def close_world(ctx, backend, n):
    ctx.get("worlds", {}).pop((backend, n)).close()


def frame_mesh():
    return make_mesh(None, axes=("frame",), shape=(dist.get_world_size(),))


def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def small_sharded_restore(task, device, mesh=None):
    """sharded_small's restore of ``task``: the small x8 / gaussian
    configuration with windows of SHARD_WIN (2 frames a rank)."""
    if task == "x8_bicubic":
        return small_restore(device, win=SHARD_WIN, mesh=mesh)
    return small_blur_restore(task, device, win=SHARD_WIN, mesh=mesh)


def rank_small_restore(task):
    """sharded_small on a rank: f32, TF32 off, on cuda:0 under a frame mesh
    of the whole world: (clip, K1 / K2 launches, bytes gathered)."""
    no_tf32()
    mesh = frame_mesh()
    deform_conv2d_raw.launches = flash_attention.launches = 0
    all_gather_frames.bytes = group_norm_act.launches = 0
    reset_vsrpp_launches()
    out = small_sharded_restore(task, "cuda", mesh)
    return out, {"dcn_raw": deform_conv2d_raw.launches,
                 "flash_attn": flash_attention.launches,
                 "group_norm": group_norm_act.launches,
                 **vsrpp_launches()}, all_gather_frames.bytes


def phase_sharded_small(ctx):
    """The small x8 and gaussian restores (f32, TF32 off, windows of
    SHARD_WIN) on SHARD_RANKS gloo ranks sharing this card, each rank on
    its 2 frames, and through the same sharded code on one NCCL rank,
    against one unsharded process on the card: every rank's clip within
    SHARDED_SMALL_TOL, K1 (and, gaussian, K2) launched on every rank; the
    norm kernel launched unsharded and on no rank (a frame group takes the
    plain version: its statistics need an all-reduce between the passes)."""
    no_tf32()
    bad = []
    for task in ("x8_bicubic", "gaussian"):
        group_norm_act.launches = 0
        want = small_sharded_restore(task, "cuda")
        norm_unsharded = group_norm_act.launches
        for backend, n in (("gloo", SHARD_RANKS), ("nccl", 1)):
            t0 = time.time()
            outs = world(ctx, backend, n).run(rank_small_restore, task)
            secs = time.time() - t0
            rec = {"phase": "sharded_small", "task": task,
                   "backend": backend, "ranks": n,
                   "max_abs_err": [float(np.abs(o - want).max())
                                   for o, _, _ in outs],
                   "tol": SHARDED_SMALL_TOL,
                   "launches": [c for _, c, _ in outs],
                   "group_norm_unsharded": norm_unsharded,
                   "bytes_gathered": [b for _, _, b in outs],
                   "seconds": round(secs, 3)}
            emit(rec)
            need_k2 = task != "x8_bicubic"
            # the step kernels run the whole recurrence on every rank: a
            # warp before each K1 call
            launched = norm_unsharded > 0 and all(
                c["dcn_raw"] > 0 and (c["flash_attn"] > 0 or not need_k2)
                and c["group_norm"] == 0
                and c["vsrpp_warp_pair"] == c["dcn_raw"]
                and c["vsrpp_gate_tail"] > c["dcn_raw"]
                for c in rec["launches"])
            if not (launched and max(rec["max_abs_err"])
                    <= SHARDED_SMALL_TOL):
                bad.append(rec)
    close_world(ctx, "nccl", 1)
    torch.backends.cudnn.allow_tf32 = True
    if bad:
        raise AssertionError(f"sharded_small failed its checks: {bad}")


def full_x8(use_checkpoint=False, seed=0):
    """The x8 BicubicUNet at the registry defaults, seeded random weights
    at 0.02, bf16 trunk, on the card."""
    model = get_model("bicubic_unet", dtype=torch.bfloat16,
                      use_checkpoint=use_checkpoint)
    model.random_init(seed=seed, scale=0.02)
    return model.to("cuda")


def full_window_restore(model, clip, mesh=None):
    """One SHARD_FULL_FRAMES-frame window of x8 guided DDIM-25 at 512²,
    face off, noise from a seeded cuda generator: (clip, seconds, K1 / K2 /
    norm launches, peak GiB), every count set to 0 just before the run."""
    dev = torch.device("cuda")
    base = TASK_CONFIGS["x8_bicubic"]
    d = make_task_diffusion(base.task, FULL_STEPS, device=dev)
    cfg = dataclasses.replace(base, steps=FULL_STEPS)
    apply = wrap_bicubic_model(d, model)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    deform_conv2d_raw.launches = flash_attention.launches = 0
    all_gather_frames.bytes = group_norm_act.launches = 0
    reset_vsrpp_launches()
    t0 = time.time()
    out = restore_video(clip, cfg, apply, diffusion=d, sampler="ddim",
                        device=dev, mesh=mesh,
                        generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    return (out, time.time() - t0,
            {"dcn_raw": deform_conv2d_raw.launches,
             "flash_attn": flash_attention.launches,
             "group_norm": group_norm_act.launches, **vsrpp_launches()},
            torch.cuda.max_memory_allocated() / 2 ** 30)


def gather_ms(group, shape, reps=3):
    """ms of one ``all_gather_frames`` of a bf16 ``shape`` block (a VSR++
    site's hidden state) over ``group``, from host to host."""
    x = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    all_gather_frames(x, group, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        all_gather_frames(x, group, 1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def rank_full_restore(clip):
    """sharded_full on a rank: the full x8 window under a frame mesh of
    the whole world, then each VSR++ site's gather timed alone."""
    mesh = frame_mesh()
    model = full_x8().eval()
    out, secs, launches, peak = full_window_restore(model, clip, mesh)
    gathered = all_gather_frames.bytes
    tl = clip.shape[0] // dist.get_world_size()
    group = mesh.get_group("frame")
    sites = {f"{res}x{c}": gather_ms(group, (1, tl, res, res, c))
             for res, c in ((512, 64), (256, 128))}
    return out, secs, launches, peak, gathered, sites


def phase_sharded_full(ctx):
    """The x8 BicubicUNet at the registry defaults (bf16, random at 0.02):
    one SHARD_FULL_FRAMES-frame 64² window restored to 512² by x8 guided
    DDIM-25, face off, unsharded here, then on SHARD_RANKS gloo ranks
    sharing this card with SHARD_FULL_FRAMES / SHARD_RANKS frames each, on
    the same noise: each rank's clip > SHARDED_FULL_PSNR_DB against the
    unsharded one, K1 launched the unsharded count on every rank (each
    runs the whole VSR++ recurrence), the norm kernel 3 a GroupNorm32 a
    call unsharded and on no rank (a frame group); per rank ms a step, bytes gathered a
    step, peak memory, and each VSR++ site's gather timed alone."""
    steps = int(FULL_STEPS[len("ddim"):])
    clip = np.random.default_rng(0).uniform(
        0, 1, (SHARD_FULL_FRAMES, 64, 64, 3)).astype(np.float32)
    model = full_x8().eval()
    want, secs, launches, peak = full_window_restore(model, clip)
    norm_sites = sum(isinstance(m, GroupNorm32) for m in model.modules())
    del model
    torch.cuda.empty_cache()
    k1 = DCN_PER_STEP["slice_full"] * steps
    expect = {"dcn_raw": k1, "flash_attn": 0,
              "group_norm": 3 * norm_sites * steps,
              **vsrpp_expected(k1 // (2 * (SHARD_FULL_FRAMES - 1)),
                               SHARD_FULL_FRAMES)}
    expect_rank = {**expect, "group_norm": 0}
    ranks = world(ctx).run(rank_full_restore, clip)
    sites = 3   # VSR++ sites at each of 512² and 256² (down 1, up 2)
    rec = {"phase": "sharded_full", "steps": FULL_STEPS,
           "frames": SHARD_FULL_FRAMES, "ranks": SHARD_RANKS,
           "unsharded": {"ms_per_step": secs / steps * 1e3,
                         "peak_gib": peak, "launches": launches},
           "per_rank": [{"psnr_db_vs_unsharded": psnr(o, want),
                         "ms_per_step": s / steps * 1e3,
                         "bytes_gathered_per_step": b / steps,
                         "launches": n, "peak_gib": pk,
                         "gather_ms_by_site": g,
                         "gather_ms_per_step": sites * sum(g.values())}
                        for o, s, n, pk, b, g in ranks],
           "min_psnr_db": SHARDED_FULL_PSNR_DB, "launches_expected": expect,
           "launches_expected_a_rank": expect_rank, "card": ctx["smi"]}
    emit(rec)
    for r, pr in enumerate(rec["per_rank"]):
        ctx["launches"][f"sharded_full/rank{r}"] = pr["launches"]
    outs = [o for o, *_ in ranks]
    if not (launches == expect
            and all(pr["launches"] == expect_rank
                    for pr in rec["per_rank"])
            and all(o.shape == want.shape and np.isfinite(o).all()
                    for o in outs)
            and all(pr["psnr_db_vs_unsharded"] > SHARDED_FULL_PSNR_DB
                    for pr in rec["per_rank"])):
        raise AssertionError(f"sharded_full failed its checks: {rec}")


def full_dp_runner(model, tmp, mesh=None):
    """A TrainRunner of ``model`` on the x8 training schedule (AdamW lr
    TRAIN_LR, one EMA stream) with a seeded cuda generator, its log and
    checkpoint directory under ``tmp``."""
    dev = torch.device("cuda")
    d = x8_train_diffusion(dev)
    train_log.configure(os.path.join(tmp, "log"), format_strs=["json"])
    return TrainRunner(d, wrap_bicubic_train(d, model),
                       TrainConfig(lr=TRAIN_LR, ema_rates=(0.9999,)), model,
                       ckpt_dir=os.path.join(tmp, "ckpt"), device=dev,
                       log_interval=10 ** 9, save_interval=10 ** 9, mesh=mesh,
                       generator=torch.Generator(dev).manual_seed(0))


def flat_params(runner) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1)
                      for p in runner.state.params.values()])


def warm_then_timed_step(runner, batch):
    """A warm-up step, then a timed one: (its host metrics, its ms, its
    launches, the warm-up's ms, the peak GiB of the timed step, the
    parameters' update by the timed step, on the card)."""
    warm = timed_step(runner, batch)
    before = flat_params(runner)
    torch.cuda.reset_peak_memory_stats()
    host, ms, launches = timed_step(runner, batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return (host, ms, launches, warm[1], peak, flat_params(runner) - before)


def rank_train_dp(batch, ref_path):
    """train_dp on a rank: the full-width x8 model with remat (each rank
    seeded differently: ``replicate_params`` gives them rank 0's weights)
    taking two data-parallel steps on its share of ``batch`` through
    ``TrainRunner(mesh=)``; the second step's loss, grad_norm and update
    against the unsharded run's (``ref_path``), its ms, peak memory and K1
    launches, and the gradient all-reduce timed alone."""
    mesh = make_mesh(None, axes=("data",))
    model = full_x8(use_checkpoint=True, seed=dist.get_rank())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        runner = full_dp_runner(model, tmp, mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        host, ms, launches, warm_ms, peak, update = warm_then_timed_step(
            runner, batch)
    ref = torch.load(ref_path)
    ref_update = ref["update"].to(update.device)
    grads = [torch.zeros_like(p) for p in runner.state.params.values()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sum_over_mesh_(grads, mesh)
    torch.cuda.synchronize()
    return {"loss": float(host["loss"]), "grad_norm": float(host["grad_norm"]),
            "rel_err": {k: abs(float(host[k]) - ref[k]) / abs(ref[k])
                        for k in ("loss", "grad_norm")},
            "update_rel_l2": float((update - ref_update).norm()
                                   / ref_update.norm()),
            "update_max_abs_err": float((update - ref_update).abs().max()),
            "ms_per_step": ms, "warmup_ms": warm_ms, "peak_gib": peak,
            "launches": launches, "runner_build_s": build_s,
            "bytes_reduced_per_step": 4 * update.numel(),
            "all_reduce_ms": (time.perf_counter() - t0) * 1e3}


def small_train_inputs(frames):
    """The goldens' x8 model (f32) and a fixed B = 1 batch, t and noise of
    ``frames`` frames at 64²."""
    _, _, flat = golden("x8_s64")
    model = BicubicUNet(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
                        attn_res=(32,), vsrpp_res=(64,), image_size=64,
                        num_frames=3, head_dim=8)
    model.load_state_dict(from_flax_bicubic_unet(flat))
    rng = np.random.default_rng(2)
    x0, low = (np.tanh(rng.standard_normal((1, frames, 64, 64, 3)))
               .astype(np.float32) for _ in range(2))
    noise = rng.standard_normal((1, frames, 64, 64, 3)).astype(np.float32)
    return model, {"x_start": x0, "low_res_input": low}, noise


def small_frame_step(mesh=None):
    """One ``make_train_step`` of the goldens' x8 model, f32, TF32 off, on
    the card, B = 1, T = SMALL_FRAME_T, t and noise fixed, under ``mesh``
    (``batch`` cut to this rank's frames): (state, metrics) on the CPU."""
    no_tf32()
    dev = torch.device("cuda")
    model, batch, noise = small_train_inputs(SMALL_FRAME_T)
    model.to(dev)
    d = x8_train_diffusion(dev)
    cfg = TrainConfig(lr=TRAIN_LR, ema_rates=(0.9999,))
    state = create_train_state(dict(model.named_parameters()), cfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    state, met = make_train_step(d, wrap_bicubic_train(d, model), cfg,
                                 mesh=mesh)(
        state, batch, t=torch.tensor([700], device=dev),
        noise=torch.as_tensor(noise, device=dev))
    cpu = lambda v: {k: t.detach().cpu() for k, t in v.items()}  # noqa: E731
    return (types.SimpleNamespace(params=cpu(state.params),
                                  ema_params=(cpu(state.ema_params[0]),)),
            {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
             "grads": cpu(met["grads"])})


def rank_small_frame_step():
    return small_frame_step(make_mesh(None, shape=(1, dist.get_world_size())))


def phase_train_dp(ctx):
    """Data- and frame-parallel training on SHARD_RANKS gloo ranks sharing
    this card. (1) The x8 BicubicUNet at the registry defaults with remat
    (bf16 trunk, float32 parameters), two steps at B = SHARD_RANKS, T =
    SHARD_TRAIN_T, 512², through TrainRunner in this process, then freed;
    then two steps on the ranks, B = 1 each (``TrainRunner(mesh=)``, the
    same generator: the same global t and noise); the second steps
    compared and timed: loss and grad_norm within TRAIN_DP_TOL relative,
    the update's relative L2 error within TRAIN_DP_TOL. (2) One f32 step of the goldens' x8 model (TF32 off) on a
    (data 1 × frame 2) mesh against the unsharded step, as
    slice_small_train compares cuda with cpu."""
    dev = torch.device("cuda")
    batch, _ = x8_train_batch(SHARD_TRAIN_T, dev, clips=SHARD_RANKS)
    model = full_x8(use_checkpoint=True)
    # remat runs each level block's forward twice: 2 × 2 branches ×
    # (T - 1) frames a VSR++ site, on every rank as unsharded
    expect = {"dcn_raw": 2 * 2 * (SHARD_TRAIN_T - 1) * dcn_sites(model),
              "flash_attn": 0,
              **vsrpp_expected(2 * dcn_sites(model), SHARD_TRAIN_T)}
    runner = full_dp_runner(model, ctx["tmp"])
    host, ms, launches, warm_ms, peak, update = warm_then_timed_step(
        runner, batch)
    ref_path = os.path.join(ctx["tmp"], "train_dp_ref.pt")
    torch.save({"update": update.cpu(), "loss": float(host["loss"]),
                "grad_norm": float(host["grad_norm"])}, ref_path)
    del runner, model, host, update
    torch.cuda.empty_cache()
    host_batch = {k: v.cpu().numpy() for k, v in batch.items()}
    ranks = world(ctx).run(rank_train_dp, host_batch, ref_path)
    rec = {"phase": "train_dp", "model": "bicubic_unet (registry defaults, "
           "use_checkpoint)", "global_batch": [SHARD_RANKS, SHARD_TRAIN_T,
                                                512, 512, 3],
           "unsharded": {"ms_per_step": ms, "warmup_ms": warm_ms,
                         "peak_gib": peak, "launches": launches},
           "per_rank": ranks, "tol": TRAIN_DP_TOL,
           "launches_expected_per_rank": expect, "card": ctx["smi"]}
    for r, pr in enumerate(ranks):
        ctx["launches"][f"train_dp/rank{r}"] = pr["launches"]
    ref_state, ref_met = small_frame_step()
    rows = world(ctx).run(rank_small_frame_step)
    rec["small_frame_step"] = [train_errors(st, met, ref_state, ref_met)
                               for st, met in rows]
    torch.backends.cudnn.allow_tf32 = True
    emit(rec)
    ok = (launches == expect
          and all(pr["launches"] == expect for pr in ranks)
          and all(max(pr["rel_err"].values()) <= TRAIN_DP_TOL["rel_err"]
                  and pr["update_rel_l2"] <= TRAIN_DP_TOL["update_rel_l2"]
                  for pr in ranks)
          and all(train_ok(r) for r in rec["small_frame_step"]))
    if not ok:
        raise AssertionError(f"train_dp failed its checks: {rec}")


def detector_pair(model):
    """The same ``RetinaFaceDetector`` weights on the cpu and on the card."""
    return {dev: RetinaFaceDetector(
        (model if dev == "cpu" else copy.deepcopy(model).to(dev)).eval())
        for dev in ("cpu", "cuda")}


def output_err(dets, x):
    """Each device's network outputs on ``x``, and their max abs gaps."""
    out = {dev: d.network(x) for dev, d in dets.items()}
    err = {name: float(np.abs(a - b).max()) for name, a, b in
           zip(("loc", "conf", "landms"), out["cuda"], out["cpu"])}
    return out, err


def phase_detector(ctx):
    """RetinaFace ResNet50 as the CLI builds it (f32, seeded random weights
    at 0.02) on one seeded 512² frame: the cuda network (TF32 off) against
    the cpu one on the same weights, and its time. Those weights score
    every anchor alike (the body's signal dies at 0.02 a weight, so scores
    tie in large groups), which leaves ``detect_faces`` nothing to order.
    Its boxes are checked on a second seeded model whose scores spread:
    the layers' own fan-in init with the heads scaled by DET_HEAD_SCALE.
    There the box threshold keeps the top-k anchors, k the longest run of
    cpu scores each DET_GAP errors from the next, so both devices pass the
    same anchors in the same order, and NMS at 0.4 must drop some."""
    model = RetinaFace(network="resnet50")
    model.random_init(seed=0, scale=0.02)
    dets = detector_pair(model)
    bgr = np.random.default_rng(0).uniform(
        0, 255, (DET_SIZE, DET_SIZE, 3)).astype(np.float32)
    x = (bgr - np.array([104.0, 117.0, 123.0]))[None].astype(np.float32)
    out, err = output_err(dets, x)

    torch.manual_seed(0)
    spread = RetinaFace(network="resnet50")
    with torch.no_grad():
        for name, p in spread.named_parameters():
            if "_head" in name:
                p.mul_(DET_HEAD_SCALE)
    sdets = detector_pair(spread)
    sout, serr = output_err(sdets, x)
    scores = np.sort(sout["cpu"][1][0, :, 1])[::-1]
    need = DET_GAP * max(max(serr.values()), 1e-7)
    k = int(np.argmax(np.append(scores[:-1] - scores[1:], 0.0) <= need))
    thr = float(scores[k - 1] + scores[k]) / 2 if k else 1.0
    b = {dev: d.detect_faces(bgr, thr, 0.4) for dev, d in sdets.items()}
    same = b["cuda"].shape == b["cpu"].shape
    boxes = {"threshold": thr, "nms": 0.4, "passed": k,
             "kept": len(b["cpu"]), "same_count": same,
             "max_abs_err": serr,
             "max_abs_px": (float(np.abs(b["cuda"] - b["cpu"]).max())
                            if same and len(b["cpu"]) else 0.0)}

    det = dets["cuda"]
    t = torch.as_tensor(x, device=next(det.model.parameters()).device
                        ).permute(0, 3, 1, 2)
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        net_ms = cuda_ms(lambda: det.model(t), reps=5, warmup=2, batches=3)
    torch.backends.cudnn.allow_tf32 = True
    det.network = lambda _x: out["cuda"]
    host_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        det.detect_faces(bgr)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    rec = {"phase": "detector", "network": "resnet50", "frame": DET_SIZE,
           "max_abs_err": err, "tol_abs": DET_TOL, "box_check": boxes,
           "network_ms": net_ms, "host_decode_nms_ms": float(np.median(host_ms)),
           "card": ctx["smi"]}
    emit(rec)
    if not (max(err.values()) <= DET_TOL and max(serr.values()) <= DET_TOL
            and k >= DET_MIN_BOXES and same and len(b["cpu"]) < k
            and boxes["max_abs_px"] <= 1e-2):
        raise AssertionError(f"detector failed its checks: {rec}")


class CliProbe:
    """Within ``with``: ``restore_video``'s device-synchronised time inside
    the CLI, the frames the CLI hands ``save_frames``, the frames in which
    the face helper's detector found a face, and the synchronised seconds
    and calls of detection and of the ParseNet and CodeFormer appliers
    (inside ``restore_s``)."""

    def __enter__(self):
        self.restore_s, self.saved = 0.0, []
        self.frames_detected = self.frames_with_face = 0
        self.face_s = {"detect": 0.0, "parsenet": 0.0, "codeformer": 0.0}
        self.face_calls = dict.fromkeys(self.face_s, 0)
        self._orig = (cli.restore_video, cli.save_frames,
                      FaceRestoreHelper.get_affine_matrices,
                      cli.build_face_stack)
        restore, save, mats, stack = self._orig

        def synced(fn, key):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                if key == "restore":
                    self.restore_s += time.perf_counter() - t0
                else:
                    self.face_s[key] += time.perf_counter() - t0
                    self.face_calls[key] += 1
                return out
            return run

        timed_restore = synced(restore, "restore")
        timed_mats = synced(mats, "detect")

        def timed_stack(*args, **kw):
            helper, cf_apply, pn_apply = stack(*args, **kw)
            return (helper, synced(cf_apply, "codeformer"),
                    synced(pn_apply, "parsenet"))

        def kept_save(frames01, output_dir):
            self.saved.append(np.asarray(frames01))
            return save(frames01, output_dir)

        def counted_mats(helper, frames01, **kw):
            m = timed_mats(helper, frames01, **kw)
            self.frames_detected += len(m)
            self.frames_with_face += sum(a is not None for a in m)
            return m

        cli.restore_video, cli.save_frames = timed_restore, kept_save
        FaceRestoreHelper.get_affine_matrices = counted_mats
        cli.build_face_stack = timed_stack
        return self

    def __exit__(self, *exc):
        (cli.restore_video, cli.save_frames,
         FaceRestoreHelper.get_affine_matrices,
         cli.build_face_stack) = self._orig


def phase_cli(ctx):
    """The entry point, in process: ``flair_tpu_torch.cli.main`` on seeded
    random PNG clips it reads from disk, with the CLI's own seeded random
    weights (CLI_RUNS). Each run's K1 / K2 counts are set to 0 just before
    ``main`` and read just after, and held to the expected launches per
    denoiser step × 25 steps × windows."""
    with tempfile.TemporaryDirectory() as tmp:
        for path, argv, n, size in CLI_RUNS:
            clip_dir = os.path.join(tmp, path, "in")
            out_dir = os.path.join(tmp, path, "out")
            os.makedirs(clip_dir)
            rng = np.random.default_rng(0)
            for i in range(n):
                write_png(os.path.join(clip_dir, f"{i:04d}.png"),
                          rng.integers(0, 256, (size, size, 3), np.uint8))
            n_windows = len(window_slices(n))
            held_gib = torch.cuda.memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            deform_conv2d_raw.launches = flash_attention.launches = 0
            t0 = time.time()
            with CliProbe() as probe:
                rc = cli.main(argv[:1] + ["--input-dir", clip_dir,
                                          "--output-dir", out_dir] + argv[1:])
                torch.cuda.synchronize()
            secs = time.time() - t0
            launches = {"dcn_raw": deform_conv2d_raw.launches,
                        "flash_attn": flash_attention.launches}
            expect = {"dcn_raw": DCN_PER_STEP[path] * CLI_STEPS * n_windows,
                      "flash_attn": FLASH_PER_STEP[path] * CLI_STEPS
                      * n_windows}
            files = sorted(os.listdir(out_dir))
            imgs = [read_png(os.path.join(out_dir, f)) for f in files]
            face = "--no-face" not in argv
            rec = {"phase": "cli", "path": path,
                   "argv": argv[:1] + ["--input-dir", "<clip>"] + argv[1:],
                   "clip": [n, size, size, 3], "rc": rc,
                   "windows": n_windows, "files": len(files),
                   "png_shapes": sorted({str(i.shape) for i in imgs}),
                   "finite": all(bool(np.isfinite(f).all())
                                 for f in probe.saved),
                   "launches": launches, "launches_expected": expect,
                   "frames_detected": probe.frames_detected,
                   "frames_with_face": probe.frames_with_face,
                   "face_seconds": probe.face_s,
                   "face_calls": probe.face_calls,
                   "seconds_total": secs,
                   "seconds_restore": probe.restore_s,
                   "ms_per_step": probe.restore_s / (CLI_STEPS * n_windows)
                   * 1e3,
                   "max_memory_allocated_gib":
                       torch.cuda.max_memory_allocated() / 2 ** 30,
                   "allocated_before_gib": held_gib,
                   "card": ctx["smi"]}
            emit(rec)
            ctx.setdefault("launches", {})[path] = launches
            if not (rc == 0 and files == [f"{i:04d}.png" for i in range(n)]
                    and all(i.shape == (512, 512, 3) for i in imgs)
                    and rec["finite"] and launches == expect
                    and probe.frames_detected == (n * n_windows if face
                                                  else 0)):
                raise AssertionError(f"cli {path} failed its checks: {rec}")


KERNEL_CLASSES = (   # first match wins, on the lower-cased kernel name
    ("dcn_raw (K1)", ("dcn_raw",)),
    ("flash_attn (K2)", ("flash_fwd",)),
    ("grid_sample", ("sampler",)),
    ("pad / layout", ("pad", "nchwtonhwc", "nhwctonchw")),
    ("convolution", ("fprop", "conv", "dgrad")),
    ("matmul", ("gemm", "gemv", "cutlass")),
    ("softmax", ("softmax",)),
    ("reduction / norm", ("reduce", "norm", "welford", "moments")),
    ("cat / copy", ("cat", "copy")),
    ("gather", ("indexselect", "index_select", "gather")),
    ("fft", ("fft",)),
    ("elementwise", ("elementwise",)),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def profile_call(ctx, path, call):
    """``call`` once to warm up, then once under torch.profiler: device
    time by kernel and by class of kernel, each hand-written kernel's
    share, and the idle share of the call's wall time."""
    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            t0 = time.time()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
    by_name = device_ms_by_kernel(prof)
    busy = sum(by_name.values())
    by_class = {}
    for k, v in by_name.items():
        by_class[kernel_class(k)] = by_class.get(kernel_class(k), 0.0) + v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "profile_step", "path": path, "wall_ms": wall_ms,
          "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
          "dcn_ms": by_class.get("dcn_raw (K1)", 0.0),
          "flash_ms": by_class.get("flash_attn (K2)", 0.0),
          "class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
          "top_kernels_ms": [[k[:120], v] for k, v in top],
          "card": ctx["smi"]})
    if busy <= 0:
        raise AssertionError("profile_step: the profiler saw no device time")


def phase_profile_step(ctx):
    """One denoiser call of each full-width model at a window's shape, one
    face call of slice_full_face (10 faces at 512²), and one call of each
    model interp_full, davsr_full and priors_full ran, under
    torch.profiler (``profile_call``)."""
    dev = torch.device("cuda")
    for name, call in ctx.get("video_calls", {}).items():
        profile_call(ctx, name, call)
    for name, call in ctx.get("prior_calls", {}).items():
        profile_call(ctx, name, call)
    for name, (task, model, model_apply, clip) in ctx.get("full", {}).items():
        cfg = TASK_CONFIGS[task]
        frames = torch.as_tensor(clip[None, :10], device=dev)
        init = init_from_degraded(frames, cfg)
        rnn = rnn_input_for(frames, init, cfg)
        x = torch.randn(init.shape, generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
        with torch.no_grad():
            flows = model_apply.flows_fn(rnn)
        profile_call(ctx, name,
                     lambda: model_apply(x, 0, init, rnn, None, flows))
        if name == "slice_full_face":
            (cf, pn), _ = ctx["face"]
            face_fn = make_face_fn_p(cf, pn, face_size=cfg.output_size)
            mats = torch.as_tensor(np.tile(FACE_MATRIX, (10, 1, 1)),
                                   device=dev)
            profile_call(ctx, "face_fn", lambda: face_fn(init, x, mats))


def norm_inputs(hw, c, g, seed, dev):
    """A seeded (1, 10, hw, hw, c) bf16 window with per-channel means and
    scales, weight near 1 and bias near 0 in float32."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    x = randn(1, 10, hw, hw, c) * (1 + randn(c).abs()) + randn(c)
    return (x.to(torch.bfloat16), g, 1 + randn(c, scale=0.1),
            randn(c, scale=0.1))


def phase_kernel_norm(ctx):
    """The GroupNorm kernel with SiLU (as ResBlock's in_norm and SR3Block
    run it) at NORM_SHAPES: its bf16 output against the plain version on
    float32 copies, its launches, and its time beside the plain
    composition's in bf16 and the bound; the profiler's device time of
    each of its three kernels."""
    dev = torch.device("cuda")
    rows = []
    for i, (hw, c, g) in enumerate(NORM_SHAPES):
        args = norm_inputs(hw, c, g, 700 + i, dev)
        x = args[0]
        before = group_norm_act.launches
        with torch.no_grad():
            out = group_norm_act(*args, act="silu")
            ref = group_norm_act_plain(x.float(), *args[1:], act="silu")
        torch.cuda.synchronize()
        launched = group_norm_act.launches - before
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        del out, ref
        with torch.no_grad():
            ms = cuda_ms(lambda: group_norm_act(*args, act="silu"), reps=20)
            plain_ms = cuda_ms(
                lambda: group_norm_act_plain(*args, act="silu"), reps=20)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    group_norm_act(*args, act="silu")
                torch.cuda.synchronize()
        group_norm_act.launches = before + launched   # timing does not count
        by_kernel = {}
        for k, v in device_ms_by_kernel(prof).items():
            m = re.search(r"group_norm_\w+(<[^()]*>)?", k)
            key = m.group(0) if m else k[:60]
            by_kernel[key] = by_kernel.get(key, 0.0) + v / 5
        nbytes = 3 * x.numel() * x.element_size()
        row = {"shape": f"x(1,10,{hw},{hw},{c}) G={g}",
               "dtype": str(x.dtype), "act": "silu", "max_abs_err": err,
               "max_rel_err": rel, "tol_rel": NORM_TOL_REL,
               "launches_a_call": launched, "ms": ms, "plain_ms": plain_ms,
               "kernel_ms": by_kernel,
               "library_ms": None, "bound_ms": nbytes / MEM_BW * 1e3,
               "bound_by": "bytes", "bytes": nbytes,
               "bound_share": nbytes / MEM_BW * 1e3 / ms,
               "card": ctx["smi"]}
        emit({"phase": "kernel_norm", **row})
        rows.append(row)
        if not (rel <= NORM_TOL_REL and launched == 3):
            raise AssertionError(f"group_norm kernel fails at {row['shape']}: "
                                 f"rel {rel} (tol {NORM_TOL_REL}), "
                                 f"{launched} launches")
        del x, args
        torch.cuda.empty_cache()
    ctx["norm_rows"] = rows


VSRPP_OPS = ("warp_pair", "bias_act", "gate_tail")


def vsrpp_launches() -> dict:
    """The BasicVSR++ step kernels' launch counters, by kernel."""
    return {f"vsrpp_{op}": getattr(vsrpp_step, op).launches
            for op in VSRPP_OPS}


def reset_vsrpp_launches() -> None:
    for op in VSRPP_OPS:
        getattr(vsrpp_step, op).launches = 0


def vsrpp_expected(calls: int, frames: int) -> dict:
    """The step kernels' launches of ``calls`` BasicVSRPP forwards over
    ``frames`` frames with grad off, two branches a call: a warp at every
    frame after a branch's first, a tail at every frame, and bias passes:
    2 hoisted a branch, 2 at its first frame (the input conv's and the
    residual block's first conv's), 6 at every other."""
    return {"vsrpp_warp_pair": calls * 2 * (frames - 1),
            "vsrpp_bias_act": calls * 2 * (6 * frames - 2),
            "vsrpp_gate_tail": calls * 2 * frames}


def vsrpp_inputs(hw, c, dtype, g, seed, dev):
    """One frame of a VSR++ step (B = 1, NHWC storage, ``dtype``): the
    pair [n1 | n2], two smooth flows of up to ±6 px (samples past every
    border), conv outputs of C and 27·G channels, an addend, float32
    biases, the gate per frame and per pixel, an output slot."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def act(ch):
        return randn(1, ch, hw, hw).to(dtype).contiguous(
            memory_format=torch.channels_last)

    yy = torch.arange(hw, device=dev).view(hw, 1) / hw
    xx = torch.arange(hw, device=dev).view(1, hw) / hw

    def flow():
        ph = randn(2) * 6.28
        return torch.stack([6 * torch.sin(6.28 * (yy + 2 * xx) + ph[0]),
                            6 * torch.cos(6.28 * (2 * yy - xx) + ph[1])])[None]

    return {"pair": act(2 * c), "f1": flow(), "f2": flow(), "x": act(c),
            "xo": act(27 * g), "add": act(c), "bias": randn(c) * 0.1,
            "bias_o": randn(27 * g) * 0.1, "prop": act(c), "r": act(c),
            "y": act(c), "gate_f": torch.rand((1, 1, 1, 1), generator=gen,
                                              device=dev).to(dtype),
            "gate_p": torch.rand((1, hw, hw, 1), generator=gen,
                                 device=dev).to(dtype),
            "out": act(c)}


def vsrpp_rows(hw, c, dtype, g, seed, dev):
    """Each op of a VSR++ frame at one width: (label, kernel call, plain
    call on the same tensors, plain call on float32 copies, bytes read and
    written once)."""
    a = vsrpp_inputs(hw, c, dtype, g, seed, dev)
    f = {k: (v.float() if v.dtype == dtype else v) for k, v in a.items()}
    s, px = torch.finfo(dtype).bits // 8, hw * hw
    plane = c * px * s
    warp = (lambda t: (lambda: vsrpp_step.warp_pair(t["pair"], t["f1"],
                                                    t["f2"])))
    plain_warp = (lambda t: (lambda: vsrpp_step.warp_pair_plain(
        t["pair"], t["f1"], t["f2"])))
    rows = [("warp_pair", warp(a), plain_warp(a), plain_warp(f),
             4 * plane + 4 * px * 4)]
    for label, xk, bk, addk, act in (
            ("bias_act addend leaky", "x", None, "add", "leaky"),
            ("bias_act bias leaky", "x", "bias", None, "leaky"),
            ("bias_act bias 27G", "xo", "bias_o", None, None),
            ("bias_act bias relu", "x", "bias", None, "relu")):
        def call(t, fn, xk=xk, bk=bk, addk=addk, act=act):
            return lambda: fn(t[xk], None if bk is None else t[bk],
                              None if addk is None else t[addk], act)
        ch = a[xk].shape[1]
        rows.append((label, call(a, vsrpp_step.bias_act),
                     call(a, vsrpp_step.bias_act_plain),
                     call(f, vsrpp_step.bias_act_plain),
                     (3 if addk else 2) * ch * px * s + ch * 4))
    for label, gk, pk in (("gate_tail frame gate", "gate_f", "prop"),
                          ("gate_tail pixel gate", "gate_p", "prop"),
                          ("gate_tail first frame", "gate_f", None)):
        def call(t, fn, gk=gk, pk=pk):
            return lambda: fn(None if pk is None else t[pk], t["r"], t["y"],
                              t["bias"], t[gk], t["out"], t["pair"])
        rows.append((label, call(a, vsrpp_step.gate_tail),
                     call(a, vsrpp_step.gate_tail_plain),
                     call(f, vsrpp_step.gate_tail_plain),
                     (7 if pk else 6) * plane + a[gk].numel() * s + c * 4))
    return rows


def phase_kernel_vsrpp(ctx):
    """BasicVSR++'s step kernels (csrc/vsrpp_step.cu) at VSRPP_SHAPES: each
    op against its plain version on float32 copies (max error over the
    largest |output|), one launch a call, its time beside the plain
    composition in the working dtype and the bound; then a frame's glue in
    all: the warp, five bias passes at C channels (offset conv 0, 1, 2, the
    input conv, the block's first conv) and one at 27·G (the offset head),
    and the tail."""
    dev = torch.device("cuda")
    out_rows = []
    for i, (hw, c, dtype, g) in enumerate(VSRPP_SHAPES):
        frame = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        for label, kern, plain, plain32, nbytes in vsrpp_rows(
                hw, c, dtype, g, 900 + i, dev):
            before = vsrpp_launches()
            with torch.no_grad():
                out = kern()
                ref = plain32()
            torch.cuda.synchronize()
            launched = sum(vsrpp_launches().values()) - sum(before.values())
            err = (out.float() - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            del out, ref
            with torch.no_grad():
                ms = cuda_ms(kern, reps=20)
                plain_ms = cuda_ms(plain, reps=20)
            for op in VSRPP_OPS:    # timing does not count
                getattr(vsrpp_step, op).launches = before[f"vsrpp_{op}"]
            row = {"shape": f"{label} (1,{hw},{hw},{c}) G={g}",
                   "dtype": str(dtype), "max_abs_err": err,
                   "max_rel_err": rel, "tol_rel": VSRPP_TOL_REL,
                   "launches_a_call": launched, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": nbytes / MEM_BW * 1e3, "bound_by": "bytes",
                   "bytes": nbytes, "bound_share": nbytes / MEM_BW * 1e3 / ms,
                   "card": ctx["smi"]}
            emit({"phase": "kernel_vsrpp", **row})
            out_rows.append(row)
            if not (rel <= VSRPP_TOL_REL and launched == 1):
                raise AssertionError(f"vsrpp_step fails at {row['shape']}: "
                                     f"rel {rel} (tol {VSRPP_TOL_REL}), "
                                     f"{launched} launches")
            # a frame after the first: the warp, the tail with its frame
            # gate, and the bias passes at their sites
            times = {"warp_pair": 1, "gate_tail frame gate": 1,
                     "bias_act addend leaky": 2, "bias_act bias leaky": 2,
                     "bias_act bias 27G": 1, "bias_act bias relu": 1}
            for k in frame:
                frame[k] += times.get(label, 0) * row[k]
        emit({"phase": "kernel_vsrpp", "frame": f"(1,{hw},{hw},{c}) G={g}",
              "dtype": str(dtype), **frame,
              "bound_share": frame["bound_ms"] / frame["ms"],
              "card": ctx["smi"]})
        torch.cuda.empty_cache()
    ctx["vsrpp_rows"] = out_rows


def kernel_record(name, source, replaces, rows, launches, main_path,
                  grad_rows=()):
    """One entry of the ``kernels`` line: the numbers of the first shape
    (the main path's costliest), every shape beside them (checked-only
    rows with null times); max_abs_err over all of them; ``launches`` from
    ``main_path``'s run, every path's in ``launches_by_path``; the
    autograd Function's gradient rows (plain float32 backward) in
    ``backward``."""
    keys = ("shape", "ms", "plain_ms", "library_ms", "library_kernel",
            "bound_ms", "bound_by", "max_abs_err")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(main_path),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
            "library_ms": rows[0].get("library_ms"),
            "shapes": [{k: r.get(k) for k in keys} | {"mrm": r.get("mrm"),
                                                      "dtype": r.get("dtype")}
                       for r in rows],
            "backward": [{k: r[k] for k in ("shape", "dtype", "backward_ms",
                                            "max_rel_err")}
                         for r in grad_rows]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of " + ", ".join(ALL_PHASES + EXTRA_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    ctx: dict = {"profile": "profile_step" in phases, "launches": {},
                 "tmp": tempfile.mkdtemp()}
    seconds = {}
    try:
        for name in ["device"] + [p for p in phases if p != "device"]:
            t0 = time.time()
            globals()[f"phase_{name}"](ctx)
            seconds[name] = round(time.time() - t0, 3)
    finally:
        for w in ctx.get("worlds", {}).values():
            w.close()
        shutil.rmtree(ctx["tmp"], ignore_errors=True)
    launches = {"dcn_raw": {}, "dcn_raw_int8": {}, "flash_attn": {},
                "group_norm": {},
                "probe_dot": ctx.get("probe_launches", {})}
    for path, counts in ctx.get("launches", {}).items():
        for kern, n in counts.items():
            launches.setdefault(kern, {})[path] = n
    emit({"phase_seconds": seconds})
    kernels = []
    if "kernel_dcn" in phases:
        kernels.append(kernel_record(
            "dcn_raw", "flair_tpu_torch/csrc/dcn_raw.cu",
            "flair_tpu/ops/dcn_pallas.py:50", ctx["dcn_rows"],
            launches["dcn_raw"], "cli_x8", ctx["dcn_grad_rows"]))
    if "kernel_dcn" in phases:
        kernels.append(kernel_record(
            "dcn_raw_int8", "flair_tpu_torch/csrc/dcn_raw.cu",
            "flair_tpu/ops/dcn_pallas.py:176", ctx["dcn_int8_rows"],
            launches["dcn_raw_int8"], "slice_full_int8"))
    if "kernel_flash" in phases:
        kernels.append(kernel_record(
            "flash_attn", "flair_tpu_torch/csrc/flash_attn.cu",
            "flair_tpu/ops/attention.py:53", ctx["flash_rows"],
            launches["flash_attn"], "cli_jpeg", ctx["flash_grad_rows"]))
    if "kernel_probe" in phases:
        kernels.append(kernel_record(
            "probe_dot", "flair_tpu_torch/csrc/probe_dot.cu",
            "tools/probe_int8.py:82", ctx["probe_rows"],
            launches["probe_dot"], "probe_256"))
    if "kernel_norm" in phases:
        kernels.append(kernel_record(
            "group_norm", "flair_tpu_torch/csrc/group_norm.cu",
            "none (XLA fuses GroupNorm on the TPU)", ctx["norm_rows"],
            launches["group_norm"], "slice_full"))
    if "kernel_vsrpp" in phases:
        kernels.append(kernel_record(
            "vsrpp_step", "flair_tpu_torch/csrc/vsrpp_step.cu",
            "none (XLA fuses the step's glue on the TPU)", ctx["vsrpp_rows"],
            {path: sum(n for k, n in counts.items()
                       if k.startswith("vsrpp_"))
             for path, counts in ctx.get("launches", {}).items()},
            "slice_full"))
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
