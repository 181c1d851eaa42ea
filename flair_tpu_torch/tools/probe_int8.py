"""Rate probe of the bf16 and int8 tensor-core dots at K1's window-dot shape.

Counterpart of ``tools/probe_int8.py`` (the TPU probe that decided whether
``FLAIR_DCN_INT8`` should run K1's window dots at the MXU's int8 rate;
PERF_TPU_v5e.md:642-677), with the same constants and the same three
variants of ``out[g] = Σ_{r<REPS} a[g]ᵀ · b[r]``:

1. bf16 × bf16 → f32
2. int8 × int8 → int32
3. f32 ``a`` quantised in the kernel (``round(a · 127)`` → int8) × int8 → int32

``probe_dot`` launches the hand-written kernel (``csrc/probe_dot.cu``) on
CUDA tensors and runs ``probe_dot_plain`` on CPU tensors;
``probe_dot.launches`` counts kernel launches.

    python -m flair_tpu_torch.tools.probe_int8 [uvp] [--device cpu]

uvp 256 is the M = 5 window (the default), 384 the M = 10 one. It prints
one row a variant (ms from CUDA events, TFLOP/s) and the int8 check (max
|err| against the plain version), after taking the card lock
(``utils.locking``). Nothing runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time

import numpy as np
import torch

from ..utils import build
from ..utils.device import resolve_device
from ..utils.locking import acquire_tpu_lock, tpu_lock_needed

KERNEL = "probe_dot"
GRID = 1024     # grid steps: distinct a blocks
REPS = 32       # distinct dots a grid step (distinct b)
BC = 576        # rows a (tile, anchor) chunk at (2, 4) tiles
LANES = 128
BM, BK = 192, 64   # the kernel's block rows of BC and K step (int8 bytes)
# name -> (a dtype, b dtype, accumulator dtype, quantise a in the kernel)
VARIANTS = {
    "bf16 x bf16 -> f32": (torch.bfloat16, torch.bfloat16, torch.float32,
                           False),
    "int8 x int8 -> int32": (torch.int8, torch.int8, torch.int32, False),
    "f32->int8 quant + int8 dot": (torch.float32, torch.int8, torch.int32,
                                   True),
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "probe_dot": ([_I, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "probe_error_string": ([_I], ctypes.c_char_p),
}


def _variant(a, b, acc_dtype, quantize: bool) -> int:
    """The kernel's variant for these operands; raises on another mix."""
    mix = (a.dtype, b.dtype, acc_dtype, bool(quantize))
    for i, v in enumerate(VARIANTS.values()):
        if mix == v:
            return i
    raise TypeError(f"probe_dot: no variant for {mix}")


def _check(a, b, acc_dtype, quantize):
    """Raise on anything the kernel does not take; returns the variant."""
    v = _variant(a, b, acc_dtype, quantize)
    if a.dim() != 3 or b.dim() != 3 or b.shape[2] != LANES:
        raise ValueError("probe_dot: a must be (GRID, UVP, BC), b (REPS, "
                         f"UVP, {LANES})")
    if a.shape[1] != b.shape[1]:
        raise ValueError("probe_dot: a and b must share UVP")
    if a.device != b.device:
        raise ValueError("probe_dot: a and b must share a device")
    return v


def probe_dot_plain(a, b, acc_dtype, quantize: bool = False):
    """Plain version: quantise as the kernel does (``round(a · 127)``, half
    to even), then a float64 einsum cast to the accumulator type. Exact for
    the int8 variants (sums below 2⁵³) and for bf16 up to the final
    rounding; the same on the CPU and the card (CUDA has no integer
    einsum). Returns (GRID, BC, 128)."""
    _variant(a, b, acc_dtype, quantize)
    if quantize:
        a = torch.round(a * 127.0).to(torch.int8)
    return torch.einsum("guc,ul->gcl", a.double(),
                        b.double().sum(0)).to(acc_dtype)


def probe_dot(a, b, acc_dtype, quantize: bool = False):
    """``out[g] = Σ_r a[g]ᵀ · b[r]``: the kernel on CUDA tensors (which
    need BC % 192 == 0 and UVP % 64 == 0, contiguous), the plain version
    on CPU tensors."""
    v = _check(a, b, acc_dtype, quantize)
    if a.device.type == "cpu":
        return probe_dot_plain(a, b, acc_dtype, quantize)
    if a.device.type != "cuda":
        raise ValueError(f"probe_dot: no kernel for {a.device}")
    grid, uvp, bc = a.shape
    if bc % BM or uvp % BK:
        raise ValueError(f"probe_dot: the kernel needs BC % {BM} == 0 and "
                         f"UVP % {BK} == 0, got BC={bc} UVP={uvp}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("probe_dot: a and b must be contiguous")
    out = torch.empty((grid, bc, LANES), dtype=acc_dtype, device=a.device)
    lib = build.load(KERNEL, _SIGNATURES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.probe_dot(v, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                           grid, uvp, bc, b.shape[0], stream)
    if rc != 0:
        msg = ("unknown variant" if rc < 0
               else lib.probe_error_string(rc).decode())
        raise RuntimeError(f"probe_dot kernel launch failed ({rc}): {msg}")
    probe_dot.launches += 1
    return out


probe_dot.launches = 0


def make_inputs(name, grid, uvp, reps=REPS, bc=BC, seed=0, device="cpu"):
    """The TPU probe's operands for variant ``name``, seeded: a uniform in
    [0, 1) (f32, quantised in the kernel), integers in [-127, 127) (int8)
    or normal (bf16); b int8 or normal bf16, (reps, uvp, 128)."""
    a_dt, b_dt, _, quantize = VARIANTS[name]
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, dt, uniform=False):
        if dt == torch.int8:
            return torch.randint(-127, 127, shape, generator=gen,
                                 device=device, dtype=torch.int8)
        if uniform:
            return torch.rand(shape, generator=gen, device=device)
        return torch.randn(shape, generator=gen, device=device).to(dt)

    a = draw((grid, uvp, bc), a_dt, uniform=quantize)
    b = draw((reps, uvp, LANES), b_dt)
    return a, b


def op_count(grid, uvp, reps=REPS, bc=BC) -> float:
    """Multiply-adds × 2 of one probe call."""
    return 2.0 * reps * grid * uvp * bc * LANES


def time_ms(fn, device, reps=3) -> float:
    """The least of ``reps`` timed calls after one warm-up: CUDA events on
    the card, perf_counter on the CPU."""
    fn()
    ts = []
    for _ in range(reps):
        if device.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts)


def check_numerics(uvp, device, seed=2) -> int:
    """The int8 kernel against its plain version at one grid step: max
    |err| (0: exact int32 accumulation)."""
    a, b = make_inputs("int8 x int8 -> int32", 1, uvp, seed=seed,
                       device=device)
    out = probe_dot(a, b, torch.int32)
    ref = probe_dot_plain(a, b, torch.int32)
    return int((out.long() - ref.long()).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("uvp", nargs="?", type=int, default=256,
                    help="window rows: 256 (M = 5) or 384 (M = 10)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if (dev.type == "cuda" and tpu_lock_needed()
            and acquire_tpu_lock(timeout_s=7200.0) is None):
        print("card lock busy for 2h; aborting probe", file=sys.stderr)
        return 1
    ops = op_count(GRID, args.uvp)
    note = "" if dev.type == "cuda" else " (the plain version, not a rate)"
    print(f"# uvp={args.uvp} dots={REPS * GRID} "
          f"{ops / 1e12:.2f} TOP on {dev}{note}", flush=True)
    for name, (_, _, acc_dt, quant) in VARIANTS.items():
        a, b = make_inputs(name, GRID, args.uvp, device=dev)
        ms = time_ms(lambda: probe_dot(a, b, acc_dt, quant), dev)
        print(f"{name:32s} {ms:9.3f} ms  {ops / ms / 1e9:8.1f} TFLOP/s",
              flush=True)
        del a, b
    err = check_numerics(args.uvp, dev)
    print(f"int8 dot max |err| vs plain: {err}", flush=True)
    return 0 if err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
