"""Rate probe of the bf16 and int8 tensor-core dots at K1's window-dot shape.

Counterpart of ``tools/probe_int8.py`` (the TPU probe that decided whether
``FLAIR_DCN_INT8`` should run K1's window dots at the MXU's int8 rate;
PERF_TPU_v5e.md:642-677), with the same constants and the same three
variants of ``out[g] = Σ_{r<REPS} a[g]ᵀ · b[r]``:

1. bf16 × bf16 → f32
2. int8 × int8 → int32
3. f32 ``a`` quantised in the kernel (``round(a · 127)`` → int8) × int8 → int32

``probe_dot`` launches the hand-written kernel (``csrc/probe_dot.cu``:
wgmma from a[g]'s slice held in shared memory, b fed by TMA) on CUDA
tensors and runs ``probe_dot_plain`` on CPU tensors; both refuse shapes the
kernel does not take. ``probe_dot.launches`` counts kernel calls.

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
# the kernel's shapes: UVP a multiple of UVP_STEP up to MAX_UVP (a[g]'s slice
# and the b ring fill shared memory at 384), BC a multiple of the block rows
# (three 64-row warpgroups; one for the quantised variant, whose f32 slice
# stays on chip)
UVP_STEP, MAX_UVP = 64, 384
BLOCK_ROWS = (192, 192, 64)
MAX_GRID = 65535
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
    "probe_dot": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
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
    """Raise on anything the kernel does not take, on every device; returns
    the variant."""
    v = _variant(a, b, acc_dtype, quantize)
    if a.dim() != 3 or b.dim() != 3 or b.shape[2] != LANES:
        raise ValueError("probe_dot: a must be (GRID, UVP, BC), b (REPS, "
                         f"UVP, {LANES})")
    if a.shape[1] != b.shape[1]:
        raise ValueError("probe_dot: a and b must share UVP")
    if a.device != b.device:
        raise ValueError("probe_dot: a and b must share a device")
    grid, uvp, bc = a.shape
    bm = BLOCK_ROWS[v]
    if uvp % UVP_STEP or not UVP_STEP <= uvp <= MAX_UVP:
        raise ValueError(f"probe_dot: the kernel needs UVP % {UVP_STEP} == 0 "
                         f"and UVP <= {MAX_UVP}, got UVP={uvp}")
    if bc % bm or bc == 0:
        raise ValueError(f"probe_dot: the kernel needs BC % {bm} == 0, got "
                         f"BC={bc}")
    if not 1 <= grid <= MAX_GRID or b.shape[0] < 1:
        raise ValueError(f"probe_dot: the kernel needs 1 <= GRID <= "
                         f"{MAX_GRID} and REPS >= 1, got GRID={grid} "
                         f"REPS={b.shape[0]}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("probe_dot: a and b must be contiguous")
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
    """``out[g] = Σ_r a[g]ᵀ · b[r]``: the kernel on CUDA tensors, the plain
    version on CPU tensors. Both take contiguous operands with UVP % 64 ==
    0, 64 <= UVP <= 384 and BC % BLOCK_ROWS[variant] == 0 (192; 64 for
    the quantised variant). One call adds one to ``probe_dot.launches``;
    for the int8 variants it launches a small transpose of b (into scratch
    allocated here, its K padded to whole 128-byte rows) before the dot
    kernel, and that pre-pass is part of the call and not counted apart."""
    v = _check(a, b, acc_dtype, quantize)
    if a.device.type == "cpu":
        return probe_dot_plain(a, b, acc_dtype, quantize)
    if a.device.type != "cuda":
        raise ValueError(f"probe_dot: no kernel for {a.device}")
    lib = build.load(KERNEL, _SIGNATURES)
    grid, uvp, bc = a.shape
    reps = b.shape[0]
    out = torch.empty((grid, bc, LANES), dtype=acc_dtype, device=a.device)
    bt = (None if b.dtype == torch.bfloat16 else
          torch.empty(reps * LANES * ((uvp + 127) // 128 * 128),
                      dtype=torch.int8, device=a.device))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.probe_dot(v, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                           None if bt is None else bt.data_ptr(), grid, uvp,
                           bc, reps, stream)
    if rc != 0:
        raise RuntimeError(f"probe_dot kernel launch failed ({rc}): "
                           f"{lib.probe_error_string(rc).decode()}")
    probe_dot.launches += 1
    return out


probe_dot.launches = 0


def make_inputs(name, grid, uvp, reps=REPS, bc=BC, seed=0, device="cpu",
                pattern="random"):
    """Operands for variant ``name``, (grid, uvp, bc) and (reps, uvp, 128).
    ``pattern`` "random" gives the TPU probe's, seeded: a uniform in [0, 1)
    (f32, quantised in the kernel), integers in [-127, 127) (int8) or
    normal (bf16); b int8 or normal bf16. The others are edge cases:
    "ramp" makes a and b modular ramps in (g, k, m) and (r, k, n), exact in
    their type, so that every 64 x 8 block of the output differs; "extreme"
    (int8 variants) puts a at 127 (1.0 before quantisation) and b at -127,
    the int32 sums' extreme; "half_steps" (quantised variant) puts a on
    (k + 0.5) / 127 for seeded k in [0, 127), where round(a · 127) ties."""
    a_dt, b_dt, _, quantize = VARIANTS[name]
    gen = torch.Generator(device=device).manual_seed(seed)
    a_shape, b_shape = (grid, uvp, bc), (reps, uvp, LANES)

    def draw(shape, dt, uniform=False):
        if dt == torch.int8:
            return torch.randint(-127, 127, shape, generator=gen,
                                 device=device, dtype=torch.int8)
        if uniform:
            return torch.rand(shape, generator=gen, device=device)
        return torch.randn(shape, generator=gen, device=device).to(dt)

    def ramp(shape, c0, c1, c2):
        i, j, k = (torch.arange(n, device=device) for n in shape)
        j, k = j.view(1, -1, 1), k.view(1, 1, -1)
        return c0 * i.view(-1, 1, 1) + c1 * j + c2 * k + j * k

    if pattern == "random":
        return draw(a_shape, a_dt, uniform=quantize), draw(b_shape, b_dt)
    if pattern == "ramp":
        ra, rb = ramp(a_shape, 7, 3, 5), ramp(b_shape, 5, 2, 3)
        if a_dt == torch.bfloat16:
            return ((ra % 17 - 8) / 8).to(a_dt), ((rb % 17 - 8) / 4).to(b_dt)
        a = (ra % 127).float() / 127 if quantize else (ra % 255 - 127).to(a_dt)
        return a, (rb % 253 - 126).to(b_dt)
    if pattern == "extreme" and b_dt == torch.int8:
        return (torch.full(a_shape, 1.0 if quantize else 127, dtype=a_dt,
                           device=device),
                torch.full(b_shape, -127, dtype=b_dt, device=device))
    if pattern == "half_steps" and quantize:
        k = torch.randint(0, 127, a_shape, generator=gen, device=device)
        return (k.float() + 0.5) / 127, draw(b_shape, b_dt)
    raise ValueError(f"make_inputs: no pattern {pattern!r} for {name}")


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
