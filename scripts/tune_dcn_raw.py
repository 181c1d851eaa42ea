"""Variants of K1's bf16 kernel (flair_tpu_torch/csrc/dcn_raw.cu) on one
card: each variant is the source with other values of its compile-time
constants (pixel tile TH x TW, resident blocks an SM) or with a few lines
replaced (accurate tanh / sigmoid, or a part taken out). All variants are
built at once, held against the plain twin and timed at chip_smoke.py's
four kernel_dcn rows, in turns (the list, then the list reversed).

    python3 scripts/tune_dcn_raw.py                  # the VARIANTS below
    python3 scripts/tune_dcn_raw.py --only base,16x8

The ablate_* variants take one part out (the corner loads, the MMAs) to
show what the rest costs; their outputs are wrong.

Prints one JSON line per variant build (ptxas) and per timed row. Needs CUDA
and nvcc; builds into build/variants/ (git-ignored).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from flair_tpu_torch.ops import dcn  # noqa: E402
from flair_tpu_torch.ops.deform import deform_conv2d_raw_plain  # noqa: E402
from flair_tpu_torch.utils import build  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "variants")
# The source's own values, and each variant's departures from them.
BASE = {"TH": 8, "TW": 16, "MIN_BLOCKS": 2}
VARIANTS = {
    "base": {},
    "16x8": {"TH": 16, "TW": 8},
    "4x32": {"TH": 4, "TW": 32},
    "2x64": {"TH": 2, "TW": 64},
    "3_blocks": {"MIN_BLOCKS": 3},
    "gather_first": {"_patch": [("    contract(s);\n    gather(s + 1);\n",
                                 "    gather(s + 1);\n    contract(s);\n")]},
    "accurate_prep": {"_patch": [
        ("return 1.0f - __fdividef(2.0f, __expf(2.0f * v) + 1.0f);",
         "return tanhf(v);"),
        ("return __fdividef(1.0f, 1.0f + __expf(-v));",
         "return 1.0f / (1.0f + expf(-v));")]},
    # ablations, timed only (their outputs are wrong): where the time goes
    "ablate_loads": {"_patch": [(
        "? __ldg(reinterpret_cast<const uint4*>(xb + base + coff[q] + v * 8))",
        "? make_uint4(q, v, 0u, 0u)")]},
    "ablate_mma": {"_patch": [
        ("mma16816(acc[mt][2 * np], fa[mt], r[0], r[1]);", ""),
        ("mma16816(acc[mt][2 * np + 1], fa[mt], r[2], r[3]);", "")]},
}


def variant_source(name: str) -> str:
    with open(os.path.join(build.CSRC, "dcn_raw.cu")) as f:
        src = f.read()
    consts = BASE | VARIANTS[name]
    for old, new in consts.pop("_patch", []):
        if src.count(old) != 1:
            raise RuntimeError(f"dcn_raw.cu has no single {old!r}")
        src = src.replace(old, new)
    subs = [(r"constexpr int TH = \d+, TW = \d+;",
             f"constexpr int TH = {consts.pop('TH')}, "
             f"TW = {consts.pop('TW')};")]
    for key, val in consts.items():
        typ, lit = (("bool", "true" if val else "false")
                    if isinstance(val, bool) else ("int", str(val)))
        subs.append((rf"constexpr {typ} {key} = \w+;",
                     f"constexpr {typ} {key} = {lit};"))
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        if n != 1:
            raise RuntimeError(f"dcn_raw.cu has no single match for {pat}")
    return src


def compile_variant(name: str) -> tuple[str, str]:
    os.makedirs(OUT_DIR, exist_ok=True)
    cu = os.path.join(OUT_DIR, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(variant_source(name))
    so = os.path.join(OUT_DIR, f"lib{name}.so")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}")
    return so, r.stdout


def load(so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    for fn, (argtypes, restype) in dcn._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def launcher(lib, args, mrm):
    """What ops/dcn.deform_conv2d_raw does on CUDA, through ``lib``."""
    x, ry, rx, ml, fy, fx, weight, bias = args
    g, a, raw_stride = dcn._check(*args)
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    wk = torch.empty((9, cin, cout), dtype=x.dtype, device=x.device)
    wk.copy_(weight.permute(2, 3, 1, 0).reshape(9, cin, cout))
    b32 = bias.float().contiguous()
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.dcn_raw_forward(
            1, x.data_ptr(), ry.data_ptr(), rx.data_ptr(), ml.data_ptr(),
            fy.data_ptr(), fx.data_ptr(), wk.data_ptr(), b32.data_ptr(),
            out.data_ptr(), b * h * w, h, w, cin, cout, g, a, raw_stride,
            float(mrm), stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc}): "
                               f"{lib.dcn_error_string(rc).decode()}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help="comma list of variant names")
    names = [n for n in ap.parse_args().only.split(",") if n] or list(VARIANTS)
    if not torch.cuda.is_available():
        print("tune_dcn_raw: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(compile_variant, names)))
    libs = {}
    for n in names:
        so, log = built[n]
        rep = chip_smoke.ptxas_report(log)
        print(json.dumps({"variant": n, "constants": repr(VARIANTS[n]),
                          "ptxas": {k: v for k, v in rep.items()
                                    if "bf16" in k}}), flush=True)
        libs[n] = load(so)
    dev = torch.device("cuda")
    cases = []
    for mrm in chip_smoke.DCN_MRMS:
        for i, (h, cin, cout) in enumerate(chip_smoke.DCN_SHAPES):
            args = chip_smoke.dcn_inputs(h, cin, cout, seed=100 + i,
                                         device=dev)
            x, ry, rx, ml, fy, fx, w, b = args
            with torch.no_grad():
                ref = deform_conv2d_raw_plain(x.float(), ry.float(), rx.float(),
                                              ml.float(), fy, fx, w, b, mrm)
            cases.append((f"x(1,{h},{h},{cin})->{cout}", mrm, args, ref))
    for rnd, order in enumerate((names, names[::-1])):
        for n in order:
            for shape, mrm, args, ref in cases:
                run = launcher(libs[n], args, mrm)
                out = run()
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                ms = chip_smoke.cuda_ms(run, reps=20)
                print(json.dumps({"variant": n, "round": rnd, "shape": shape,
                                  "mrm": mrm, "ms": ms, "max_abs_err": err,
                                  "max_rel_err": rel,
                                  "ablation": n.startswith("ablate"),
                                  "ok": err <= chip_smoke.DCN_TOL
                                  and rel <= chip_smoke.DCN_TOL_REL,
                                  "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
