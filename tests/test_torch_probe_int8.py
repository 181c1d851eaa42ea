"""The port's dot probe (flair_tpu_torch/tools/probe_int8.py) against the TPU
probe's own Pallas kernel.

``tools/probe_int8.py`` runs the probe and takes the chip lock when it is
imported, so its ``dot_kernel`` is taken from the file's source (``ast``)
and run through the same ``pl.pallas_call`` / ``PrefetchScalarGridSpec``
in interpret mode, at a small grid (GRID 2, UVP 32, BC 64, REPS 2):

- int8 × int8 → int32 and the in-kernel f32 → int8 quantisation: the plain
  version equals the Pallas kernel exactly;
- bf16 × bf16 → f32: within 1e-6 of the largest output (f32 sums in
  another order than the float64 einsum);
- the same on the edge operands (``make_inputs``' patterns: ramps, int8
  extremes, quantised ties), which are what they claim to be;
- ``probe_dot`` on CPU tensors is the plain version, and checks its
  operands and the kernel's shape limits on every device;
- the CUDA kernel against the plain version at the TPU constants and at
  edge shapes (skips without a card).
"""

import ast
import functools
import os

import numpy as np
import pytest
import torch

from flair_tpu_torch.tools import probe_int8 as port

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID, UVP, BC, REPS = 2, 32, 64, 2


def tpu_dot_kernel(reps):
    """``dot_kernel`` of tools/probe_int8.py, compiled from its source with
    ``REPS = reps``."""
    import jax.numpy as jnp
    from jax import lax

    path = os.path.join(ROOT, "tools", "probe_int8.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "dot_kernel")
    ns = {"jnp": jnp, "lax": lax, "REPS": reps}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["dot_kernel"]


def run_tpu_probe(a, b, acc_dt, quantize):
    """The TPU probe's pallas_call (tools/probe_int8.py:118-134) in
    interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    grid, uvp, bc = a.shape
    lanes = b.shape[2]
    kern = functools.partial(tpu_dot_kernel(b.shape[0]), acc_dt=acc_dt,
                             quantize=quantize)
    return np.asarray(pl.pallas_call(
        kern,
        out_shape=jax_struct((grid, bc, lanes), acc_dt),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0,
            grid=(grid,),
            in_specs=[
                pl.BlockSpec((1, uvp, bc), lambda i: (i, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((b.shape[0], uvp, lanes), lambda i: (0, 0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, bc, lanes), lambda i: (i, 0, 0),
                                   memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(a, b))


def jax_struct(shape, dt):
    import jax

    return jax.ShapeDtypeStruct(shape, dt)


@pytest.mark.parametrize("name", list(port.VARIANTS))
def test_plain_probe_matches_tpu_dot_kernel(name):
    import jax.numpy as jnp

    a, b = port.make_inputs(name, GRID, UVP, reps=REPS, bc=BC, seed=7)
    _, _, acc_dt, quantize = port.VARIANTS[name]
    jdt = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8,
           torch.float32: jnp.float32, torch.int32: jnp.int32}

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jdt[t.dtype])

    ref = run_tpu_probe(to_jax(a), to_jax(b), jdt[acc_dt], quantize)
    out = port.probe_dot_plain(a, b, acc_dt, quantize).numpy()
    assert out.shape == ref.shape == (GRID, BC, 128)
    if acc_dt == torch.int32:
        # the quantised operand must really vary: a in [0, 1) rounds to
        # 0..127, not to a constant
        np.testing.assert_array_equal(out, ref)
        assert np.abs(out).max() > 0
    else:
        err = np.abs(out - ref).max() / np.abs(ref).max()
        assert err <= 1e-6, err


EDGE_OPERANDS = [(name, pattern) for name in port.VARIANTS
                 for pattern in ("ramp", "extreme", "half_steps")
                 if not (pattern == "extreme" and "bf16" in name)
                 and not (pattern == "half_steps" and "quant" not in name)]


@pytest.mark.parametrize("name,pattern", EDGE_OPERANDS)
def test_plain_probe_matches_tpu_dot_kernel_on_edge_operands(name, pattern):
    """Ramps, int8 at +127 x -127 and a on rounding ties: the plain
    version still equals the Pallas kernel (ties to even, as jnp.round),
    and the operands are what the pattern claims."""
    import jax.numpy as jnp

    a, b = port.make_inputs(name, GRID, UVP, reps=REPS, bc=BC, seed=9,
                            pattern=pattern)
    _, _, acc_dt, quantize = port.VARIANTS[name]
    jdt = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8,
           torch.float32: jnp.float32, torch.int32: jnp.int32}

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jdt[t.dtype])

    ref = run_tpu_probe(to_jax(a), to_jax(b), jdt[acc_dt], quantize)
    out = port.probe_dot_plain(a, b, acc_dt, quantize).numpy()
    if acc_dt == torch.int32:
        np.testing.assert_array_equal(out, ref)
    else:
        err = np.abs(out - ref).max() / np.abs(ref).max()
        assert err <= 1e-6, err
    if pattern == "ramp":
        # every 64 x 8 block of the output differs, here and at BC 576
        for bc in (BC, 576):
            a2, b2 = port.make_inputs(name, 2, UVP, reps=REPS, bc=bc,
                                      pattern=pattern)
            o = port.probe_dot_plain(a2, b2, acc_dt, quantize)
            blocks = o.view(2, bc // 64, 64, 16, 8).permute(0, 1, 3, 2, 4)
            flat = blocks.reshape(-1, 64 * 8)
            assert len({tuple(r.tolist()) for r in flat}) == flat.shape[0]
    elif pattern == "extreme":
        assert out.min() == -127 * 127 * REPS * UVP
    else:
        x = a * 127.0
        assert bool(((x - x.floor()) == 0.5).all())
        q = torch.round(x)
        assert (q % 2 == 0).all() and len(torch.unique(q)) > 16


def test_probe_dot_on_cpu_is_the_plain_version():
    """At the kernel's block sizes (BC 192, UVP 64), every variant."""
    for name, (_, _, acc_dt, quantize) in port.VARIANTS.items():
        a, b = port.make_inputs(name, 2, 64, reps=3, bc=192, seed=3)
        before = port.probe_dot.launches
        out = port.probe_dot(a, b, acc_dt, quantize)
        assert port.probe_dot.launches == before
        assert out.dtype == acc_dt
        assert torch.equal(out, port.probe_dot_plain(a, b, acc_dt, quantize))


@pytest.mark.parametrize("fault", ["dtype_mix", "lanes", "uvp"])
def test_probe_dot_rejects_what_no_variant_takes(fault):
    a, b = port.make_inputs("int8 x int8 -> int32", 2, 64, reps=2, bc=192)
    if fault == "dtype_mix":
        a = a.to(torch.bfloat16)
    elif fault == "lanes":
        b = b[..., :64]
    else:
        b = b[:, :32]
    with pytest.raises((TypeError, ValueError)):
        port.probe_dot(a, b, torch.int32)


# shapes and options the kernel does not take; refused on every device
SHAPE_FAULTS = {
    "uvp_not_64": dict(uvp=96),
    "uvp_above_384": dict(uvp=448),
    "bc_not_192": dict(bc=128),
    "bc_not_64_quantised": dict(bc=96, name="f32->int8 quant + int8 dot"),
    "bc_zero": dict(bc=0),
    "grid_zero": dict(grid=0),
    "reps_zero": dict(reps=0),
    "a_not_contiguous": dict(transpose_a=True),
}


@pytest.mark.parametrize("fault", list(SHAPE_FAULTS))
def test_probe_dot_refuses_shapes_the_kernel_does_not_take(fault):
    f = dict(grid=2, uvp=64, bc=192, reps=2, name="int8 x int8 -> int32",
             transpose_a=False) | SHAPE_FAULTS[fault]
    _, _, acc_dt, quantize = port.VARIANTS[f["name"]]
    a, b = port.make_inputs(f["name"], f["grid"], f["uvp"], reps=f["reps"],
                            bc=f["bc"])
    if f["transpose_a"]:
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        port.probe_dot(a, b, acc_dt, quantize)


def test_main_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(port, "GRID", 1)   # main reads it when called
    assert port.main(["64", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5 and lines[-1].endswith(": 0")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


# (variant, UVP, BC, REPS, operand pattern) on 4 grid steps: the TPU
# constants, then the edges where a layout or descriptor fault would show:
# one K tile and rings that never fill, BC of one block, REPS 1-3, ramps
# (every 64 x 8 output block differs), int32 extremes, quantised ties
# (chip_smoke.PROBE_EDGE holds the same rows)
CUDA_CASES = (
    [(name, uvp, 576, 32, "random") for uvp in (256, 384)
     for name in port.VARIANTS]
    + [(name, uvp, bc, reps, pattern)
       for v, name in enumerate(port.VARIANTS)
       for uvp, bc, reps, pattern in (
           (64, port.BLOCK_ROWS[v], 1, "ramp"), (128, 576, 2, "ramp"),
           (192, port.BLOCK_ROWS[v], 3, "random"), (256, 576, 32, "ramp"))]
    + [("int8 x int8 -> int32", 384, 576, 32, "extreme"),
       ("f32->int8 quant + int8 dot", 384, 576, 32, "extreme"),
       ("f32->int8 quant + int8 dot", 256, 576, 32, "half_steps")])


@pytest.mark.cuda
@pytest.mark.parametrize("name,uvp,bc,reps,pattern", CUDA_CASES)
def test_cuda_probe_kernel_matches_plain(cuda_device, name, uvp, bc, reps,
                                         pattern):
    """The kernel on 4 grid steps: int8 and quantised exact, bf16 within
    5e-5 of the largest output: the tensor cores sum REPS·UVP = 8 192 /
    12 288 products in their own f32 order against an exact float64
    reference (1.4e-5 measured at 12 288 on an H100)."""
    a, b = port.make_inputs(name, 4, uvp, reps=reps, bc=bc, seed=11,
                            device=cuda_device, pattern=pattern)
    _, _, acc_dt, quantize = port.VARIANTS[name]
    before = port.probe_dot.launches
    out = port.probe_dot(a, b, acc_dt, quantize)
    torch.cuda.synchronize()
    assert port.probe_dot.launches == before + 1
    ref = port.probe_dot_plain(a, b, acc_dt, quantize)
    if acc_dt == torch.int32:
        assert torch.equal(out, ref)
    else:
        err = (out - ref).abs().max().item() / ref.abs().max().item()
        assert err <= 5e-5, err
