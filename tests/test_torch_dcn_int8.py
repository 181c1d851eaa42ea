"""The port's int8 DCN (``deform_conv2d_raw(..., int8_dots=True)``, the
counterpart of JAX's ``FLAIR_DCN_INT8`` path) against flair_tpu.

- The int8 twin against JAX's Pallas tile kernel with ``int8_dots=True``
  in interpret mode, on inputs with no tile escapes: within 1 % mean
  relative error of it, and at least 1.5× farther from the kernel's bf16
  output than from its int8 output (a twin that ignored the flag would
  sit at the bf16 output's distance).
- The int8 twin against the exact f32 DCN, within JAX's own int8 budget
  (3 %, ``tests/test_ops.py``), at both main-path channel classes, f32
  and bf16 x, flows past the border.
- The gradients do not depend on the flag (the backward is the exact
  f32 VJP, as JAX's ``_tile_raw_ad_bwd`` ignores ``int8_dots``).
- ``FLAIR_DCN_INT8=1`` routes every K1 call of a small BicubicUNet through
  the int8 path; unset, the forward is bit-identical to the flag's off.
- The CUDA int8 instance against the twin (skips without a card).

JAX and flair_tpu are imported inside the parity tests only.
"""

import os

import numpy as np
import pytest
import torch

from flair_tpu_torch.ops.dcn import deform_conv2d_raw
from flair_tpu_torch.ops.deform import (
    deform_conv2d_raw_plain, dequant_scale, quantize_values)
from test_torch_dcn import MRM, make_raw_inputs, to_torch_args

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mean_rel(a, b):
    return float(np.mean(np.abs(a - b)) / np.mean(np.abs(b)))


@pytest.mark.parametrize("cin", [128, 256])
def test_int8_twin_matches_jax_int8_tile_kernel(cin):
    """(1, 16, 32, Cin) → Cin/2 with G = 16 (Cin/G = 8 and 16), flows of
    1.5 px and residues of 0.3: every sample inside its tile's patch."""
    import jax.numpy as jnp
    from flair_tpu.ops.dcn_pallas import (
        _materialize_raw, deform_conv2d_tile, tile_escape_fraction)

    arrs = make_raw_inputs(3, 1, 16, 32, cin, cin // 2, amp=1.5,
                           res_scale=0.3)
    x, ry, rx, ml, fy, fx, wgt, bias = arrs
    jr = [jnp.asarray(a) for a in (ry, rx, ml, fy, fx)]
    off, _ = _materialize_raw(*jr, MRM)
    anchor = jnp.stack([jr[3], jr[4]], axis=-1)
    assert float(tile_escape_fraction(
        anchor, off, tile=(2, 4), patch=(16, 32),
        xpack=128 // (cin // 2))) == 0.0
    ref = {i8: np.asarray(deform_conv2d_tile(
        jnp.asarray(x), (jr[3], jr[4]), None, jnp.asarray(wgt),
        jnp.asarray(bias), raw=tuple(jr), raw_mrm=MRM, tile=(2, 4),
        patch=(16, 32), ntb=8, interpret=True, int8_dots=i8)).astype(
            np.float32) for i8 in (False, True)}
    out = deform_conv2d_raw(*to_torch_args(arrs), MRM,
                            int8_dots=True).numpy()
    to_int8, to_bf16 = mean_rel(out, ref[True]), mean_rel(out, ref[False])
    assert to_int8 <= 0.01, to_int8
    assert to_bf16 >= 1.5 * to_int8, (to_bf16, to_int8)


@pytest.mark.parametrize("cin,g,dtype", [
    (128, 16, torch.float32), (256, 16, torch.bfloat16),
    (128, 8, torch.float32), (64, 8, torch.float32)])
def test_int8_twin_within_jax_budget_of_exact(cin, g, dtype):
    """Flows of 3 px carry samples past the border; Cin/G = 8, 16, 16
    (DAVSR's G = 8) and 8 at Cin = 64."""
    x, ry, rx, ml, fy, fx, wgt, bias = to_torch_args(
        make_raw_inputs(cin + g, 1, 12, 20, cin, cin // 2, g=g))
    x, ry, rx, ml = (t.to(dtype) for t in (x, ry, rx, ml))
    out = deform_conv2d_raw(x, ry, rx, ml, fy, fx, wgt, bias, MRM,
                            int8_dots=True)
    assert out.dtype == dtype
    exact = deform_conv2d_raw_plain(x.float(), ry.float(), rx.float(),
                                    ml.float(), fy, fx, wgt, bias, MRM)
    err = mean_rel(out.float().numpy(), exact.numpy())
    assert 0 < err <= 0.03, err


def test_quantize_values_follows_jax():
    """sx = max|x|, xq = clip(round(x · (127/sx)), ±127), half to even,
    zeros stay zero; dq = sx / 127² in f32."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 7, 32)).astype(np.float32)
    x[0, 0, 0, :4] = 0.0
    xq, sx = quantize_values(torch.from_numpy(x))
    sj = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-20)
    qj = jnp.clip(jnp.round(jnp.asarray(x) * (127.0 / sj)), -127, 127
                  ).astype(jnp.int8)
    assert xq.dtype == torch.int8
    np.testing.assert_array_equal(xq.numpy(), np.asarray(qj))
    assert float(sx) == float(sj)
    assert float(dequant_scale(sx)) == float(
        (sj / (127.0 * 127.0)).astype(jnp.float32))
    assert not xq[0, 0, 0, :4].any()


def test_int8_gradients_equal_the_bf16_paths():
    """All eight gradients with ``int8_dots=True`` equal those without,
    bit for bit."""
    arrs = make_raw_inputs(13, 1, 8, 12, 128, 64)
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 8, 12, 64)).astype(np.float32))
    grads = {}
    for flag in (False, True):
        args = [t.clone().requires_grad_(True) for t in to_torch_args(arrs)]
        out = deform_conv2d_raw(*args, MRM, int8_dots=flag)
        grads[flag] = torch.autograd.grad(out, args, cot)
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


def small_unet_forward(monkeypatch, env):
    """The goldens' BicubicUNet with their weights (goldens/x8_s64) but 8
    deformable groups, one forward with FLAIR_DCN_INT8 set to ``env``
    (None: unset); returns the output and the ``int8_dots`` of every K1
    call. The goldens' 16 groups give Cin/G = 4, which the int8 instance
    does not take; with 8, each offset head keeps its leading 27·8 rows."""
    import flair_tpu_torch.models.vsrpp as vsrpp
    from flair_tpu_torch.models.sr3 import BicubicUNet
    from flair_tpu_torch.utils.convert import from_flax_bicubic_unet

    if env is None:
        monkeypatch.delenv("FLAIR_DCN_INT8", raising=False)
    else:
        monkeypatch.setenv("FLAIR_DCN_INT8", env)
    flags = []

    def spy(*args, int8_dots=False):
        flags.append(int8_dots)
        return deform_conv2d_raw(*args, int8_dots=int8_dots)

    monkeypatch.setattr(vsrpp, "deform_conv2d_raw", spy)
    model = BicubicUNet(inner_channel=32, norm_groups=16,
                        channel_mults=(1, 2), attn_res=(32,),
                        vsrpp_res=(64,), image_size=64, res_blocks=1,
                        num_frames=3, head_dim=8, deform_groups=8)
    sd = from_flax_bicubic_unet(dict(np.load(
        os.path.join(ROOT, "goldens", "x8_s64", "params.npz"))))
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    model.load_state_dict({k: v[:shapes[k][0]] for k, v in sd.items()})
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 3, 64, 64, 3)).astype(np.float32)
    low = np.clip(rng.standard_normal((1, 3, 64, 64, 3)) * 0.5, -1, 1
                  ).astype(np.float32)
    lvl = np.array([[0.3, 0.3, 0.3]], np.float32)
    with torch.no_grad():
        out = model(*map(torch.from_numpy, (x, lvl, low)))
    return out, flags


def test_env_routes_every_k1_call(monkeypatch):
    """FLAIR_DCN_INT8=1: every alignment takes the int8 path and the
    output moves; unset or "0": none does, and the output is the same bit
    for bit."""
    on, flags_on = small_unet_forward(monkeypatch, "1")
    off, flags_off = small_unet_forward(monkeypatch, None)
    zero, flags_zero = small_unet_forward(monkeypatch, "0")
    assert flags_on and all(flags_on)
    assert len(flags_off) == len(flags_on) and not any(flags_off)
    assert not any(flags_zero)
    assert torch.equal(off, zero)
    assert not torch.equal(on, off)
    assert torch.isfinite(on).all()


@pytest.mark.parametrize("fault", ["cin_per_group", "x_dtype"])
def test_wrapper_rejects_what_the_int8_instance_does_not_take(fault):
    """Checked on every device: Cin/G must be a multiple of 8 (4 passes
    without the flag at f32 x), x bf16 or f32."""
    x, ry, rx, ml, fy, fx, wgt, bias = to_torch_args(
        make_raw_inputs(5, 1, 6, 8, 64, 32, g=16 if fault == "cin_per_group"
                        else 8))
    deform_conv2d_raw(x, ry, rx, ml, fy, fx, wgt, bias, MRM)
    if fault == "x_dtype":
        x, ry, rx, ml = (t.half() for t in (x, ry, rx, ml))
    with pytest.raises((ValueError, TypeError)):
        deform_conv2d_raw(x, ry, rx, ml, fy, fx, wgt, bias, MRM,
                          int8_dots=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cin,g,dtype", [
    (128, 16, torch.bfloat16), (256, 16, torch.bfloat16),
    (128, 8, torch.float32)])
def test_cuda_int8_kernel_matches_twin(cuda_device, cin, g, dtype):
    """The int8 instance against its plain twin on the card: the same
    quantised values and integer weights up to the approximate tanh /
    sigmoid of the kernel's prep and the order of its sums; within 3e-2
    abs and 1e-2 of the largest output. One launch, counted apart from
    the bf16 instance's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, ry, rx, ml, fy, fx, wgt, bias = (
        t.to(cuda_device) for t in to_torch_args(
            make_raw_inputs(31, 1, 40, 72, cin, cin // 2, g=g)))
    wgt = wgt * (10.0 / (9 * cin) ** 0.5)
    x, ry, rx, ml = (t.to(dtype) for t in (x, ry, rx, ml))
    before = (deform_conv2d_raw.launches, deform_conv2d_raw.launches_int8)
    out = deform_conv2d_raw(x, ry, rx, ml, fy, fx, wgt, bias, MRM,
                            int8_dots=True)
    torch.cuda.synchronize()
    assert (deform_conv2d_raw.launches,
            deform_conv2d_raw.launches_int8) == (before[0], before[1] + 1)
    ref = deform_conv2d_raw_plain(x, ry, rx, ml, fy, fx, wgt, bias, MRM,
                                  int8_dots=True)
    err = (out.float() - ref.float()).abs().max().item()
    assert err < 3e-2 and err / ref.abs().max().item() < 1e-2, err
