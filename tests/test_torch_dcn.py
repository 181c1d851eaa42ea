"""Port DCN (flair_tpu_torch/ops/{deform,dcn}.py) against flair_tpu.

- The plain raw DCN against flair_tpu's ``_materialize_raw`` +
  ``modulated_deform_conv2d`` (f32, ≤1e-4 abs), with flows that cross the
  image border.
- The plain raw DCN against the Pallas tile kernel in interpret mode on an
  input with no tile escapes (the kernel computes in bf16: ≤2e-2 mean
  relative error, the bound ``tests/test_ops.py`` holds it to).
- The CUDA kernel against the plain version (skips without a card).
- The wrapper's input checks, which run on every device.

JAX and flair_tpu are imported inside the parity tests, so the CUDA case
also runs on a GPU machine that has no JAX.
"""

import numpy as np
import pytest
import torch

from flair_tpu_torch.ops.dcn import deform_conv2d_raw
from flair_tpu_torch.ops.deform import deform_conv2d_raw_plain, materialize_raw

torch.set_num_threads(1)

MRM = 5.0


def make_raw_inputs(seed, b, h, w, cin, cout, g=16, amp=3.0, res_scale=1.0):
    """Seeded numpy inputs of the raw DCN: smooth flows of ``amp`` pixels
    (large enough to carry border samples outside the image), pre-tanh
    residues and mask logits in (group, tap) order, HWIO weights."""
    rng = np.random.default_rng(seed)
    a = 2
    x = rng.standard_normal((b, h, w, cin), dtype=np.float32)
    yy = np.arange(h, dtype=np.float32)[None, :, None, None] / h
    xx = np.arange(w, dtype=np.float32)[None, None, :, None] / w
    ph = rng.uniform(0, 6.28, (1, 1, 1, a)).astype(np.float32)
    flow_y = (amp * np.sin(2 * np.pi * (yy + xx) + ph)
              * np.ones((b, h, w, a), np.float32)).astype(np.float32)
    flow_x = (amp * np.cos(2 * np.pi * (yy - xx) + ph)
              * np.ones((b, h, w, a), np.float32)).astype(np.float32)
    res_y = (rng.standard_normal((b, h, w, g * 9)) * res_scale).astype(np.float32)
    res_x = (rng.standard_normal((b, h, w, g * 9)) * res_scale).astype(np.float32)
    mlog = rng.standard_normal((b, h, w, g * 9)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    return x, res_y, res_x, mlog, flow_y, flow_x, wgt, bias


def to_torch_args(arrs):
    x, ry, rx, ml, fy, fx, wgt, bias = (torch.from_numpy(a) for a in arrs)
    return x, ry, rx, ml, fy, fx, wgt.permute(3, 2, 0, 1).contiguous(), bias


@pytest.mark.parametrize("cin", [64, 128, 256])
def test_plain_raw_dcn_matches_flair_tpu_exact(cin):
    import jax.numpy as jnp
    from flair_tpu.ops.dcn_pallas import _materialize_raw
    from flair_tpu.ops.deform import modulated_deform_conv2d

    arrs = make_raw_inputs(cin, 2, 10, 12, cin, cin // 2)
    x, ry, rx, ml, fy, fx, wgt, bias = arrs
    off, mask = _materialize_raw(*(jnp.asarray(a) for a in (ry, rx, ml, fy, fx)),
                                 MRM)
    # the flows carry some samples fully outside the image
    assert float(jnp.abs(off).max()) > 3.0
    ref = np.asarray(modulated_deform_conv2d(
        jnp.asarray(x), off, mask, jnp.asarray(wgt), jnp.asarray(bias),
        padding=1))
    out = deform_conv2d_raw(*to_torch_args(arrs), MRM).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_materialize_raw_matches_flair_tpu():
    import jax.numpy as jnp
    from flair_tpu.ops.dcn_pallas import _materialize_raw

    arrs = make_raw_inputs(7, 1, 4, 6, 64, 32)
    _, ry, rx, ml, fy, fx, _, _ = arrs
    off_j, m_j = _materialize_raw(
        *(jnp.asarray(a) for a in (ry, rx, ml, fy, fx)), MRM)
    off_t, m_t = materialize_raw(
        *(torch.from_numpy(a) for a in (ry, rx, ml, fy, fx)), MRM)
    np.testing.assert_allclose(off_t.numpy(), np.asarray(off_j), atol=1e-6)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-6)


def test_plain_raw_dcn_matches_pallas_tile_kernel_without_escapes():
    import jax.numpy as jnp
    from flair_tpu.ops.dcn_pallas import (
        _materialize_raw, deform_conv2d_tile, tile_escape_fraction)

    h, w, cin = 16, 32, 128
    arrs = make_raw_inputs(3, 1, h, w, cin, cin // 2, amp=1.5, res_scale=0.3)
    x, ry, rx, ml, fy, fx, wgt, bias = arrs
    jr = [jnp.asarray(a) for a in (ry, rx, ml, fy, fx)]
    off, _ = _materialize_raw(*jr, MRM)
    anchor = jnp.stack([jr[3], jr[4]], axis=-1)
    assert float(tile_escape_fraction(
        anchor, off, tile=(2, 4), patch=(16, 32))) == 0.0
    ref = np.asarray(deform_conv2d_tile(
        jnp.asarray(x), (jr[3], jr[4]), None, jnp.asarray(wgt),
        jnp.asarray(bias), raw=tuple(jr), raw_mrm=MRM, tile=(2, 4),
        patch=(16, 32), ntb=8, interpret=True)).astype(np.float32)
    out = deform_conv2d_raw(*to_torch_args(arrs), MRM).numpy()
    err = np.mean(np.abs(out - ref)) / np.mean(np.abs(ref))
    assert err < 0.02, err


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    """The hand-written kernel against its plain twin on the card, relative
    to the largest output: f32 to float-reassociation error (1e-5), bf16 to
    the rounding of the sampled values and of the output (1e-2)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    arrs = make_raw_inputs(11, 1, 40, 72, 128, 64)
    x, ry, rx, ml, fy, fx, wgt, bias = (
        t.to(cuda_device) for t in to_torch_args(arrs))
    x, ry, rx, ml = (t.to(dtype) for t in (x, ry, rx, ml))
    before = deform_conv2d_raw.launches
    out = deform_conv2d_raw(x, ry, rx, ml, fy, fx, wgt, bias, MRM)
    torch.cuda.synchronize()
    assert deform_conv2d_raw.launches == before + 1
    ref = deform_conv2d_raw_plain(x.float(), ry.float(), rx.float(),
                                  ml.float(), fy, fx, wgt, bias, MRM)
    err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    assert err < (1e-5 if dtype == torch.float32 else 1e-2), err


# (B, H, W, Cin, Cout, G, raw as views of one tensor, flow px, M): pixel
# counts and widths that no 128-pixel tile divides, B = 2, Cin/G = 8, 16,
# 24 (groups straddle a 32-channel chunk) and 32, flows past every border
EDGE_CASES = [(1, 40, 72, 128, 64, 16, True, 3.0, 10.0),
              (2, 100, 100, 64, 32, 8, True, 12.0, 5.0),
              (1, 33, 65, 256, 128, 16, False, 12.0, 10.0),
              (2, 33, 65, 128, 64, 16, False, 12.0, 5.0),
              (1, 40, 72, 384, 128, 16, True, 3.0, 5.0),
              (1, 100, 100, 512, 64, 16, False, 3.0, 10.0),
              (2, 40, 72, 256, 128, 16, True, 40.0, 10.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_cuda_kernel_matches_plain_on_ragged_tiles(cuda_device, case, dtype):
    """Both instances against the plain twin where the tiling is ragged:
    bf16 within 3e-2 abs and 1e-2 of the largest output, f32 within 1e-5
    of it. Raw blocks come as views of one (B, H, W, 3·G·9) tensor or as
    three contiguous tensors."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, w, cin, cout, g, views, amp, mrm = case
    arrs = make_raw_inputs(17, b, h, w, cin, cout, g=g, amp=amp)
    x, ry, rx, ml, fy, fx, wgt, bias = (
        t.to(cuda_device) for t in to_torch_args(arrs))
    # weights of std 1/sqrt(9·Cin), as chip_smoke.py's: outputs of unit
    # scale, the scale the 3e-2 absolute tolerance is stated for
    wgt = wgt * (10.0 / (9 * cin) ** 0.5)
    if views:
        raw = torch.cat([ry, rx, ml], dim=-1)
        ry, rx, ml = raw.split(g * 9, dim=-1)
        assert ry.stride(2) == 3 * g * 9
    x, ry, rx, ml = (t.to(dtype) for t in (x, ry, rx, ml))
    before = deform_conv2d_raw.launches
    out = deform_conv2d_raw(x, ry, rx, ml, fy, fx, wgt, bias, mrm)
    torch.cuda.synchronize()
    assert deform_conv2d_raw.launches == before + 1
    ref = deform_conv2d_raw_plain(x.float(), ry.float(), rx.float(),
                                  ml.float(), fy, fx, wgt, bias, mrm)
    err = (out.float() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    if dtype == torch.float32:
        assert rel < 1e-5, rel
    else:
        assert err < 3e-2 and rel < 1e-2, (err, rel)


@pytest.mark.parametrize("fault", ["nchw_raw_view", "cout", "flow_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(fault):
    """The wrapper checks its inputs on every device, so a CPU run fails
    where the card would: raw blocks that are not pixel-strided NHWC views,
    a Cout the kernel has no instance for, flows that are not float32."""
    x, ry, rx, ml, fy, fx, wgt, bias = to_torch_args(
        make_raw_inputs(5, 1, 6, 8, 64, 32))
    if fault == "nchw_raw_view":
        # NCHW-contiguous conv outputs seen through an NHWC permute
        ry, rx, ml = (t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                      for t in (ry, rx, ml))
    elif fault == "cout":
        wgt, bias = torch.cat([wgt, wgt[:8]]), torch.cat([bias, bias[:8]])
    else:
        fy = fy.double()
    with pytest.raises((ValueError, TypeError)):
        deform_conv2d_raw(x, ry, rx, ml, fy, fx, wgt, bias, MRM)


ARG_NAMES = ("x", "res_y", "res_x", "mask_logits", "flow_y", "flow_x",
             "weight", "bias")


def port_vjp(arrs, cot, mrm, raw_views=False):
    """Gradients of every tensor argument of ``deform_conv2d_raw`` (the
    autograd Function) for cotangent ``cot``, weight grad as HWIO. With
    ``raw_views`` the raw blocks are views of one NHWC tensor, as VSR++
    passes them, and their gradients arrive through it."""
    args = [t.clone().requires_grad_(True) for t in to_torch_args(arrs)]
    call = list(args)
    if raw_views:
        g9 = arrs[1].shape[-1]
        raw = torch.cat(args[1:4], dim=-1).detach().requires_grad_(True)
        call[1:4] = raw.split(g9, dim=-1)
    out = deform_conv2d_raw(*call, mrm)
    wrt = args[:1] + ([raw] if raw_views else args[1:4]) + args[4:]
    grads = [g.numpy() for g in torch.autograd.grad(
        out, wrt, torch.from_numpy(cot))]
    if raw_views:
        grads[1:2] = np.split(grads[1], 3, axis=-1)
    grads[6] = np.transpose(grads[6], (2, 3, 1, 0))
    return grads


def assert_grads_close(port, ref, tol):
    for name, gp, gr in zip(ARG_NAMES, port, ref):
        gr = np.asarray(gr)
        assert gp.shape == gr.shape, name
        err = np.abs(gp - gr).max() / np.abs(gr).max()
        assert err < tol, (name, err)


@pytest.mark.parametrize("b,h,w,cin,raw_views", [
    (1, 12, 16, 128, False), (2, 10, 12, 128, True), (1, 16, 16, 256, False),
    (1, 10, 12, 64, True)])
def test_backward_matches_jax_tile_raw_ad_bwd(b, h, w, cin, raw_views):
    """The Function's backward against JAX's own custom-VJP backward of the
    Pallas raw DCN (``_tile_raw_ad_bwd``: the VJP of the patch-gather DCN,
    plain XLA), called with the residuals and a cotangent, for all eight
    inputs. M = 5 keeps every residue inside the 16-pixel patch (exact
    while |residue| ≤ 6), flows of 3 px carry border samples outside the
    image. f32; each gradient within 1e-5 of its largest entry."""
    import jax.numpy as jnp
    from flair_tpu.ops.dcn_pallas import _tile_raw_ad_bwd

    arrs = make_raw_inputs(b * h + cin, b, h, w, cin, cin // 2)
    cot = np.random.default_rng(cin).standard_normal(
        (b, h, w, cin // 2)).astype(np.float32)
    ref = _tile_raw_ad_bwd(MRM, None, (16, 16), None, False, False,
                           tuple(jnp.asarray(a) for a in arrs),
                           jnp.asarray(cot))
    assert_grads_close(port_vjp(arrs, cot, MRM, raw_views), ref, 1e-5)


@pytest.mark.parametrize("mrm,amp", [(10.0, 12.0), (10.0, 40.0)])
def test_backward_matches_jax_exact_vjp_beyond_the_patch(mrm, amp):
    """Residues of up to 10 px (past the 16-pixel patch's budget) and flows
    of 12-40 px: the Function's backward against ``jax.vjp`` of the exact
    ``modulated_deform_conv2d`` on ``_materialize_raw``'s offsets. f32;
    each gradient within 1e-5 of its largest entry."""
    import jax
    import jax.numpy as jnp
    from flair_tpu.ops.dcn_pallas import _materialize_raw
    from flair_tpu.ops.deform import modulated_deform_conv2d

    arrs = make_raw_inputs(int(amp), 1, 12, 16, 128, 64, amp=amp,
                           res_scale=3.0)

    def f(x, ry, rx, ml, fy, fx, wgt, bias):
        off, m = _materialize_raw(ry, rx, ml, fy, fx, mrm)
        return modulated_deform_conv2d(x, off, m, wgt, bias, padding=1)

    cot = np.random.default_rng(3).standard_normal((1, 12, 16, 64)).astype(
        np.float32)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrs))
    assert_grads_close(port_vjp(arrs, cot, mrm), vjp(jnp.asarray(cot)), 1e-5)


def test_backward_runs_in_float32_and_returns_input_dtypes():
    """bf16 inputs: every gradient comes back in its input's dtype (bf16
    values, float32 flows, weight and bias), equal to the float32 VJP on
    the same values rounded once."""
    x, ry, rx, ml, fy, fx, wgt, bias = to_torch_args(
        make_raw_inputs(9, 1, 6, 8, 128, 64))
    bf = [t.to(torch.bfloat16) for t in (x, ry, rx, ml)]
    args = [t.requires_grad_(True) for t in bf + [fy, fx, wgt, bias]]
    out = deform_conv2d_raw(*args, MRM)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(out, args, cot.to(out.dtype))
    ref_args = [t.detach().float().requires_grad_(True) for t in args]
    ref = torch.autograd.grad(deform_conv2d_raw_plain(*ref_args, MRM),
                              ref_args, cot.to(out.dtype).float())
    for a, g, r in zip(args, grads, ref):
        assert g.dtype == a.dtype
        torch.testing.assert_close(g, r.to(a.dtype), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain_autograd(cuda_device, dtype):
    """On the card: the Function (kernel forward, plain float32 backward)
    against the plain version's own autograd on float32 copies of the same
    inputs, all eight gradients, raw blocks as views; f32 within 1e-5 and
    bf16 within 1e-2 (one rounding to bf16) of each largest entry. One
    launch: the backward does not launch the kernel."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, ry, rx, ml, fy, fx, wgt, bias = (
        t.to(cuda_device) for t in to_torch_args(
            make_raw_inputs(21, 1, 40, 72, 128, 64)))
    raw = torch.cat([ry, rx, ml], dim=-1).to(dtype).requires_grad_(True)
    leaves = [x.to(dtype).requires_grad_(True), raw] + [
        t.requires_grad_(True) for t in (fy, fx, wgt, bias)]
    g9 = ry.shape[-1]
    before = deform_conv2d_raw.launches
    out = deform_conv2d_raw(leaves[0], *raw.split(g9, dim=-1), *leaves[2:],
                            MRM)
    cot = torch.randn(out.shape, device=cuda_device, dtype=out.dtype)
    grads = torch.autograd.grad(out, leaves, cot)
    torch.cuda.synchronize()
    assert deform_conv2d_raw.launches == before + 1
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    ref_out = deform_conv2d_raw_plain(
        ref_leaves[0], *ref_leaves[1].split(g9, dim=-1), *ref_leaves[2:], MRM)
    ref = torch.autograd.grad(ref_out, ref_leaves, cot.float())
    for g, r in zip(grads, ref):
        err = (g.float() - r).abs().max().item() / r.abs().max().item()
        assert err < (1e-5 if dtype == torch.float32 else 1e-2), err
