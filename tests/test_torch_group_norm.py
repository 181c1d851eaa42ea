"""The GroupNorm kernel (``csrc/group_norm.cu`` through
``ops.norms.group_norm_act``) against a float64 twin on the card.

Every case here needs a CUDA device and nvcc, and skips elsewhere; the
plain version's CPU tests (bit-identity with the models' old op sequence,
the JAX comparison, the dispatch) are in ``test_torch_ops.py``. This file
imports no JAX, so the GPU machine runs it with ``python -m pytest
--noconftest -m cuda tests/test_torch_group_norm.py``.
"""

import pytest
import torch

from flair_tpu_torch.ops import norms

B, T = 1, 10     # the cells' window: one clip of ten frames
# (H = W, C, G): the main path's widths at 512², and at 32² the x8
# middle's 1 024 and the first decoder block's 2 048 (the cat of h and its
# skip: one pixel row a block)
SHAPES = [(512, 64, 16), (512, 64, 32), (512, 128, 16), (512, 128, 32),
          (512, 192, 16), (512, 192, 32), (32, 1024, 16), (32, 1024, 32),
          (32, 2048, 16)]
# largest error allowed against the float64 twin, |out - ref| <= atol +
# rtol·|ref|: one bf16 rounding of the output (2^-9 relative, one ulp
# allowed), or float32 arithmetic on coefficients rounded from float64
TOL = {torch.bfloat16: (1e-4, 2 ** -8), torch.float32: (5e-5, 1e-5)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def inputs(hw, c, g, dtype, variant, device, seed=0, offset=0.0):
    """Seeded x (B, T, hw, hw, c) in ``dtype`` and the variant's keywords.
    ``offset``: group 0's channels get ``offset`` times their std added."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale
    x = randn(B, T, hw, hw, c) * (1 + randn(c).abs()) + randn(c)
    if offset:
        x[..., :c // g] += offset
    kw = {"weight": 1 + randn(c, scale=0.1), "bias": randn(c, scale=0.1)}
    if variant != "plain":
        kw["act"] = "silu"
    if variant == "pre_add":
        kw["pre_add"] = randn(B * T, c).to(dtype)
    if variant == "scale_shift":
        kw["scale"], kw["shift"] = randn(B * T, 2 * c,
                                         scale=0.3).to(dtype).chunk(2, dim=1)
    if variant == "f32_out":
        kw["out_dtype"] = torch.float32
    return x.to(dtype), kw


def twin64(x, g, weight, bias, pre_add=None, scale=None, shift=None,
           act=None, out_dtype=None, eps=1e-5):
    """The same function in float64, with no intermediate rounding."""
    per = lambda a: a.double().reshape(B, T, 1, 1, -1)  # noqa: E731
    xd = x.double()
    if pre_add is not None:
        xd = xd + per(pre_add)
    xg = xd.reshape(B, -1, g, xd.shape[-1] // g)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(xd.shape)
    y = y * weight.double() + bias.double()
    if scale is not None:
        y = y * (1 + per(scale)) + per(shift)
    return torch.nn.functional.silu(y) if act == "silu" else y


def check(x, g, kw):
    """Run the kernel, count its launches, and hold it to the twin."""
    before = norms.group_norm_act.launches
    with torch.no_grad():
        out = norms.group_norm_act(x, g, **kw)
    torch.cuda.synchronize()
    assert norms.group_norm_act.launches == before + 3
    assert out.dtype == kw.get("out_dtype", x.dtype)
    assert out.shape == x.shape and out.is_contiguous()
    ref = twin64(x, g, **kw)
    atol, rtol = TOL[out.dtype]
    err = (out.double() - ref).abs() - rtol * ref.abs()
    assert err.max().item() <= atol, (err.max().item(), atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw,c,g", SHAPES)
def test_cuda_kernel_matches_twin(cuda_device, hw, c, g, dtype):
    x, kw = inputs(hw, c, g, dtype, "silu", cuda_device)
    check(x, g, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw,c,g", [(512, 64, 16), (32, 1024, 32)])
@pytest.mark.parametrize("variant", ["plain", "pre_add", "scale_shift",
                                     "f32_out"])
def test_cuda_kernel_variants(cuda_device, variant, hw, c, g, dtype):
    x, kw = inputs(hw, c, g, dtype, variant, cuda_device, seed=1)
    check(x, g, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw,c,g", [(512, 192, 32), (32, 1024, 16),
                                    (32, 2048, 16)])
def test_cuda_kernel_large_mean(cuda_device, hw, c, g, dtype):
    """A group whose |mean| is 100 times its std: the statistics are
    combined stably."""
    x, kw = inputs(hw, c, g, dtype, "scale_shift", cuda_device, seed=2,
                   offset=100.0)
    check(x, g, kw)


@pytest.mark.cuda
def test_cuda_plain_paths_launch_nothing(cuda_device, monkeypatch):
    """A frame group, the one plain route on the card (its statistics need
    an all-reduce between the passes), takes the plain version with no
    launch."""
    monkeypatch.setattr(norms, "all_reduce_mean", lambda m, group: m)
    x, kw = inputs(64, 64, 4, torch.bfloat16, "scale_shift", cuda_device)
    group = object()
    with torch.no_grad():
        expect = norms.group_norm_act_plain(x, 4, group=group, **kw)
        before = norms.group_norm_act.launches
        out = norms.group_norm_act(x, 4, group=group, **kw)
    assert norms.group_norm_act.launches == before
    assert torch.equal(out, expect)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["silu", "pre_add", "scale_shift"])
def test_cuda_grad_takes_kernel(cuda_device, variant):
    """Under autograd the kernel runs the forward (the same output as
    without a graph, three launches) and the backward is the plain
    version's float32 VJP: the gradients of x, weight, bias and the
    per-frame tensors match plain autograd on float32 copies."""
    x, kw = inputs(64, 64, 16, torch.bfloat16, variant, cuda_device)
    with torch.no_grad():
        want = norms.group_norm_act(x, 16, **kw)
    leaves = {"x": x.clone().requires_grad_()}
    for k in ("weight", "bias", "pre_add", "scale", "shift"):
        if k in kw:
            kw[k] = leaves[k] = kw[k].clone().requires_grad_()
    before = norms.group_norm_act.launches
    out = norms.group_norm_act(leaves["x"], 16, **kw)
    assert norms.group_norm_act.launches == before + 3
    assert torch.equal(out.detach(), want)
    cot = torch.randn(out.shape, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(5))
    grads = torch.autograd.grad(out, list(leaves.values()), cot.to(out.dtype))
    flt = {k: v.detach().float().requires_grad_() for k, v in leaves.items()}
    plain = norms.group_norm_act_plain(
        flt["x"], 16, **{k: flt.get(k, v) for k, v in kw.items()})
    ref = torch.autograd.grad(plain, list(flt.values()),
                              cot.to(out.dtype).float())
    for name, g, r in zip(leaves, grads, ref):
        assert g.dtype == leaves[name].dtype
        torch.testing.assert_close(g, r.to(g.dtype), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["odd_width", "wide", "f32_to_bf16"])
def test_cuda_unsupported_calls_raise(cuda_device, case):
    """C % 8 != 0, C > 2048 and a float32 x with a bf16 result raise on the
    card, with no launch and no plain fallback."""
    c = {"odd_width": 36, "wide": 4096}.get(case, 64)
    dtype = torch.float32 if case == "f32_to_bf16" else torch.bfloat16
    x, kw = inputs(16, c, 4, dtype, "silu", cuda_device)
    if case == "f32_to_bf16":
        kw["out_dtype"] = torch.bfloat16
    before = norms.group_norm_act.launches
    with pytest.raises(TypeError if case == "f32_to_bf16" else ValueError):
        with torch.no_grad():
            norms.group_norm_act(x, 4, **kw)
    assert norms.group_norm_act.launches == before
