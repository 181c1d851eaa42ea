"""BasicVSR++'s step kernels (``csrc/vsrpp_step.cu`` through
``ops.vsrpp_step``) against their plain versions on the card.

Every case here needs a CUDA device and nvcc, and skips elsewhere; the
plain versions' CPU tests (bit-identity with the step's old op sequence,
no launch, the buffers) are in ``test_torch_ops.py``. This file imports no
JAX, so the GPU machine runs it with ``python -m pytest --noconftest -m
cuda tests/test_torch_vsrpp_step.py``.
"""

import pytest
import torch

from flair_tpu_torch.models.vsrpp import BasicVSRPP
from flair_tpu_torch.ops import vsrpp_step as vs

# (H = W, C): the cells' VSR++ levels (SR3 and ADM alike: 64 channels at
# 512², 128 at 256²) and DAVSRNet's float32 width
SHAPES = [(512, 64), (256, 128), (256, 64)]
DTYPES = [torch.bfloat16, torch.float32]
# |kernel - float64 of the same inputs| <= RTOL·|ref| + ATOL: one rounding
# of the output (bf16: 2^-9, one ulp allowed), or float32 arithmetic
TOL = {torch.bfloat16: (2 ** -8, 1e-6), torch.float32: (1e-6, 1e-6)}
OPS = ("warp_pair", "bias_act", "gate_tail")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def launches():
    return {op: getattr(vs, op).launches for op in OPS}


def nhwc_randn(gen, b, c, hw, dtype, dev):
    return torch.randn((b, c, hw, hw), generator=gen, device=dev).to(
        dtype).contiguous(memory_format=torch.channels_last)


def flows(gen, b, hw, dev, amp=6.0):
    """(B, 2, H, W) float32 smooth flows of up to ±amp px (past every
    border)."""
    yy = torch.arange(hw, device=dev).view(1, hw, 1) / hw
    xx = torch.arange(hw, device=dev).view(1, 1, hw) / hw
    ph = torch.rand((b, 2, 1, 1), generator=gen, device=dev) * 6.28
    return amp * torch.stack([torch.sin(6.28 * (yy + 2 * xx) + ph[:, 0]),
                              torch.cos(6.28 * (2 * yy - xx) + ph[:, 1])], 1)


def assert_one_rounding(out, ref, dtype):
    rtol, atol = TOL[dtype]
    err = (out.double() - ref).abs() - rtol * ref.abs()
    assert err.max().item() <= atol, (err.max().item(), atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,c", SHAPES)
def test_cuda_warp_pair_matches_twin(cuda_device, hw, c, dtype):
    """The warp computes flow_warp's float32 coordinates and weights: within
    one rounding of the plain version (grid_sample on float32 copies)."""
    gen = torch.Generator(cuda_device).manual_seed(hw + c)
    pair = nhwc_randn(gen, 2, 2 * c, hw, dtype, cuda_device)
    f1, f2 = flows(gen, 2, hw, cuda_device), flows(gen, 2, hw, cuda_device)
    before = launches()
    with torch.no_grad():
        out = vs.warp_pair(pair, f1, f2)
    torch.cuda.synchronize()
    assert launches() == {**before, "warp_pair": before["warp_pair"] + 1}
    assert out.dtype == dtype and out.is_contiguous(
        memory_format=torch.channels_last)
    ref = vs.warp_pair_plain(pair.float(), f1, f2)
    assert_one_rounding(out, ref.double(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,c", SHAPES[:2] + [(256, 432), (64, 54)])
@pytest.mark.parametrize("variant", [("addend", "leaky"), ("bias", "leaky"),
                                     ("bias", None), ("bias", "relu"),
                                     ("both", None)])
def test_cuda_bias_act_matches_twin(cuda_device, variant, hw, c, dtype):
    """act(x + bias + addend) in float32 with one rounding on store, at the
    sites' widths (432: the offset head's 27·G channels; 54: the same at G
    = 2, DAVSRNet's test width, which runs the scalar instance)."""
    gen = torch.Generator(cuda_device).manual_seed(7 * c + hw)
    x = nhwc_randn(gen, 1, c, hw, dtype, cuda_device)
    kind, act = variant
    bias = (torch.randn(c, generator=gen, device=cuda_device)
            if kind != "addend" else None)
    add = (nhwc_randn(gen, 1, c, hw, dtype, cuda_device)
           if kind != "bias" else None)
    before = vs.bias_act.launches
    with torch.no_grad():
        out = vs.bias_act(x, bias, add, act)
    torch.cuda.synchronize()
    assert vs.bias_act.launches == before + 1
    ref = x.double()
    if bias is not None:
        ref = ref + bias.double()[None, :, None, None]
    if add is not None:
        ref = ref + add.double()
    ref = {"leaky": lambda v: torch.where(v > 0, v, 0.1 * v),
           "relu": torch.relu, None: lambda v: v}[act](ref)
    assert_one_rounding(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,c", SHAPES)
@pytest.mark.parametrize("gate", ["frame", "pixel"])
@pytest.mark.parametrize("first", [False, True])
def test_cuda_gate_tail_matches_twin(cuda_device, first, gate, hw, c, dtype):
    """(prop + (r + (y + bias))) * gate, stored into the frame slot and as
    the next pair [v | n1]; prop None at a branch's first frame. B = 2
    frames of a clip of 3: the slot is a strided view."""
    gen = torch.Generator(cuda_device).manual_seed(3 * c + hw)
    b = 2
    r, y, prop = (nhwc_randn(gen, b, c, hw, dtype, cuda_device)
                  for _ in range(3))
    prop = None if first else prop
    pair = nhwc_randn(gen, b, 2 * c, hw, dtype, cuda_device)
    bias = torch.randn(c, generator=gen, device=cuda_device)
    gshape = (b, 1, 1, 1) if gate == "frame" else (b, hw, hw, 1)
    g = torch.rand(gshape, generator=gen, device=cuda_device).to(dtype)
    out = torch.zeros((b * 3, c, hw, hw), dtype=dtype, device=cuda_device
                      ).contiguous(memory_format=torch.channels_last)
    slot = out.reshape(b, 3, c, hw, hw)[:, 1]
    before = vs.gate_tail.launches
    with torch.no_grad():
        npair = vs.gate_tail(prop, r, y, bias, g, slot, pair)
    torch.cuda.synchronize()
    assert vs.gate_tail.launches == before + 1
    s = r.double() + (y.double() + bias.double()[None, :, None, None])
    if prop is not None:
        s = prop.double() + s
    ref = s * g.double().permute(0, 3, 1, 2)
    assert_one_rounding(npair[:, :c], ref, dtype)
    assert torch.equal(slot, npair[:, :c])
    assert torch.equal(npair[:, c:], pair[:, :c])
    assert out.reshape(b, 3, c, hw, hw)[:, 0::2].abs().sum().item() == 0


def model_and_inputs(dev, dtype, c=64, hw=64, b=1, t=5, seed=0):
    """A BasicVSRPP (G = 16, M = 10) with seeded weights (offset heads a
    tenth, as the benchmark draws them), its hidden state, flows and a
    per-pixel gating map at twice the resolution (the resize path)."""
    gen = torch.Generator().manual_seed(seed)
    m = BasicVSRPP(c, deform_groups=16, dtype=dtype)
    with torch.no_grad():
        for name, p in m.named_parameters():
            scale = 0.1 if "offset_out" in name else 1.0
            fan = max(1, p[0].numel()) if p.dim() > 1 else 50
            p.copy_(torch.randn(p.shape, generator=gen) * scale / fan ** 0.5)
    m = m.to(dev)
    hid = torch.randn((b * t, c, hw, hw), generator=gen).to(dev, dtype)
    hid = hid.contiguous(memory_format=torch.channels_last)
    fl = [(torch.randn((b, t - 1, 2, 1, 1), generator=gen) * 2
           + torch.randn((b, t - 1, 2, hw, hw), generator=gen) * 0.5).to(dev)
          for _ in range(2)]
    weight = torch.rand((b, t, 2 * hw, 2 * hw, 1), generator=gen).to(dev)
    return m, (hid, b, fl[0], fl[1], weight)


def rel_l2(a, ref):
    return ((a.double() - ref.double()).norm() / ref.double().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_basicvsrpp_kernels_match_twins(cuda_device, dtype,
                                             monkeypatch):
    """A whole BasicVSRPP with grad off (the kernels, their launches
    counted) against the same module through the plain twins on the card,
    both against the float32 module with TF32 off: the kernels stay as close
    to float32 as the twins (they fold two or three roundings a stage into
    one)."""
    m, args = model_and_inputs(cuda_device, dtype)
    t = args[0].shape[0]
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for op in OPS:
            setattr(getattr(vs, op), "launches", 0)
        with torch.no_grad():
            k = m(*args)
            assert launches() == {"warp_pair": 2 * (t - 1),
                                  "bias_act": 2 * (6 * t - 2),
                                  "gate_tail": 2 * t}
            m32 = BasicVSRPP(64, deform_groups=16).to(cuda_device)
            m32.load_state_dict(m.state_dict())
            hid, b, ff, fb, w = args
            ref = m32(hid.float(), b, ff, fb, w)
            monkeypatch.setattr(vs, "_on_card", lambda v: False)
            before = launches()
            twin = m(*args)
        assert launches() == before
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    err_k, err_t = rel_l2(k, ref), rel_l2(twin, ref)
    if dtype == torch.float32:
        assert rel_l2(k, twin) <= 1e-5, (rel_l2(k, twin), err_k, err_t)
    else:
        assert err_k <= 1.25 * err_t + 1e-4, (err_k, err_t, rel_l2(k, twin))


@pytest.mark.cuda
def test_cuda_forward_never_syncs(cuda_device):
    """A no-grad forward, gating map resized included, copies nothing from
    the host and never synchronizes (after one warm-up call that loads the
    libraries)."""
    m, args = model_and_inputs(cuda_device, torch.bfloat16)
    with torch.no_grad():
        m(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            m(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def op_call(op, a, gate):
    """(output tensors, leaves) of one step op on ``a``'s tensors as
    leaves that require grad; the tail's output slot is a frame of a clip
    of 3, returned beside the next pair."""
    leaves = {k: a[k].clone().requires_grad_() for k in
              {"warp_pair": ("pair", "f1", "f2"),
               "bias_act": ("x", "bias", "add"),
               "gate_tail": ("prop", "r", "y", "bias", gate, "pair")}[op]}
    v = {**a, **leaves}
    if op == "warp_pair":
        return [vs.warp_pair(v["pair"], v["f1"], v["f2"])], leaves
    if op == "bias_act":
        return [vs.bias_act(v["x"], v["bias"], v["add"], "leaky")], leaves
    b, c, h, w = v["r"].shape
    out = torch.zeros((b * 3, c, h, w), dtype=v["r"].dtype,
                      device=v["r"].device).contiguous(
        memory_format=torch.channels_last)
    npair = vs.gate_tail(v["prop"], v["r"], v["y"], v["bias"], v[gate],
                         out.view(b, 3, c, h, w)[:, 1], v["pair"])
    return [npair, out], leaves


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,gate", [("warp_pair", None), ("bias_act", None),
                                     ("gate_tail", "gate_f"),
                                     ("gate_tail", "gate_p")])
def test_cuda_step_ops_under_autograd(cuda_device, op, gate, dtype):
    """Under autograd each op runs its kernel (one launch, the no-grad
    output bit for bit) and its backward is the plain version's float32
    VJP: the gradients of every input, through the tail's output slot too,
    match plain autograd on float32 copies."""
    gen = torch.Generator(cuda_device).manual_seed(11)
    a = vsrpp_tensors(gen, 2, 64, 32, dtype, cuda_device)
    with torch.no_grad():
        want, _ = op_call(op, a, gate)
    before = getattr(vs, op).launches
    outs, leaves = op_call(op, a, gate)
    assert getattr(vs, op).launches == before + 1
    for o, w in zip(outs, want):
        assert o.requires_grad and torch.equal(o.detach(), w)
    cots = [torch.randn(o.shape, generator=gen, device=cuda_device).to(
        o.dtype) for o in outs]
    grads = torch.autograd.grad(outs, list(leaves.values()), cots)
    flt = {k: v.detach().float().requires_grad_() for k, v in
           leaves.items()}
    ref_outs, _ = op_call_plain(op, {**a, **flt}, gate)
    ref = torch.autograd.grad(ref_outs, list(flt.values()),
                              [c.float() for c in cots])
    for name, g, r in zip(leaves, grads, ref):
        assert g.dtype == leaves[name].dtype
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, msg=name)
        else:   # a bf16 rounding of the gradients, and of the tail's sum of
            # the pair's and the slot's gradients, inside sums over
            # channels or pixels (the float32 bias's too)
            tol = 2 ** -7
            torch.testing.assert_close(g, r.to(g.dtype), rtol=tol,
                                       atol=tol * r.abs().max().item(),
                                       msg=name)


def vsrpp_tensors(gen, b, hw, c, dtype, dev):
    """One step's tensors (NHWC storage, ``dtype``): the pair, two flows,
    conv outputs, an addend, a float32 bias, gates per frame and per
    pixel."""
    return {"pair": nhwc_randn(gen, b, 2 * c, hw, dtype, dev),
            "f1": flows(gen, b, hw, dev), "f2": flows(gen, b, hw, dev),
            **{k: nhwc_randn(gen, b, c, hw, dtype, dev)
               for k in ("x", "add", "prop", "r", "y")},
            "bias": torch.randn(c, generator=gen, device=dev),
            "gate_f": torch.rand((b, 1, 1, 1), generator=gen,
                                 device=dev).to(dtype),
            "gate_p": torch.rand((b, hw, hw, 1), generator=gen,
                                 device=dev).to(dtype)}


def op_call_plain(op, v, gate):
    """``op_call``'s op through its plain version on the tensors of ``v``
    as they are."""
    if op == "warp_pair":
        return [vs.warp_pair_plain(v["pair"], v["f1"], v["f2"])], None
    if op == "bias_act":
        return [vs.bias_act_plain(v["x"], v["bias"], v["add"], "leaky")], None
    b, c, h, w = v["r"].shape
    out = torch.zeros((b * 3, c, h, w), dtype=v["r"].dtype,
                      device=v["r"].device)
    npair = vs.gate_tail_plain(v["prop"], v["r"], v["y"], v["bias"], v[gate],
                               out.view(b, 3, c, h, w)[:, 1], v["pair"])
    return [npair, out], None


@pytest.mark.cuda
def test_cuda_training_takes_kernels(cuda_device, monkeypatch):
    """Under autograd (training) a whole BasicVSRPP launches the step
    kernels as a no-grad forward does, and its gradients (every parameter
    and the hidden state), float32 with TF32 off, match the plain twins'
    on the card within 1e-3 relative (a wrong route or a lost gradient reads
    near 1; float32 differences of the forward move a sample across a pixel
    or a value across a kink only here and there)."""
    m, args = model_and_inputs(cuda_device, torch.float32, t=3)
    t = args[0].shape[0]
    hid = args[0]
    params = list(m.parameters())
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False

    def grads():
        x = hid.clone().requires_grad_()
        out = m(x, *args[1:])
        cot = torch.randn(out.shape, device=cuda_device,
                          generator=torch.Generator(cuda_device).manual_seed(3))
        return torch.autograd.grad(out, [x, *params], cot)

    try:
        for op in OPS:
            setattr(getattr(vs, op), "launches", 0)
        k = grads()
        assert launches() == {"warp_pair": 2 * (t - 1),
                              "bias_act": 2 * (6 * t - 2),
                              "gate_tail": 2 * t}
        monkeypatch.setattr(vs, "_on_card", lambda v: False)
        twin = grads()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    names = ["hidden", *(n for n, _ in m.named_parameters())]
    errs = {n: rel_l2(a, b) for n, a, b in zip(names, k, twin)
            if b.abs().max() > 0}
    assert len(errs) > len(names) // 2
    assert max(errs.values()) <= 1e-3, errs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["odd_width", "nchw", "half", "mixed",
                                  "gate_shape"])
def test_cuda_unsupported_calls_raise(cuda_device, case):
    """A pair of halves that are not 8-channel vectors, channels-first
    storage, float16, mixed dtypes and a gate of another size raise on the
    card, with no launch and no plain fallback."""
    gen = torch.Generator(cuda_device).manual_seed(1)
    c = 12 if case == "odd_width" else 16
    dtype = torch.float16 if case == "half" else torch.bfloat16
    x = nhwc_randn(gen, 1, c, 16, dtype, cuda_device)
    bias = torch.randn(c, device=cuda_device)
    before = launches()
    with torch.no_grad(), pytest.raises((TypeError, ValueError)):
        if case == "odd_width":
            pair = nhwc_randn(gen, 1, 2 * c, 16, dtype, cuda_device)
            f = flows(gen, 1, 16, cuda_device)
            vs.warp_pair(pair, f, f)
        elif case == "nchw":
            pair = torch.randn((1, 2 * c, 16, 16), device=cuda_device).to(
                dtype)
            f = flows(gen, 1, 16, cuda_device)
            vs.warp_pair(pair, f, f)
        elif case == "mixed":
            vs.bias_act(x, bias, x.float(), "leaky")
        elif case == "gate_shape":
            g = torch.rand((1, 8, 8, 1), device=cuda_device).to(dtype)
            pair = nhwc_randn(gen, 1, 2 * c, 16, dtype, cuda_device)
            vs.gate_tail(x, x, x, bias, g, torch.empty_like(x), pair)
        else:
            vs.bias_act(x, bias, None, "relu")
    assert launches() == before
