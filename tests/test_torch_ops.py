"""Port ops (flair_tpu_torch/ops) against flair_tpu on seeded numpy inputs.

Embeddings, norms, separable resizes, warps and attention, each held to
≤1e-5 absolute error in float32; ``group_norm_act``'s plain version also
bit for bit against the models' old op sequence, its dispatch, and the
layout every norm site hands the kernel.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from flair_tpu.ops import attention as j_attn
from flair_tpu.ops import embed as j_embed
from flair_tpu.ops import norms as j_norms
from flair_tpu.ops import resize as j_resize
from flair_tpu.ops import warp as j_warp
from flair_tpu_torch.models.common import GroupNorm32
from flair_tpu_torch.models.registry import get_model
from flair_tpu_torch.ops import attention as t_attn
from flair_tpu_torch.ops import embed as t_embed
from flair_tpu_torch.ops import norms as t_norms
from flair_tpu_torch.ops import resize as t_resize
from flair_tpu_torch.ops import warp as t_warp

torch.set_num_threads(1)
ATOL = 1e-5


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("dim", [32, 33])
def test_embeddings(dim):
    lvl = np.random.default_rng(0).uniform(0, 1, 7).astype(np.float32)
    ts = np.array([0, 1, 5, 17, 999, 3.5], np.float32)
    close(t_embed.sr3_noise_embedding(torch.from_numpy(lvl), dim),
          j_embed.sr3_noise_embedding(jnp.asarray(lvl), dim))
    close(t_embed.timestep_embedding(torch.from_numpy(ts), dim),
          j_embed.timestep_embedding(jnp.asarray(ts), dim))


def test_group_norm_joint_over_frames():
    x = rand(1, 2, 3, 5, 6, 16, scale=3.0) + 1.0
    wgt, bias = rand(2, 16), rand(3, 16)
    close(t_norms.group_norm(torch.from_numpy(x), 4, torch.from_numpy(wgt),
                             torch.from_numpy(bias)),
          j_norms.group_norm(jnp.asarray(x), 4, jnp.asarray(wgt),
                             jnp.asarray(bias)))


@pytest.mark.parametrize("win,mode", [(3, "replicate"), (5, "replicate"),
                                      (3, "zeros")])
def test_shift_window_group_norm(win, mode):
    x = rand(4, 2, 6, 4, 5, 8, scale=2.0)
    wgt, bias = rand(5, 8), rand(6, 8)
    close(t_norms.shift_window_group_norm(
        torch.from_numpy(x), 2, win, torch.from_numpy(wgt),
        torch.from_numpy(bias), padding_mode=mode),
        j_norms.shift_window_group_norm(
            jnp.asarray(x), 2, win, jnp.asarray(wgt), jnp.asarray(bias),
            padding_mode=mode))


@pytest.mark.parametrize("name", ["resize_bicubic", "resize_bilinear",
                                  "resize_area", "resize_bilinear_aa"])
@pytest.mark.parametrize("out_hw", [(16, 24), (5, 7)])
def test_separable_resizes(name, out_hw):
    x = rand(7, 2, 3, 8, 12, 3)
    close(getattr(t_resize, name)(torch.from_numpy(x), out_hw),
          getattr(j_resize, name)(jnp.asarray(x), out_hw))


def test_resize_matrix_nearest():
    np.testing.assert_array_equal(t_resize.resize_matrix(13, 5, "nearest"),
                                  j_resize.resize_matrix(13, 5, "nearest"))


def test_grid_sample_zeros_align_corners():
    img = rand(8, 2, 9, 11, 4)
    grid = np.random.default_rng(9).uniform(-1.3, 1.3, (2, 6, 7, 2)).astype(
        np.float32)
    out = t_warp.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2),
                             torch.from_numpy(grid))
    close(out.permute(0, 2, 3, 1),
          j_warp.grid_sample(jnp.asarray(img), jnp.asarray(grid)))


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_flow_warp(padding_mode):
    img = rand(10, 2, 12, 10, 64)
    flow = rand(11, 2, 12, 10, 2, scale=3.0)   # carries samples off-image
    out = t_warp.flow_warp(torch.from_numpy(img).permute(0, 3, 1, 2),
                           torch.from_numpy(flow).permute(0, 3, 1, 2),
                           padding_mode=padding_mode)
    close(out.permute(0, 2, 3, 1),
          j_warp.flow_warp(jnp.asarray(img), jnp.asarray(flow),
                           padding_mode=padding_mode))


def test_dot_product_attention():
    q, k, v = (rand(s, 2, 10, 3, 8) for s in (12, 13, 14))
    close(t_attn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                       scale=0.3),
          j_attn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                       scale=0.3))


@pytest.mark.parametrize("t,f", [(5, 3), (4, 7)])
def test_temporal_window_attention(t, f):
    q, k, v = (rand(s, 2, t, 3, 4, 16) for s in (15, 16, 17))
    k_pos = rand(18, f - 1, 16)
    close(t_attn.temporal_window_attention(
        *map(torch.from_numpy, (q, k, v, k_pos)), f, 4),
        j_attn.temporal_window_attention(
            *map(jnp.asarray, (q, k, v, k_pos)), f, 4))


GN_VARIANTS = ("plain", "silu", "pre_add", "scale_shift", "f32_out")


def gn_case(variant, cpg, dtype, seed=20):
    """A GroupNorm32 of 4 groups of ``cpg`` channels with seeded weights,
    an (N = B·T, C, H, W) channels_last x (B = 2, T = 3) in ``dtype``, and
    the variant's keywords: pre_add / scale / shift are (N, C), scale and
    shift halves of one (N, 2C) tensor as ResBlock's ``emb_proj`` gives
    them."""
    b, t, c = 2, 3, 4 * cpg
    norm = GroupNorm32(c, 4)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(1 + rand(seed, c, scale=0.1)))
        norm.bias.copy_(torch.from_numpy(rand(seed + 1, c, scale=0.1)))
    x = torch.from_numpy(rand(seed + 2, b * t, 4, 5, c, scale=3.0) + 1.0)
    x = x.to(dtype).permute(0, 3, 1, 2)            # channels_last NCHW
    kw = {}
    if variant != "plain":
        kw["act"] = "silu"
    if variant == "pre_add":
        kw["pre_add"] = torch.from_numpy(rand(seed + 3, b * t, c)).to(dtype)
    if variant == "scale_shift":
        emb = torch.from_numpy(rand(seed + 4, b * t, 2 * c, scale=0.3))
        kw["scale"], kw["shift"] = emb.to(dtype).chunk(2, dim=1)
    if variant == "f32_out":
        kw["out_dtype"] = torch.float32
    return norm, x, b, kw


def gn_before(norm, x, b, kw):
    """The models' sequence before ``group_norm_act``: GroupNorm32 as the
    plain ``group_norm`` of the (B, T, H, W, C) view, with the pre-add, the
    scale-shift and the SiLU around it in NCHW."""
    def old_norm(h):
        n, c, hh, ww = h.shape
        v = h.permute(0, 2, 3, 1).reshape(b, n // b, hh, ww, c)
        y = t_norms.group_norm(v, norm.num_groups, norm.weight, norm.bias)
        return y.reshape(n, hh, ww, c).permute(0, 3, 1, 2)

    col = lambda a: a[:, :, None, None]            # noqa: E731
    if "pre_add" in kw:
        h = old_norm(x + col(kw["pre_add"]).to(x.dtype))
    elif "scale" in kw:
        h = old_norm(x) * (1 + col(kw["scale"])) + col(kw["shift"])
    elif "out_dtype" in kw:
        h = old_norm(x.float())
    else:
        h = old_norm(x)
    return torch.nn.functional.silu(h) if "act" in kw else h


@pytest.mark.parametrize("cpg", [2, 4, 8, 64])
@pytest.mark.parametrize("variant", GN_VARIANTS)
def test_group_norm_act(variant, cpg):
    """group_norm_act's plain version is the models' old op sequence bit for
    bit in bf16, matches the JAX group_norm followed by the same operations
    in float32, and launches nothing on the CPU."""
    t_norms.group_norm_act.launches = 0
    with torch.no_grad():
        norm, x, b, kw = gn_case(variant, cpg, torch.bfloat16)
        out = norm(x, b, **kw)
        assert out.dtype == kw.get("out_dtype", torch.bfloat16)
        assert torch.equal(out, gn_before(norm, x, b, kw))

        norm, x, b, kw = gn_case(variant, cpg, torch.float32)
        n, c, hh, ww = x.shape
        v = x.permute(0, 2, 3, 1).reshape(b, n // b, hh, ww, c)
        out = t_norms.group_norm_act(v, norm.num_groups, norm.weight,
                                     norm.bias, **kw)

    def per(a):
        return jnp.asarray(a.numpy()).reshape(b, n // b, 1, 1, c)
    xj = jnp.asarray(v.numpy())
    if "pre_add" in kw:
        xj = xj + per(kw["pre_add"])
    ref = j_norms.group_norm(xj, norm.num_groups,
                             jnp.asarray(norm.weight.detach().numpy()),
                             jnp.asarray(norm.bias.detach().numpy()))
    if "scale" in kw:
        ref = ref * (1 + per(kw["scale"])) + per(kw["shift"])
    if "act" in kw:
        ref = ref * (1 / (1 + jnp.exp(-ref)))
    close(out, ref)
    assert t_norms.group_norm_act.launches == 0


@pytest.mark.parametrize("case", ["grad", "frame_group", "odd_width",
                                  "wide", "f32_to_bf16"])
def test_group_norm_act_dispatch(case, monkeypatch):
    """With every tensor taken for a card's and the kernel's launch replaced
    by the plain version: a no-grad call reaches the launch; a call that
    records autograd reaches it too, through the autograd Function whose
    backward (the plain version's float32 VJP) gives plain autograd's
    gradients; a frame group takes the plain version with no launch; C % 8
    != 0, C > 2048 and a float32 x with a bf16 result raise before any."""
    launched = []

    def fake_launch(x, g, weight, bias, pre, scale, shift, act, out_dtype,
                    eps):
        launched.append(x)
        return t_norms.group_norm_act_plain(
            x, g, weight, bias, pre_add=pre, scale=scale, shift=shift,
            act=act, out_dtype=out_dtype, eps=eps)

    monkeypatch.setattr(t_norms, "_on_card", lambda x: True)
    monkeypatch.setattr(t_norms, "_launch", fake_launch)
    monkeypatch.setattr(t_norms, "all_reduce_mean", lambda m, group: m)
    cpg = {"odd_width": 3, "wide": 514}.get(case, 4)   # C = 12, 2056 or 16
    norm, x, b, kw = gn_case("scale_shift", cpg, torch.float32)
    v = x.permute(0, 2, 3, 1).reshape(b, -1, *x.shape[2:], x.shape[1])
    v = v.contiguous()
    args = (v, norm.num_groups, norm.weight, norm.bias)
    if case in ("odd_width", "wide", "f32_to_bf16"):
        if case == "f32_to_bf16":
            kw["out_dtype"] = torch.bfloat16
        with pytest.raises(TypeError if case == "f32_to_bf16"
                           else ValueError):
            t_norms.group_norm_act(*args, **kw)
        assert not launched
        return
    group = object() if case == "frame_group" else None
    with torch.no_grad():
        expect = t_norms.group_norm_act_plain(*args, group=group, **kw)
        t_norms.group_norm_act(*args, **kw)
        assert len(launched) == 1                  # the patch is reached
        launched.clear()
    if case == "grad":
        v.requires_grad_()
        kw["scale"], kw["shift"] = (kw[k].clone().requires_grad_()
                                    for k in ("scale", "shift"))
    with torch.set_grad_enabled(case == "grad"):
        out = t_norms.group_norm_act(*args, group=group, **kw)
    assert torch.equal(out.detach(), expect)
    if case == "frame_group":
        assert not launched
        return
    assert len(launched) == 1 and out.requires_grad
    wrt = [v, norm.weight, norm.bias, kw["scale"], kw["shift"]]
    grads = torch.autograd.grad(out.square().sum(), wrt)
    plain = t_norms.group_norm_act_plain(*args, **kw)
    for g, r in zip(grads, torch.autograd.grad(plain.square().sum(), wrt)):
        torch.testing.assert_close(g, r)


@pytest.mark.parametrize("name", ["bicubic_unet", "blur_unet"])
def test_norm_sites_take_channels_last(name):
    """Every GroupNorm32 of a small BicubicUNet / BlurUNet runs once a
    denoiser call, on input that is contiguous channels-last, the layout
    the kernel reads (its wrapper raises on any other)."""
    kw = (dict(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
               attn_res=(16,), vsrpp_res=(32,), image_size=32, num_frames=3,
               head_dim=8)
          if name == "bicubic_unet" else
          dict(image_size=32, in_channels=6, model_channels=32,
               out_channels=6, num_res_blocks=1, attention_resolutions=(2,),
               rnn_resolutions=(1,), channel_mult=(1, 2), num_heads=1,
               num_head_channels=8, use_scale_shift_norm=True,
               temporal_frames=3))
    torch.manual_seed(0)
    model = get_model(name, **kw).eval()
    calls = {}

    def hook(mod, args):
        x = args[0]
        assert x.permute(0, 2, 3, 1).is_contiguous()
        calls[mod] = calls.get(mod, 0) + 1

    norms = [m for m in model.modules() if isinstance(m, GroupNorm32)]
    for m in norms:
        m.register_forward_pre_hook(hook)
    rng = np.random.default_rng(0)
    x, low = (torch.from_numpy(rng.uniform(-1, 1, (1, 3, 32, 32, 3))
                               .astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        if name == "bicubic_unet":
            model(x, torch.full((1, 3), 0.5), low)
        else:
            model(x, torch.full((1, 3), 10), low)
    assert len(norms) > 10 and calls == {m: 1 for m in norms}


# ---- BasicVSR++'s step ops (ops/vsrpp_step.py) ----------------------------

def step_tensors(dtype, gate, seed=0, b=2, c=16, h=6, w=8):
    """Seeded channels-last tensors of one VSR++ step: the pair, two flows
    of up to ±4 px (samples past the borders), conv outputs, an addend, a
    bias, a gate per frame or per pixel, and a 3-frame output."""
    g = torch.Generator().manual_seed(seed)

    def act(ch, n=b):
        return torch.randn((n, ch, h, w), generator=g).to(dtype).contiguous(
            memory_format=torch.channels_last)
    gshape = (b, 1, 1, 1) if gate == "frame" else (b, h, w, 1)
    return {"pair": act(2 * c), "x": act(c), "add": act(c), "r": act(c),
            "y": act(c), "prop": act(c), "out": act(c, 3 * b),
            "bias": torch.randn(c, generator=g),
            "f1": torch.randn((b, 2, h, w), generator=g) * 4,
            "f2": torch.randn((b, 2, h, w), generator=g) * 4,
            "gate": torch.rand(gshape, generator=g).to(dtype)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gate", ["frame", "pixel"])
@pytest.mark.parametrize("addend", [False, True])
@pytest.mark.parametrize("act", ["leaky", "relu", None])
def test_vsrpp_step_twins_are_the_old_sequence(act, addend, gate, dtype):
    """Each step op's plain version is the op sequence BasicVSR++'s step ran
    before, bit for bit, and launches nothing on the CPU: the warp of both
    hidden states (one flow_warp on their cat, then a cat of the halves),
    a bias or an addend and the activation after a conv, and the gated
    residual stored into the frame slot with the next pair."""
    from flair_tpu_torch.models.common import channels_last, leaky_relu
    from flair_tpu_torch.ops import vsrpp_step as vs
    for op in ("warp_pair", "bias_act", "gate_tail"):
        setattr(getattr(vs, op), "launches", 0)
    t = step_tensors(dtype, gate)
    c = t["x"].shape[1]
    n1 = channels_last(t["pair"][:, :c])
    n2 = channels_last(t["pair"][:, c:])
    f1, f2 = t["f1"], t["f2"]
    with torch.no_grad():
        both = channels_last(t_warp.flow_warp(
            torch.cat([n1, n2], dim=0),
            (torch.cat([f1[:, 0], f2[:, 0]], dim=0),
             torch.cat([f1[:, 1], f2[:, 1]], dim=0))))
        assert torch.equal(vs.warp_pair(t["pair"], f1, f2),
                           torch.cat(both.chunk(2, dim=0), dim=1))

        fn = {"leaky": lambda v: leaky_relu(v, 0.1), "relu": F.relu,
              None: lambda v: v}[act]
        if addend:
            old = fn(t["x"] + t["add"])
            new = vs.bias_act(t["x"], addend=t["add"], act=act)
        else:
            old = fn(t["x"] + t["bias"].to(dtype)[None, :, None, None])
            new = vs.bias_act(t["x"], t["bias"], act=act)
        assert torch.equal(new, old)

        b = t["r"].shape[0]
        out_old = t["out"].clone()
        rb = t["y"] + t["bias"].to(dtype)[None, :, None, None]
        wt = t["gate"].permute(0, 3, 1, 2).to(dtype)
        prop_out = ((t["prop"] + (t["r"] + rb)) * wt).to(dtype)
        out_old.view(b, 3, c, *t["r"].shape[2:])[:, 1] = prop_out
        out = t["out"].clone()
        nxt = vs.gate_tail(t["prop"], t["r"], t["y"], t["bias"], t["gate"],
                           out.view(b, 3, c, *t["r"].shape[2:])[:, 1],
                           t["pair"])
        assert torch.equal(out, out_old)
        assert torch.equal(nxt, torch.cat([prop_out, n1], dim=1))
    assert (vs.warp_pair.launches, vs.bias_act.launches,
            vs.gate_tail.launches) == (0, 0, 0)


@pytest.mark.parametrize("op", ["warp_pair", "bias_act", "gate_tail"])
@pytest.mark.parametrize("grad", [False, True])
def test_vsrpp_step_dispatch(op, grad, monkeypatch):
    """With every tensor taken for a card's and the launch recorded: a call
    reaches the launch once, with one argument for each of the C function's
    parameters (the stream added by ``_launch``) and the views' strides in
    elements; a call that autograd records reaches it through the op's
    autograd Function, whose node its output carries."""
    from flair_tpu_torch.ops import vsrpp_step as vs
    launched = []
    monkeypatch.setattr(vs, "_on_card", lambda t: True)
    monkeypatch.setattr(vs, "_launch",
                        lambda fn, dev, *args: launched.append((fn, args)))
    t = step_tensors(torch.float32, "pixel")
    c, (h, w) = t["x"].shape[1], t["x"].shape[2:]
    if grad:
        for k in ("pair", "x", "r"):
            t[k].requires_grad_()
    call = {"warp_pair": lambda: vs.warp_pair(t["pair"], t["f1"], t["f2"]),
            "bias_act": lambda: vs.bias_act(t["x"], t["bias"], t["add"],
                                            "leaky"),
            "gate_tail": lambda: vs.gate_tail(
                t["prop"], t["r"], t["y"], t["bias"], t["gate"],
                t["out"][:2], t["pair"])}[op]
    with torch.set_grad_enabled(grad):
        out = call()
    assert (out.grad_fn is not None) == grad
    if grad:
        assert type(out.grad_fn).__name__.startswith(
            {"warp_pair": "_WarpPair", "bias_act": "_BiasAct",
             "gate_tail": "_GateTail"}[op])
    (fn, args), = launched
    assert fn == f"vsrpp_{op}_launch"
    assert len(args) + 1 == len(vs._SIGNATURES[fn][0])
    view = (t["x"].data_ptr(), h * w * c, c)
    if op == "bias_act":
        assert args[2:5] == view and args[6:9] == (t["add"].data_ptr(),
                                                   h * w * c, c)
    elif op == "warp_pair":
        assert args[1:4] == (t["pair"].data_ptr(), h * w * 2 * c, 2 * c)
        assert args[6] == 2 * h * w             # the flows' frame stride
    else:
        assert args[11:15] == (t["gate"].data_ptr(), h * w, w, 1)


def fake_step_kernels(monkeypatch):
    """Every tensor taken for a card's, and each step kernel computed by its
    plain version on the CPU (counted as a launch): the kernel route's
    autograd Functions run as on the card."""
    from flair_tpu_torch.ops import vsrpp_step as vs

    def fake(op, plain):
        def kernel(*args):
            getattr(vs, op).launches += 1
            return plain(*args)
        monkeypatch.setattr(vs, f"_{op}_kernel", kernel)
    monkeypatch.setattr(vs, "_on_card", lambda t: True)
    fake("warp_pair", vs.warp_pair_plain)
    fake("bias_act", vs.bias_act_plain)
    fake("gate_tail", vs.gate_tail_plain)
    for op in ("warp_pair", "bias_act", "gate_tail"):
        setattr(getattr(vs, op), "launches", 0)
    return vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["warp_pair", "bias_act", "bias_act_addend",
                                  "gate_tail_frame", "gate_tail_pixel",
                                  "gate_tail_first"])
def test_vsrpp_step_grads_match_plain_autograd(case, dtype, monkeypatch):
    """Under autograd each step op runs its kernel (here faked by its plain
    version) inside an autograd Function whose backward is the plain
    version's float32 VJP: the values, and the gradients of every input and
    of the tail's output slot, are plain autograd's (float32: to rounding;
    bf16: to one bf16 rounding of the float32 gradients)."""
    from flair_tpu_torch.ops import vsrpp_step as vs
    t = step_tensors(dtype, "pixel" if case == "gate_tail_pixel" else "frame")
    c = t["x"].shape[1]
    b = t["r"].shape[0]
    keys = {"warp_pair": ("pair", "f1", "f2"),
            "bias_act": ("x", "bias"), "bias_act_addend": ("x", "add"),
            "gate_tail_frame": ("prop", "r", "y", "bias", "gate", "pair"),
            "gate_tail_pixel": ("prop", "r", "y", "bias", "gate", "pair"),
            "gate_tail_first": ("r", "y", "bias", "gate", "pair")}[case]

    def run(ops, up):
        leaf = {k: t[k].float().detach().requires_grad_() if up else
                t[k].detach().clone().requires_grad_() for k in keys}
        a = {**t, **leaf}
        if case == "warp_pair":
            outs = [ops.warp_pair(a["pair"], a["f1"], a["f2"])]
        elif case.startswith("bias_act"):
            outs = [ops.bias_act(a["x"], a.get("bias") if "bias" in keys
                                 else None, a.get("add") if "add" in keys
                                 else None, "leaky")]
        else:
            out = torch.zeros((3 * b, c, *a["r"].shape[2:]),
                              dtype=a["r"].dtype).contiguous(
                memory_format=torch.channels_last)
            slot = out.view(b, 3, c, *a["r"].shape[2:])[:, 1]
            nxt = ops.gate_tail(a["prop"] if "prop" in keys else None,
                                a["r"], a["y"], a["bias"], a["gate"], slot,
                                a["pair"])
            outs = [nxt, out]
        # weights that bf16 holds exactly: the upstream gradients of both
        # runs are equal
        w = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i)
                         ).bfloat16().float() for i, o in enumerate(outs)]
        loss = sum((o.float() * wi).sum() for o, wi in zip(outs, w))
        grads = torch.autograd.grad(loss, [leaf[k] for k in keys])
        return [o.detach() for o in outs], dict(zip(keys, grads))

    outs_ref, grads_ref = run(vs, up=True)      # plain autograd, float32
    fake_step_kernels(monkeypatch)
    outs, grads = run(vs, up=False)
    op = case.split("_")[0] + "_" + case.split("_")[1]
    assert getattr(vs, op).launches == 1
    # bf16: the plain version's two or three roundings, and the tail's
    # gradient of the next pair summed in bf16
    tol = 0.0 if dtype == torch.float32 else 2 ** -7
    for o, r in zip(outs, outs_ref):
        assert o.dtype == dtype
        assert torch.allclose(o.float(), r, rtol=tol,
                              atol=tol * r.abs().max().item())
    for k in keys:
        assert grads[k].dtype == t[k].dtype
        ref = grads_ref[k].to(t[k].dtype).float()
        assert torch.allclose(grads[k].float(), ref, rtol=tol,
                              atol=tol * ref.abs().max().item()), k


def test_vsrpp_training_takes_the_kernels(monkeypatch):
    """A BasicVSRPP training forward and backward with the step kernels
    (faked by their plain versions, as the card runs them inside their
    autograd Functions) launches them as a no-grad call does, 2(T-1) warps,
    2(6T-2) bias passes and 2T tails, and gives plain autograd's output and
    gradients, the frame slots of the output included."""
    from flair_tpu_torch.models import vsrpp as t_vsrpp
    c, g, b, t, h, w = 32, 16, 1, 3, 8, 10
    torch.manual_seed(0)
    m = t_vsrpp.BasicVSRPP(c, max_residue_magnitude=5.0, deform_groups=g)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn(p.shape) * 0.05)
    hid = torch.from_numpy(rand(7, b * t, c, h, w)).contiguous(
        memory_format=torch.channels_last)
    ff, fb = (torch.from_numpy(rand(s, b, t - 1, 2, h, w, scale=2.0))
              for s in (8, 9))
    wmap = torch.from_numpy(rand(10, b, t, h, w, 1, scale=0.5)).abs()
    params = dict(m.named_parameters())

    def step():
        x = hid.clone().requires_grad_()
        out = m(x, b, ff, fb, wmap)
        loss = (out * torch.linspace(-1, 1, out.numel()).view(out.shape)
                ).sum()
        grads = torch.autograd.grad(loss, [x, *params.values()])
        return out.detach(), grads

    out_ref, grads_ref = step()
    vs = fake_step_kernels(monkeypatch)
    out, grads = step()
    assert (vs.warp_pair.launches, vs.bias_act.launches,
            vs.gate_tail.launches) == (2 * (t - 1), 2 * (6 * t - 2), 2 * t)
    assert torch.allclose(out, out_ref, rtol=1e-6, atol=1e-6)
    for name, gr, gk in zip(["x", *params], grads_ref, grads):
        scale = gr.abs().max().item()
        assert torch.allclose(gk, gr, rtol=1e-5, atol=1e-6 * scale), name


@pytest.mark.parametrize("c,vec", [(16, 8), (54, 1)])
def test_vsrpp_bias_act_any_width(c, vec, monkeypatch):
    """bias_act takes any width on the card: whole 8-channel vectors launch
    the vector instance, another width (the offset head's 27·G at G = 2)
    the scalar one, whose views need no 16-byte alignment."""
    from flair_tpu_torch.ops import vsrpp_step as vs
    launched = []
    monkeypatch.setattr(vs, "_on_card", lambda t: True)
    monkeypatch.setattr(vs, "_launch",
                        lambda fn, dev, *args: launched.append(args))
    t = step_tensors(torch.bfloat16, "frame", c=c)
    h, w = t["x"].shape[2:]
    with torch.no_grad():
        vs.bias_act(t["x"], t["bias"], t["add"], "leaky")
    args, = launched
    assert args[2:5] == (t["x"].data_ptr(), h * w * c, c)
    assert args[-4:] == (2, h * w, c, vec)


@pytest.mark.parametrize("case", ["channels_last", "pair_half", "clip_frame",
                                  "nchw", "odd_offset"])
def test_vsrpp_step_views(case):
    """The kernels' view of a tensor: (pointer, frame stride, pixel stride)
    in elements for channels-last storage, a channel slice of it and a frame
    of a clip; channels-first storage and a slice off the 16-byte vectors
    raise."""
    from flair_tpu_torch.ops import vsrpp_step as vs
    c, h, w = 16, 4, 6
    base = torch.zeros((3, 2 * c, h, w), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    v = {"channels_last": base[:, :c].contiguous(
             memory_format=torch.channels_last),
         "pair_half": base[:, c:],
         "clip_frame": base.reshape(1, 3, 2 * c, h, w)[:, 1],
         "nchw": base[:, :c].contiguous(),
         "odd_offset": base[:, 4:4 + c]}[case]
    ch = 2 * c if case == "clip_frame" else c
    if case in ("nchw", "odd_offset"):
        with pytest.raises(ValueError):
            vs._view(v, ch, v.dtype, v.device, case)
        return
    ptr, sb, ps = vs._view(v, ch, v.dtype, v.device, case)
    assert ptr == v.data_ptr() and ps == (ch if case == "channels_last"
                                          else 2 * c)
    assert sb == {"channels_last": h * w * c, "pair_half": h * w * 2 * c,
                  "clip_frame": 3 * h * w * 2 * c}[case]


def test_vsrpp_forward_copies_nothing_from_host(monkeypatch):
    """A BasicVSRPP forward (gating map resized included) makes no tensor
    from host data: the offset permutation is a buffer built once, absent
    from state_dict, equal to the reference interleave; the nearest resize
    of the gating map selects the rows and columns resize_matrix's one-hot
    rows select, bit for bit. On the CPU no step kernel launches."""
    from flair_tpu_torch.models import vsrpp as t_vsrpp
    from flair_tpu_torch.ops import vsrpp_step as vs
    c, g = 32, 16
    m = t_vsrpp.BasicVSRPP(c, max_residue_magnitude=5.0, deform_groups=g)
    names = {k for k, _ in m.named_buffers()}
    assert names == {"backward_1.deform_align.offset_perm",
                     "forward_1.deform_align.offset_perm"}
    assert not names & set(m.state_dict())
    ko = 9 * (g // 2)
    base = np.arange(ko) * 2
    ref = np.concatenate([base, 2 * ko + base, base + 1, 2 * ko + base + 1,
                          np.arange(4 * ko, 27 * g)])
    assert np.array_equal(m.forward_1.deform_align.offset_perm.numpy(), ref)

    rng = np.random.default_rng(3)
    wmap = torch.from_numpy(rng.uniform(0, 1, (1, 3, 24, 20, 1))
                            .astype(np.float32))
    ry, rx = (torch.from_numpy(t_resize.resize_matrix(o, i, "nearest"))
              .float() for o, i in ((10, 24), (12, 20)))
    old = torch.einsum("vw,bthwc->bthvc", rx,
                       torch.einsum("uh,bthwc->btuwc", ry, wmap))
    assert torch.equal(t_vsrpp.resize_weight_map(wmap, 10, 12), old)

    b, t, h, w = 1, 3, 10, 12
    hid = torch.from_numpy(rand(4, b * t, c, h, w)).contiguous(
        memory_format=torch.channels_last)
    ff, fb = (torch.from_numpy(rand(s, b, t - 1, 2, h, w, scale=2.0))
              for s in (5, 6))

    def no_host(*a, **kw):
        raise AssertionError("a tensor made from host data in the forward")
    monkeypatch.setattr(torch, "as_tensor", no_host)
    monkeypatch.setattr(torch, "from_numpy", no_host)
    monkeypatch.setattr(torch, "tensor", no_host)
    for op in ("warp_pair", "bias_act", "gate_tail"):
        setattr(getattr(vs, op), "launches", 0)
    with torch.no_grad():
        out = m(hid, b, ff, fb, wmap)
    assert out.shape == hid.shape and torch.isfinite(out).all()
    assert (vs.warp_pair.launches, vs.bias_act.launches,
            vs.gate_tail.launches) == (0, 0, 0)
