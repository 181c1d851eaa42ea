"""Weights → the port's ``state_dict``: from flax, and from the reference's
released torch checkpoints.

The port names its modules after the flax scopes, so the map is mostly
transposes. Input is the flat flax dict — the format of
``goldens/*/params.npz`` and of ``flair_tpu.utils.checkpoint.flatten_params``:
``"params/down_0/res_block/block1/conv/Conv_0/kernel" → array``.

- the ``params/`` collection prefix and the ``Conv_0`` / ``Dense_0`` /
  ``GroupNorm_0`` scopes of the flax wrapper modules are dropped;
- conv kernels HWIO → OIHW, Conv3d kernels ((3, 1, 1) in the BicubicUNet,
  3×3×3 in the BlurUNet) DHWIO → OIDHW, Dense kernels (in, out) →
  (out, in); all become ``weight``;
- DenseGeneral kernels of multi-head attention are 3-D: ``query`` /
  ``key`` / ``value`` (E, H, Dh) → (H·Dh, E) with bias (H, Dh) → (H·Dh,),
  ``out`` (H, Dh, E) → (E, H·Dh);
- norm ``scale`` → ``weight``;
- the ``batch_stats/`` collection (ParseNet's BatchNorm) → the buffers
  ``running_mean`` / ``running_var``;
- the deformable alignment's ``weight`` (HWIO) → OIHW;
- AMT's ``UpConv`` kernels (flax ``ConvTranspose`` under the scope
  ``deconv``, (kh, kw, in, out) correlated unflipped) → torch's
  ``ConvTranspose2d`` layout (in, out, kh, kw) with the taps reversed.

``offset_out`` stays in the reference channel order; the model permutes it
when applied (``models/vsrpp.py::_offset_perm``).

Upstream torch checkpoints (``convert_<model>(state_dict)``) take two steps:
the port's copy of the JAX package's name maps (``flair_tpu/utils/
convert.py``, which walk the reference modules' construction order) gives
the flat flax names, and ``from_flax`` the port's names. The walks
read the state dict through an :class:`UpstreamReader`, whose ``has`` /
``put`` name both sides of every entry.
"""

from __future__ import annotations

import re
from typing import Mapping, Sequence

import numpy as np
import torch

_WRAPPER_SCOPE = re.compile(r"^(Conv|Dense|GroupNorm)_\d+$")
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _convert_leaf(name: str, arr: np.ndarray, scope: str):
    if name == "kernel" and scope == "deconv":
        # flax ConvTranspose correlates an unflipped (kh, kw, in, out)
        # kernel; torch's conv_transpose2d takes (in, out, kh, kw) flipped
        return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if name == "kernel" and arr.ndim == 3:
        if scope == "out":
            return "weight", arr.reshape(-1, arr.shape[-1]).T
        return "weight", arr.reshape(arr.shape[0], -1).T
    if name == "bias" and arr.ndim == 2:
        return name, arr.reshape(-1)
    if name in ("kernel", "weight") and arr.ndim >= 2:
        perm = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[arr.ndim]
        return "weight", np.transpose(arr, perm)
    if name == "scale":
        return "weight", arr
    return name, arr


def from_flax(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat flax variables (``params/`` and ``batch_stats/``) → state_dict
    of float32 tensors."""
    out = {}
    for key, val in flat.items():
        parts = key.split("/")
        collection = parts[0] if parts[0] in ("params", "batch_stats") else None
        if collection is not None:
            parts = parts[1:]
        parts = [p for p in parts if not _WRAPPER_SCOPE.match(p)]
        arr = np.asarray(val, np.float32)
        if collection == "batch_stats":
            name = _BATCH_STATS[parts[-1]]
        else:
            scope = parts[-2] if len(parts) > 1 else ""
            name, arr = _convert_leaf(parts[-1], arr, scope)
        out[".".join(parts[:-1] + [name])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


# the flax models make these convs bare (``nn.Conv``, no ``Conv_0`` scope):
# every conv inside BasicVSR++ and SPyNet, and the temporal attention's
# output projection
_BARE_CONV_OWNERS = ("BasicVSRPP", "SPyNet")
_INVERSE_PERM = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def flax_names(model: torch.nn.Module) -> dict:
    """``{parameter name: flat flax name}`` of a model whose flax leaves are
    plain convs, dense layers, norms and raw parameters — the BicubicUNet
    and the BlurUNet — so that ``from_flax(to_flax(state, names))`` gives
    ``state`` back and the flax names are the JAX model's own."""
    mods = dict(model.named_modules())
    bare = set()
    for name, mod in mods.items():
        kind = type(mod).__name__
        if kind in _BARE_CONV_OWNERS:
            bare.update(n for n in mods if n.startswith(name + "."))
        elif kind == "TemporalAttention":
            bare.add(f"{name}.proj" if name else "proj")
    names = {}
    for mod_name, mod in mods.items():
        kind = type(mod).__name__
        path = ["params"] + (mod_name.split(".") if mod_name else [])
        for pname, _ in mod.named_parameters(recurse=False):
            leaf = pname
            scope = path
            if kind in ("Conv2d", "Conv3d", "Dense"):
                leaf = "kernel" if pname == "weight" else pname
                if mod_name not in bare:
                    scope = path + [("Dense" if kind == "Dense" else "Conv")
                                    + "_0"]
            elif kind in ("GroupNorm32", "ShiftWindowGroupNorm"):
                leaf = "scale" if pname == "weight" else pname
            full = f"{mod_name}.{pname}" if mod_name else pname
            names[full] = "/".join(scope + [leaf])
    return names


def to_flax(state: Mapping[str, torch.Tensor], names: Mapping[str, str]) -> dict:
    """The port's tensors (a state dict, or any stream keyed like one) →
    flat flax float32 arrays under ``names`` (``flax_names``), in flax
    layouts: the inverse of ``from_flax``."""
    flat = {}
    for key, val in state.items():
        arr = val.detach().float().cpu().numpy()
        j = names[key]
        if j.rsplit("/", 1)[-1] in ("kernel", "weight") and arr.ndim >= 2:
            arr = np.transpose(arr, _INVERSE_PERM[arr.ndim])
        flat[j] = np.ascontiguousarray(arr)
    return flat


def from_flax_bicubic_unet(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat flax BicubicUNet params → ``BicubicUNet`` state_dict."""
    return from_flax(flat)


def from_flax_blur_unet(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat flax BlurUNet params → ``BlurUNet`` state_dict (the attention
    ``qkv`` Dense keeps its per-head (q, k, v) interleave)."""
    return from_flax(flat)


def from_flax_codeformer(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat flax CodeFormer / VQAutoEncoder params → the port's state_dict
    (``position_emb`` and ``quantize/embedding`` carry over as they are)."""
    return from_flax(flat)


def from_flax_parsenet(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat flax ParseNet variables, ``params`` and ``batch_stats`` → the
    port's state_dict."""
    return from_flax(flat)


# ---------------------------------------------------------------------------
# Upstream torch checkpoints → flat flax names (copy of the JAX package's
# maps, flair_tpu/utils/convert.py) → the port
# ---------------------------------------------------------------------------


def t2j_conv2d(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (O, I, kh, kw) → flax HWIO (kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def t2j_conv3d(w: np.ndarray) -> np.ndarray:
    """torch Conv3d (O, I, kt, kh, kw) → flax (kt, kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 4, 1, 0))


def t2j_linear(w: np.ndarray) -> np.ndarray:
    """torch Linear (O, I) → flax (I, O)."""
    return np.transpose(w)


def t2j_convtranspose2d(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (in, out, kh, kw) → flax ConvTranspose
    (kh, kw, in, out), taps reversed: flax correlates the kernel
    unflipped."""
    return np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])


# upstream layout → flax layout, by name; ``heads`` splits a (3E, E) /
# (E, E) attention projection into flax's per-head DenseGeneral kernels
LAYOUTS = {
    None: lambda w, heads: w,
    "conv": lambda w, heads: t2j_conv2d(w),
    "conv3d": lambda w, heads: t2j_conv3d(w),
    "linear": lambda w, heads: t2j_linear(w),
    "conv1x1_dense": lambda w, heads: w[:, :, 0, 0].T,   # 1×1 Conv2d
    "conv1d_dense": lambda w, heads: w[:, :, 0].T,       # 1-wide Conv1d
    "conv3d_dense": lambda w, heads: w.reshape(w.shape[:2]).T,  # 1×1×1 Conv3d
    "convtranspose": lambda w, heads: t2j_convtranspose2d(w),
    "heads_in": lambda w, heads: w.T.reshape(w.shape[1], heads, -1),
    "heads_out": lambda w, heads: w.T.reshape(heads, -1, w.shape[0]),
    "heads_bias": lambda w, heads: w.reshape(heads, -1),
}


class UpstreamReader:
    """An upstream state dict read into flat flax names
    (``params/<path>``, ``batch_stats/<path>``) in :attr:`flat`.

    ``has(t, j)``: the upstream entry ``t`` (whose flax leaf would be
    ``j``) is there. ``put(t, j, layout, ...)``: flax leaf ``j`` from
    upstream entry ``t`` (only ``rows`` of it, when given) in ``layout``.
    ``keys()``: the upstream names."""

    def __init__(self, state: Mapping[str, np.ndarray]):
        self.state = state
        self.flat: dict = {}

    def has(self, t: str, j: str) -> bool:
        return t in self.state

    def keys(self):
        return self.state.keys()

    def put(self, t: str, j: str, layout=None, *, rows=None, heads=None,
            collection: str = "params") -> None:
        if t not in self.state:
            raise KeyError(f"missing torch param: {t}")
        w = np.asarray(self.state[t])
        if rows is not None:
            w = w[rows[0]:rows[1]]
        self.flat[f"{collection}/{j}"] = np.asarray(LAYOUTS[layout](w, heads))


def _conv(r, t: str, j: str) -> None:
    r.put(f"{t}.weight", f"{j}/kernel", "conv")
    if r.has(f"{t}.bias", f"{j}/bias"):
        r.put(f"{t}.bias", f"{j}/bias")


def _linear(r, t: str, j: str) -> None:
    r.put(f"{t}.weight", f"{j}/kernel", "linear")
    if r.has(f"{t}.bias", f"{j}/bias"):
        r.put(f"{t}.bias", f"{j}/bias")


def _norm(r, t: str, j: str) -> None:
    """GroupNorm / LayerNorm / InstanceNorm affine params."""
    r.put(f"{t}.weight", f"{j}/scale")
    r.put(f"{t}.bias", f"{j}/bias")


def _bn(r, t: str, j: str) -> None:
    """BatchNorm → flax nn.BatchNorm params and batch_stats."""
    _norm(r, t, j)
    r.put(f"{t}.running_mean", f"{j}/mean", collection="batch_stats")
    r.put(f"{t}.running_var", f"{j}/var", collection="batch_stats")


# CodeFormer (guided_diffusion/codeformer.py:600-753) -----------------------


def _cf_resblock(r, t: str, j: str) -> None:
    _norm(r, f"{t}.norm1", f"{j}/norm1/GroupNorm_0")
    _conv(r, f"{t}.conv1", f"{j}/conv1")
    _norm(r, f"{t}.norm2", f"{j}/norm2/GroupNorm_0")
    _conv(r, f"{t}.conv2", f"{j}/conv2")
    if r.has(f"{t}.conv_out.weight", f"{j}/conv_out/kernel"):
        _conv(r, f"{t}.conv_out", f"{j}/conv_out")


def _cf_attnblock(r, t: str, j: str) -> None:
    _norm(r, f"{t}.norm", f"{j}/norm/GroupNorm_0")
    for p in ("q", "k", "v", "proj_out"):
        _conv(r, f"{t}.{p}", f"{j}/{p}")


def _cf_autoencoder(r, *, ch_mult: Sequence[int], num_res_blocks: int,
                    resolution: int, attn_resolutions: Sequence[int]) -> None:
    """Encoder + generator + codebook of the VQAutoEncoder
    (codeformer.py:244-354,357-434); block indices follow the reference's
    nn.Sequential construction order."""
    idx = 0
    _conv(r, f"encoder.blocks.{idx}", "encoder/conv_in")
    idx += 1
    curr, li = resolution, 0
    for i in range(len(ch_mult)):
        for _ in range(num_res_blocks):
            _cf_resblock(r, f"encoder.blocks.{idx}", f"encoder/block{li}")
            idx += 1
            li += 1
            if curr in attn_resolutions:
                _cf_attnblock(r, f"encoder.blocks.{idx}", f"encoder/attn{li}")
                idx += 1
                li += 1
        if i != len(ch_mult) - 1:
            _conv(r, f"encoder.blocks.{idx}.conv", f"encoder/down{i}/conv")
            idx += 1
            curr //= 2
    _cf_resblock(r, f"encoder.blocks.{idx}", "encoder/mid_block1")
    _cf_attnblock(r, f"encoder.blocks.{idx + 1}", "encoder/mid_attn")
    _cf_resblock(r, f"encoder.blocks.{idx + 2}", "encoder/mid_block2")
    _norm(r, f"encoder.blocks.{idx + 3}", "encoder/norm_out/GroupNorm_0")
    _conv(r, f"encoder.blocks.{idx + 4}", "encoder/conv_out")

    r.put("quantize.embedding.weight", "quantize/embedding")

    idx = 0
    _conv(r, f"generator.blocks.{idx}", "generator/conv_in")
    _cf_resblock(r, f"generator.blocks.{idx + 1}", "generator/mid_block1")
    _cf_attnblock(r, f"generator.blocks.{idx + 2}", "generator/mid_attn")
    _cf_resblock(r, f"generator.blocks.{idx + 3}", "generator/mid_block2")
    idx += 4
    li = 0
    curr = resolution // 2 ** (len(ch_mult) - 1)
    for i in reversed(range(len(ch_mult))):
        for _ in range(num_res_blocks):
            _cf_resblock(r, f"generator.blocks.{idx}", f"generator/block{li}")
            idx += 1
            li += 1
            if curr in attn_resolutions:
                _cf_attnblock(r, f"generator.blocks.{idx}",
                              f"generator/attn{li}")
                idx += 1
                li += 1
        if i != 0:
            _conv(r, f"generator.blocks.{idx}.conv", f"generator/up{i}/conv")
            idx += 1
            curr *= 2
    _norm(r, f"generator.blocks.{idx}", "generator/norm_out/GroupNorm_0")
    _conv(r, f"generator.blocks.{idx + 1}", "generator/conv_out")


def codeformer_names(r, *, nf: int = 64,
                     ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                     num_res_blocks: int = 2, resolution: int = 512,
                     attn_resolutions: Sequence[int] = (16,),
                     dim_embd: int = 512, n_head: int = 8, n_layers: int = 9,
                     codebook_size: int = 1024,
                     connect_list: Sequence[str] = ("32", "64", "128", "256"),
                     ) -> None:
    """The CodeFormer name map (flair_tpu convert_codeformer)."""
    _cf_autoencoder(r, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                    resolution=resolution, attn_resolutions=attn_resolutions)
    r.put("position_emb", "position_emb")
    _linear(r, "feat_emb", "feat_emb")
    E, H = dim_embd, n_head
    for i in range(n_layers):
        t, j = f"ft_layers.{i}", f"ft_layer{i}"
        _norm(r, f"{t}.norm1", f"{j}/norm1")
        _norm(r, f"{t}.norm2", f"{j}/norm2")
        _linear(r, f"{t}.linear1", f"{j}/linear1")
        _linear(r, f"{t}.linear2", f"{j}/linear2")
        for name, k in (("query", 0), ("key", 1), ("value", 2)):
            rows = (k * E, (k + 1) * E)
            r.put(f"{t}.self_attn.in_proj_weight",
                  f"{j}/self_attn/{name}/kernel", "heads_in", rows=rows,
                  heads=H)
            r.put(f"{t}.self_attn.in_proj_bias", f"{j}/self_attn/{name}/bias",
                  "heads_bias", rows=rows, heads=H)
        r.put(f"{t}.self_attn.out_proj.weight", f"{j}/self_attn/out/kernel",
              "heads_out", heads=H)
        r.put(f"{t}.self_attn.out_proj.bias", f"{j}/self_attn/out/bias")
    _norm(r, "idx_pred_layer.0", "idx_norm")
    r.put("idx_pred_layer.1.weight", "idx_pred/kernel", "linear")
    for f in connect_list:
        t, j = f"fuse_convs_dict.{f}", f"fuse_{f}"
        _cf_resblock(r, f"{t}.encode_enc", f"{j}/encode_enc")
        _conv(r, f"{t}.scale.0", f"{j}/scale_conv1")
        _conv(r, f"{t}.scale.2", f"{j}/scale_conv2")
        _conv(r, f"{t}.shift.0", f"{j}/shift_conv1")
        _conv(r, f"{t}.shift.2", f"{j}/shift_conv2")


def convert_codeformer(s: Mapping[str, np.ndarray], **config) -> dict:
    """CodeFormer released checkpoint → the port's ``CodeFormer``
    state_dict (codeformer.py:600-753; loaded at video_sample.py:351-359).
    ``config``: the reference constructor's widths, defaults the demo's."""
    r = UpstreamReader(s)
    codeformer_names(r, **config)
    return from_flax(r.flat)


# ParseNet (facelib/parsing/parsenet.py:140-194) -----------------------------


def _pn_conv(r, t: str, j: str) -> None:
    _conv(r, f"{t}.conv2d", f"{j}/conv")
    if r.has(f"{t}.norm.norm.weight", f"{j}/bn/scale"):
        _bn(r, f"{t}.norm.norm", f"{j}/bn")


def _pn_res(r, t: str, j: str) -> None:
    if r.has(f"{t}.shortcut_func.conv2d.weight", f"{j}/shortcut/conv/kernel"):
        _pn_conv(r, f"{t}.shortcut_func", f"{j}/shortcut")
    _pn_conv(r, f"{t}.conv1", f"{j}/conv1")
    _pn_conv(r, f"{t}.conv2", f"{j}/conv2")


def parsenet_names(r, *, down_steps: int = 4, up_steps: int = 4,
                   res_depth: int = 10) -> None:
    """The ParseNet name map (flair_tpu convert_parsenet)."""
    _pn_conv(r, "encoder.0", "enc_in")
    for i in range(down_steps):
        _pn_res(r, f"encoder.{i + 1}", f"enc_{i}")
    for i in range(res_depth):
        _pn_res(r, f"body.{i}", f"body_{i}")
    for i in range(up_steps):
        _pn_res(r, f"decoder.{i}", f"dec_{i}")
    _pn_conv(r, "out_img_conv", "out_img_conv")
    _pn_conv(r, "out_mask_conv", "out_mask_conv")


def convert_parsenet(s: Mapping[str, np.ndarray], **config) -> dict:
    """ParseNet released checkpoint → the port's ``ParseNet`` state_dict
    (loaded at facelib/parsing/__init__.py:8-25)."""
    r = UpstreamReader(s)
    parsenet_names(r, **config)
    return from_flax(r.flat)


# SPyNet (mmedit basicvsr_net.SPyNet; the FLAIR checkpoints embed it) -------


def spynet_names(r, *, prefix: str = "", levels: int = 6,
                 j_prefix: str = "") -> None:
    """The SPyNet name map: 6 pyramid levels × 5 convs."""
    for i in range(levels):
        for j in range(5):
            _conv(r, f"{prefix}basic_module.{i}.basic_module.{j}.conv",
                  f"{j_prefix}level{i}/conv{j}")


def convert_spynet(s: Mapping[str, np.ndarray], *, prefix: str = "",
                   levels: int = 6) -> dict:
    """mmedit SPyNet weights → the port's ``SPyNet`` state_dict."""
    r = UpstreamReader(s)
    spynet_names(r, prefix=prefix, levels=levels)
    return from_flax(r.flat)


# BicubicUNet (guided_diffusion/sr3.py:317-611, temporal blocks unet.py) ----


def _conv3d(r, t: str, j: str) -> None:
    r.put(f"{t}.weight", f"{j}/kernel", "conv3d")
    if r.has(f"{t}.bias", f"{j}/bias"):
        r.put(f"{t}.bias", f"{j}/bias")


def _conv1x1_as_dense(r, t: str, j: str) -> None:
    """torch 1×1 Conv2d → flax Dense (SR3 spatial attention)."""
    r.put(f"{t}.weight", f"{j}/kernel", "conv1x1_dense")
    if r.has(f"{t}.bias", f"{j}/bias"):
        r.put(f"{t}.bias", f"{j}/bias")


def _sr3_res_block(r, t: str, j: str) -> None:
    """sr3.ResnetBlock (sr3.py:123-161): FeatureWiseAffine + Block×2 + skip."""
    _linear(r, f"{t}.noise_func.noise_func.0", f"{j}/noise_proj/Dense_0")
    for b in ("block1", "block2"):
        _norm(r, f"{t}.{b}.block.0.wrapped_module", f"{j}/{b}/norm")
        _conv(r, f"{t}.{b}.block.3.wrapped_module", f"{j}/{b}/conv/Conv_0")
    if r.has(f"{t}.res_conv.wrapped_module.weight",
             f"{j}/res_conv/Conv_0/kernel"):
        _conv(r, f"{t}.res_conv.wrapped_module", f"{j}/res_conv/Conv_0")


def _adm_res3d(r, t: str, j: str) -> None:
    """ADM ResBlock with 3-D convs (unet.py:80-254) inside TemporalWrapper2."""
    _norm(r, f"{t}.in_layers.0.wrapped_module", f"{j}/in_norm")
    _conv3d(r, f"{t}.in_layers.2.wrapped_module", f"{j}/in_conv/Conv_0")
    _linear(r, f"{t}.emb_layers.1", f"{j}/emb_proj/Dense_0")
    _norm(r, f"{t}.out_layers.0.wrapped_module", f"{j}/out_norm")
    _conv3d(r, f"{t}.out_layers.3.wrapped_module", f"{j}/out_conv/Conv_0")


def _temporal_attention(r, t: str, j: str) -> None:
    """unet.TemporalAttention (unet.py:664-758)."""
    for lin in ("q_linear", "k_linear", "v_linear"):
        _linear(r, f"{t}.{lin}", f"{j}/{lin}/Dense_0")
    _conv(r, f"{t}.proj.wrapped_module", f"{j}/proj")
    _norm(r, f"{t}.norm.wrapped_module", f"{j}/norm")


def _vsrpp(r, t: str, j: str) -> None:
    """unet.BasicVSRPP (unet.py:313-595) minus the shared SPyNet."""
    for br in ("backward_1", "forward_1"):
        ta, ja = f"{t}.deform_align.{br}", f"{j}/{br}/deform_align"
        r.put(f"{ta}.weight", f"{ja}/weight", "conv")
        r.put(f"{ta}.bias", f"{ja}/bias")
        for k, src in enumerate((0, 2, 4)):
            _conv(r, f"{ta}.conv_offset.{src}", f"{ja}/offset_conv{k}")
        _conv(r, f"{ta}.conv_offset.6", f"{ja}/offset_out")
        tb, jb = f"{t}.backbone.{br}", f"{j}/{br}/backbone"
        _conv(r, f"{tb}.main.0", f"{jb}/conv_in")
        _conv(r, f"{tb}.main.2.conv1", f"{jb}/block0/conv1")
        _conv(r, f"{tb}.main.2.conv2", f"{jb}/block0/conv2")
    _conv(r, f"{t}.reconstruction.main.0", f"{j}/reconstruction/conv_in")
    _conv(r, f"{t}.reconstruction.main.2.conv1",
          f"{j}/reconstruction/block0/conv1")
    _conv(r, f"{t}.reconstruction.main.2.conv2",
          f"{j}/reconstruction/block0/conv2")
    _conv(r, f"{t}.conv_last", f"{j}/conv_last")


def _sr3_level_block(r, t: str, j: str) -> None:
    """ResnetBlocWithAttn (sr3.py:229-314): res_block + optional gated
    temporal modules; gates are TemporalWrapper2.emb_layers (sr3.py:203-226)."""
    _sr3_res_block(r, f"{t}.res_block", f"{j}/res_block")
    if r.has(f"{t}.conv_3d.emb_layers.1.weight",
             f"{j}/conv_3d_gate/gate/Dense_0/kernel"):
        _adm_res3d(r, f"{t}.conv_3d.wrapped_module", f"{j}/conv_3d")
        _linear(r, f"{t}.conv_3d.emb_layers.1",
                f"{j}/conv_3d_gate/gate/Dense_0")
    if r.has(f"{t}.attn.qkv.wrapped_module.weight", f"{j}/attn/qkv/kernel"):
        _norm(r, f"{t}.attn.norm.wrapped_module", f"{j}/attn/norm")
        _conv1x1_as_dense(r, f"{t}.attn.qkv.wrapped_module", f"{j}/attn/qkv")
        _conv1x1_as_dense(r, f"{t}.attn.out.wrapped_module", f"{j}/attn/out")
    if r.has(f"{t}.temp_attn.emb_layers.1.weight",
             f"{j}/temp_attn_gate/gate/Dense_0/kernel"):
        _temporal_attention(r, f"{t}.temp_attn.wrapped_module",
                            f"{j}/temp_attn")
        _linear(r, f"{t}.temp_attn.emb_layers.1",
                f"{j}/temp_attn_gate/gate/Dense_0")
    if r.has(f"{t}.vsrpp.emb_layers.1.weight",
             f"{j}/vsrpp_gate/gate/Dense_0/kernel"):
        _vsrpp(r, f"{t}.vsrpp.wrapped_module", f"{j}/vsrpp")
        _linear(r, f"{t}.vsrpp.emb_layers.1", f"{j}/vsrpp_gate/gate/Dense_0")


def bicubic_unet_names(r, *, channel_mults: Sequence[int] = (1, 2, 4, 8, 16),
                       res_blocks: int = 1) -> None:
    """The BicubicUNet name map (flair_tpu convert_bicubic_unet): downs =
    [conv_in] + per-level res_blocks + Downsample; mid ×2; ups with
    Upsample; final Block. The SPyNet the checkpoint repeats at every vsrpp
    site is read once, from the first."""
    _linear(r, "noise_level_mlp.1", "mlp_in/Dense_0")
    _linear(r, "noise_level_mlp.3", "mlp_out/Dense_0")
    num_mults = len(channel_mults)
    idx = 0
    _conv(r, f"downs.{idx}.wrapped_module", "conv_in/Conv_0")
    idx += 1
    li = 0
    for ind in range(num_mults):
        for _ in range(res_blocks):
            _sr3_level_block(r, f"downs.{idx}", f"down_{li}")
            idx += 1
            li += 1
        if ind != num_mults - 1:
            _conv(r, f"downs.{idx}.wrapped_module.conv",
                  f"downsample_{ind}/Conv_0")
            idx += 1
    _sr3_level_block(r, "mid.0", "mid_0")
    _sr3_level_block(r, "mid.1", "mid_1")
    idx = 0
    li = 0
    for ind in reversed(range(num_mults)):
        for _ in range(res_blocks + 1):
            _sr3_level_block(r, f"ups.{idx}", f"up_{li}")
            idx += 1
            li += 1
        if ind >= 1:
            _conv(r, f"ups.{idx}.wrapped_module.conv",
                  f"upsample_{ind}/Conv_0")
            idx += 1
    _norm(r, "final_conv.block.0.wrapped_module", "final_norm")
    _conv(r, "final_conv.block.3.wrapped_module", "final_conv/Conv_0")
    for k in r.keys():
        pos = k.find(".spynet.basic_module.")
        if pos != -1:
            spynet_names(r, prefix=k[:pos + len(".spynet.")],
                         j_prefix="spynet/")
            break


def convert_bicubic_unet(s: Mapping[str, np.ndarray], **config) -> dict:
    """FLAIR BicubicUNet checkpoint (flair_x8/x16_bicubic.pt) → the port's
    ``BicubicUNet`` state_dict."""
    r = UpstreamReader(s)
    bicubic_unet_names(r, **config)
    return from_flax(r.flat)


# BlurUNet (guided_diffusion/unet_new.py:901-1362) ----------------------------


def _adm_resblock(r, t: str, j: str, dims: int = 2) -> None:
    """unet_new.ResBlock (unet_new.py:198-330): in/emb/out layers + optional
    1×1 skip; convs are wrapped in LazyReshaper{2,3}D either way."""
    _norm(r, f"{t}.in_layers.0.wrapped_module", f"{j}/in_norm")
    cv = _conv3d if dims == 3 else _conv
    cv(r, f"{t}.in_layers.2.wrapped_module", f"{j}/in_conv/Conv_0")
    _linear(r, f"{t}.emb_layers.1", f"{j}/emb_proj/Dense_0")
    _norm(r, f"{t}.out_layers.0.wrapped_module", f"{j}/out_norm")
    cv(r, f"{t}.out_layers.3.wrapped_module", f"{j}/out_conv/Conv_0")
    if r.has(f"{t}.skip_connection.wrapped_module.weight",
             f"{j}/skip/Conv_0/kernel"):
        cv(r, f"{t}.skip_connection.wrapped_module", f"{j}/skip/Conv_0")


def _adm_attention(r, t: str, j: str, bottleneck: bool = False) -> None:
    """unet_new.AttentionBlock / AttentionbottleBlock (unet_new.py:332-429):
    qkv / proj_out are 1-D convs → flax Dense."""
    _norm(r, f"{t}.norm.wrapped_module", f"{j}/norm")
    r.put(f"{t}.qkv.weight", f"{j}/qkv/Dense_0/kernel", "conv1d_dense")
    r.put(f"{t}.qkv.bias", f"{j}/qkv/Dense_0/bias")
    r.put(f"{t}.proj_out.weight", f"{j}/proj/Dense_0/kernel", "conv1d_dense")
    r.put(f"{t}.proj_out.bias", f"{j}/proj/Dense_0/bias")
    if bottleneck:
        _linear(r, f"{t}.emb_layers.1", f"{j}/emb_proj/Dense_0")


def blur_unet_names(r, *,
                    channel_mult: Sequence[float] = (0.5, 1, 1, 2, 2, 4, 4),
                    num_res_blocks: int = 2,
                    attention_ds: Sequence[int] = (16, 32, 64),
                    rnn_ds: Sequence[int] = (1, 2),
                    temporal_block: bool = True) -> None:
    """The BlurUNet name map (flair_tpu convert_blur_unet): input_blocks =
    [conv] + per-level (res [+res3d] [+attn [+tattn]] [+vsrpp]) + down;
    the middle block's fixed list; output_blocks with a trailing
    up-ResBlock; the ``out`` head; the UNet's own SPyNet."""
    _linear(r, "time_embed.0", "time_embed_0/Dense_0")
    _linear(r, "time_embed.2", "time_embed_1/Dense_0")
    _conv(r, "input_blocks.0.0.wrapped_module", "conv_in/Conv_0")

    def level_layers(bi: str, j_prefix: str, ds: int) -> None:
        li = 0
        _adm_resblock(r, f"{bi}.{li}", f"{j_prefix}_res")
        li += 1
        if temporal_block:
            _adm_resblock(r, f"{bi}.{li}.wrapped_module",
                          f"{j_prefix}_res3d", dims=3)
            li += 1
        if ds in attention_ds:
            _adm_attention(r, f"{bi}.{li}", f"{j_prefix}_attn")
            li += 1
            if temporal_block:
                _temporal_attention(r, f"{bi}.{li}.wrapped_module",
                                    f"{j_prefix}_attn_temporal")
                li += 1
        if ds in rnn_ds and temporal_block:
            _vsrpp(r, f"{bi}.{li}.wrapped_module", f"{j_prefix}_vsrpp")

    idx = 1
    ds = 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            level_layers(f"input_blocks.{idx}", f"in_{level}_{i}", ds)
            idx += 1
        if level != len(channel_mult) - 1:
            _adm_resblock(r, f"input_blocks.{idx}.0", f"in_{level}_down")
            idx += 1
            ds *= 2

    mi = 0
    _adm_resblock(r, f"middle_block.{mi}", "mid_res1")
    mi += 1
    if temporal_block:
        _adm_resblock(r, f"middle_block.{mi}.wrapped_module", "mid_res3d_1",
                      dims=3)
        mi += 1
    _adm_attention(r, f"middle_block.{mi}", "mid_attn", bottleneck=True)
    mi += 1
    if temporal_block:
        _temporal_attention(r, f"middle_block.{mi}.wrapped_module",
                            "mid_attn_temporal")
        mi += 1
    _adm_resblock(r, f"middle_block.{mi}", "mid_res2")
    mi += 1
    if temporal_block:
        _adm_resblock(r, f"middle_block.{mi}.wrapped_module", "mid_res3d_2",
                      dims=3)

    idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            bi = f"output_blocks.{idx}"
            level_layers(bi, f"out_{level}_{i}", ds)
            if level and i == num_res_blocks:
                # the trailing up-ResBlock is the entry's last layer
                last = 1
                if temporal_block:
                    last += 1
                if ds in attention_ds:
                    last += 1 + (1 if temporal_block else 0)
                if ds in rnn_ds and temporal_block:
                    last += 1
                _adm_resblock(r, f"{bi}.{last}", f"out_{level}_up")
                ds //= 2
            idx += 1

    _norm(r, "out.0.wrapped_module", "out_norm")
    _conv(r, "out.2.wrapped_module", "out_conv/Conv_0")
    if any(k.startswith("spynet.") for k in r.keys()):
        spynet_names(r, prefix="spynet.", j_prefix="spynet/")


def convert_blur_unet(s: Mapping[str, np.ndarray], **config) -> dict:
    """FLAIR BlurUNet checkpoint (flair_gaussian/jpeg.pt) → the port's
    ``BlurUNet`` state_dict."""
    r = UpstreamReader(s)
    blur_unet_names(r, **config)
    return from_flax(r.flat)


# RetinaFace (facelib/detection/retinaface/{retinaface,retinaface_net}.py) ---


def _cbn(r, t: str, j: str) -> None:
    """conv_bn / conv_bn1X1 / conv_bn_no_relu Sequential(conv, bn[, leaky])
    → ConvBNLeaky's child ``cb`` (a ConvBN)."""
    r.put(f"{t}.0.weight", f"{j}/cb/conv/kernel", "conv")
    _bn(r, f"{t}.1", f"{j}/cb/bn")


def retinaface_names(r, *, network: str = "resnet50") -> None:
    """The RetinaFace name map (flair_tpu convert_retinaface), for the
    torchvision ResNet50 body or the MobileNet-0.25 body."""
    if network == "resnet50":
        r.put("body.conv1.weight", "body/conv1/kernel", "conv")
        _bn(r, "body.bn1", "body/bn1")
        for li, n in enumerate((3, 4, 6, 3)):
            for bi in range(n):
                t = f"body.layer{li + 1}.{bi}"
                j = f"body/layer{li + 1}_{bi}"
                for ci in (1, 2, 3):
                    r.put(f"{t}.conv{ci}.weight", f"{j}/c{ci}/conv/kernel",
                          "conv")
                    _bn(r, f"{t}.bn{ci}", f"{j}/c{ci}/bn")
                if r.has(f"{t}.downsample.0.weight",
                         f"{j}/downsample/conv/kernel"):
                    r.put(f"{t}.downsample.0.weight",
                          f"{j}/downsample/conv/kernel", "conv")
                    _bn(r, f"{t}.downsample.1", f"{j}/downsample/bn")
    else:
        # stage1 (6 entries), stage2 (6), stage3 (2); stage1's entry 0 is
        # conv_bn, the rest conv_dw (a Sequential of 6)
        names = (
            [("body.stage1.0", "body/s1_0", "cbn")]
            + [(f"body.stage1.{i}", f"body/s1_{i}", "dw") for i in range(1, 6)]
            + [(f"body.stage2.{i}", f"body/s2_{i}", "dw") for i in range(6)]
            + [(f"body.stage3.{i}", f"body/s3_{i}", "dw") for i in range(2)]
        )
        for t, j, kind in names:
            if kind == "cbn":
                _cbn(r, t, j)
            else:
                r.put(f"{t}.0.weight", f"{j}_dw/kernel", "conv")
                _bn(r, f"{t}.1", f"{j}_dwbn")
                r.put(f"{t}.3.weight", f"{j}_pw/kernel", "conv")
                _bn(r, f"{t}.4", f"{j}_pwbn")
    for name in ("output1", "output2", "output3", "merge1", "merge2"):
        _cbn(r, f"fpn.{name}", f"fpn/{name}")
    for si in (1, 2, 3):
        for cname in ("conv3X3", "conv5X5_1", "conv5X5_2",
                      "conv7X7_2", "conv7x7_3"):
            _cbn(r, f"ssh{si}.{cname}", f"ssh{si}/{cname}")
    for i in range(3):
        _conv(r, f"BboxHead.{i}.conv1x1", f"bbox_head{i}")
        _conv(r, f"ClassHead.{i}.conv1x1", f"class_head{i}")
        _conv(r, f"LandmarkHead.{i}.conv1x1", f"landmark_head{i}")


def convert_retinaface(s: Mapping[str, np.ndarray], *,
                       network: str = "resnet50") -> dict:
    """RetinaFace detector weights (detection_Resnet50_Final.pth /
    detection_mobilenet0.25_Final.pth, facelib/detection/__init__.py:25-48)
    → the port's ``RetinaFace`` state_dict."""
    r = UpstreamReader(s)
    retinaface_names(r, network=network)
    return from_flax(r.flat)


# SuperSloMo (superslomo.py:8-291) and DAVSRNet's auxiliary nets -----------


def _ss_unet(r, t: str, j: str) -> None:
    """One SuperSloMo UNet: conv1-3, down1-5 and up1-5 of two convs each."""
    for cv in ("conv1", "conv2", "conv3"):
        _conv(r, f"{t}.{cv}", f"{j}/{cv}")
    for i in range(1, 6):
        for cv in ("conv1", "conv2"):
            _conv(r, f"{t}.down{i}.{cv}", f"{j}/down{i}/{cv}")
            _conv(r, f"{t}.up{i}.{cv}", f"{j}/up{i}/{cv}")


def superslomo_names(r) -> None:
    """The SuperSloMo name map (flair_tpu convert_superslomo): the flow
    UNet and the interpolation UNet (superslomo.py:217-221)."""
    for net in ("flow_estimator", "interp"):
        _ss_unet(r, net, net)


def convert_superslomo(s: Mapping[str, np.ndarray]) -> dict:
    """SuperSloMo weights → the port's ``SuperSloMo`` state_dict."""
    r = UpstreamReader(s)
    superslomo_names(r)
    return from_flax(r.flat)


def davsr_aux_names(r) -> None:
    """The DAVSRNet auxiliary name map (flair_tpu convert_davsr_aux):
    HyPaNet's 1×1×1 Conv3d MLP as Dense layers (davsr.py:1722-1744) and
    the two SuperSloMo UNets (davsr.py:1788-1790). The BasicVSR++
    regularizer is not mapped, as in the JAX package: the reference's own
    upsamples 4× an iteration against fixed-size OTFs (davsr.py:1374-1380
    inside :1914-1916)."""
    for i, fc in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
        r.put(f"h.mlp.{i}.weight", f"hypanet/{fc}/kernel", "conv3d_dense")
        r.put(f"h.mlp.{i}.bias", f"hypanet/{fc}/bias")
    for net in ("flow", "interp"):
        _ss_unet(r, net, net)


def convert_davsr_aux(s: Mapping[str, np.ndarray]) -> dict:
    """DAVSRNet's HyPaNet and SuperSloMo weights → the matching part of the
    port's ``DAVSRNet`` state_dict (its ``vsr`` regularizer excluded)."""
    r = UpstreamReader(s)
    davsr_aux_names(r)
    return from_flax(r.flat)


# AMT (amt.py:44-111 + amt_blocks/*) -----------------------------------------


def _amt_convrelu(r, t: str, j: str) -> None:
    """ifrnet convrelu Sequential(Conv2d, PReLU) → ConvPReLU."""
    _conv(r, f"{t}.0", f"{j}/conv")
    r.put(f"{t}.1.weight", f"{j}/act/prelu")


def _amt_resblock(r, t: str, j: str) -> None:
    """ifrnet ResBlock: conv1-4 convrelu, conv5 plain, a trailing PReLU."""
    for i in (1, 2, 3, 4):
        _amt_convrelu(r, f"{t}.conv{i}", f"{j}/conv{i}")
    _conv(r, f"{t}.conv5", f"{j}/conv5")
    r.put(f"{t}.prelu.weight", f"{j}/prelu/prelu")


def amt_names(r) -> None:
    """The AMT name map (flair_tpu convert_amt; the released amt-l / amt-g
    layout): RAFT feature encoder (instance norms carry no weights), the
    IFRNet pyramid, the four decoders (convrelu, ResBlock, deconv), the
    five update blocks and the combination head."""
    _conv(r, "feat_encoder.conv1", "feat_encoder/conv1")
    _conv(r, "feat_encoder.conv2", "feat_encoder/conv2")
    for i, lname in enumerate(("layer1", "layer2", "layer3", "layer3_2")):
        for bi in range(2):
            t = f"feat_encoder.{lname}.{bi}"
            j = f"feat_encoder/layer{i}_{bi}"
            _conv(r, f"{t}.conv1", f"{j}/conv1")
            _conv(r, f"{t}.conv2", f"{j}/conv2")
            if r.has(f"{t}.downsample.0.weight", f"{j}/downsample/kernel"):
                _conv(r, f"{t}.downsample.0", f"{j}/downsample")
    for idx in range(4):
        for sub in range(2):
            _amt_convrelu(r, f"encoder.pyramid{idx + 1}.{sub}",
                          f"encoder/pyr{idx}_{sub}")
    for k in (4, 3, 2, 1):
        t, j = f"decoder{k}.convblock", f"decoder{k}"
        _amt_convrelu(r, f"{t}.0", f"{j}/conv_in")
        _amt_resblock(r, f"{t}.1", f"{j}/res")
        r.put(f"{t}.2.weight", f"{j}/up/deconv/kernel", "convtranspose")
        r.put(f"{t}.2.bias", f"{j}/up/deconv/bias")
    for u in ("update4", "update3_low", "update3_high", "update2_low",
              "update2_high"):
        for cv in ("convc1", "convc2", "convf1", "convf2", "conv"):
            _conv(r, f"{u}.{cv}", f"{u}/{cv}")
        for tseq, (j1, j2) in (("gru", ("gru1", "gru2")),
                               ("feat_head", ("feat1", "feat2")),
                               ("flow_head", ("flow1", "flow2"))):
            _conv(r, f"{u}.{tseq}.0", f"{u}/{j1}")
            _conv(r, f"{u}.{tseq}.2", f"{u}/{j2}")
    _conv(r, "comb_block.0", "comb0/conv")
    r.put("comb_block.1.weight", "comb0/act/prelu")
    _conv(r, "comb_block.2", "comb1")


def convert_amt(s: Mapping[str, np.ndarray]) -> dict:
    """AMT interpolator weights (amt.py:44-111) → the port's ``AMT``
    state_dict."""
    r = UpstreamReader(s)
    amt_names(r)
    return from_flax(r.flat)


# BiSeNet (facelib/parsing/bisenet.py:8-141 + parsing/resnet.py) -----------


def _cbr(r, t: str, j: str) -> None:
    """The reference ConvBNReLU (conv, bn) → ConvBNReLU."""
    r.put(f"{t}.conv.weight", f"{j}/conv/kernel", "conv")
    _bn(r, f"{t}.bn", f"{j}/bn")


def bisenet_names(r) -> None:
    """The BiSeNet name map (flair_tpu convert_bisenet; the
    parsing_bisenet.pth layout): the ResNet18 backbone, the context path,
    the fusion module and the three heads."""
    r.put("cp.resnet.conv1.weight", "resnet/conv1/kernel", "conv")
    _bn(r, "cp.resnet.bn1", "resnet/bn1")
    for li in range(4):
        for bi in range(2):
            t, j = f"cp.resnet.layer{li + 1}.{bi}", f"resnet/layer{li + 1}_{bi}"
            for ci in (1, 2):
                r.put(f"{t}.conv{ci}.weight", f"{j}/c{ci}/conv/kernel", "conv")
                _bn(r, f"{t}.bn{ci}", f"{j}/c{ci}/bn")
            if r.has(f"{t}.downsample.0.weight",
                     f"{j}/downsample/conv/kernel"):
                r.put(f"{t}.downsample.0.weight",
                      f"{j}/downsample/conv/kernel", "conv")
                _bn(r, f"{t}.downsample.1", f"{j}/downsample/bn")
    _cbr(r, "cp.conv_avg", "conv_avg")
    for arm in ("arm16", "arm32"):
        _cbr(r, f"cp.{arm}.conv", f"{arm}/conv")
        r.put(f"cp.{arm}.conv_atten.weight", f"{arm}/conv_atten/kernel",
              "conv")
        _bn(r, f"cp.{arm}.bn_atten", f"{arm}/bn_atten")
    _cbr(r, "cp.conv_head32", "conv_head32")
    _cbr(r, "cp.conv_head16", "conv_head16")
    _cbr(r, "ffm.convblk", "ffm/convblk")
    for i in (1, 2):
        r.put(f"ffm.conv{i}.weight", f"ffm/conv{i}/kernel", "conv")
    for name in ("conv_out", "conv_out16", "conv_out32"):
        _cbr(r, f"{name}.conv", f"{name}/conv")
        r.put(f"{name}.conv_out.weight", f"{name}/conv_out/kernel", "conv")


def convert_bisenet(s: Mapping[str, np.ndarray]) -> dict:
    """BiSeNet parser weights (facelib/parsing/__init__.py:8-25) → the
    port's ``BiSeNet`` state_dict."""
    r = UpstreamReader(s)
    bisenet_names(r)
    return from_flax(r.flat)


# RestoreFormer and VQVAEGAN (restoreformer.py:7-861) ----------------------


def _rf_resblock(r, t: str, j: str) -> None:
    _norm(r, f"{t}.norm1", f"{j}/norm1/GroupNorm_0")
    _conv(r, f"{t}.conv1", f"{j}/conv1")
    _norm(r, f"{t}.norm2", f"{j}/norm2/GroupNorm_0")
    _conv(r, f"{t}.conv2", f"{j}/conv2")
    if r.has(f"{t}.nin_shortcut.weight", f"{j}/nin_shortcut/kernel"):
        _conv(r, f"{t}.nin_shortcut", f"{j}/nin_shortcut")


def _rf_attn(r, t: str, j: str, *, norm2: bool) -> None:
    """MultiHeadAttnBlock (restoreformer.py:218-285). The reference module
    always owns norm2; the port's only on the cross-attention path."""
    _norm(r, f"{t}.norm1", f"{j}/norm1/GroupNorm_0")
    if norm2:
        _norm(r, f"{t}.norm2", f"{j}/norm2/GroupNorm_0")
    for p in ("q", "k", "v", "proj_out"):
        _conv(r, f"{t}.{p}", f"{j}/{p}")


def restoreformer_names(r, *, ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                        num_res_blocks: int = 2, resolution: int = 512,
                        attn_resolutions: Sequence[int] = (16,),
                        ex_multi_scale_num: int = 1,
                        cross: bool = True) -> None:
    """The RestoreFormer name map (flair_tpu convert_restoreformer):
    VQVAEGANMultiHeadTransformer with ``cross``, the plain VQVAEGAN
    without. The reference decoder's ModuleList is built with
    insert(0, ...), so up.{i} is level i."""
    n = len(ch_mult)
    _conv(r, "encoder.conv_in", "encoder/conv_in")
    curr = resolution
    for i in range(n):
        for j in range(num_res_blocks):
            _rf_resblock(r, f"encoder.down.{i}.block.{j}",
                         f"encoder/down{i}_block{j}")
            if curr in attn_resolutions:
                _rf_attn(r, f"encoder.down.{i}.attn.{j}",
                         f"encoder/down{i}_attn{j}", norm2=False)
        if i != n - 1:
            _conv(r, f"encoder.down.{i}.downsample.conv",
                  f"encoder/down{i}_ds/conv")
            curr //= 2
    _rf_resblock(r, "encoder.mid.block_1", "encoder/mid_block1")
    _rf_attn(r, "encoder.mid.attn_1", "encoder/mid_attn", norm2=False)
    _rf_resblock(r, "encoder.mid.block_2", "encoder/mid_block2")
    _norm(r, "encoder.norm_out", "encoder/norm_out/GroupNorm_0")
    _conv(r, "encoder.conv_out", "encoder/conv_out")

    _conv(r, "quant_conv", "quant_conv")
    _conv(r, "post_quant_conv", "post_quant_conv")
    r.put("quantize.embedding.weight", "quantize/embedding")

    dec_attn = list(attn_resolutions)
    if cross:
        for _ in range(ex_multi_scale_num):
            dec_attn = [dec_attn[0], dec_attn[-1] * 2]
    _conv(r, "decoder.conv_in", "decoder/conv_in")
    _rf_resblock(r, "decoder.mid.block_1", "decoder/mid_block1")
    _rf_attn(r, "decoder.mid.attn_1", "decoder/mid_attn", norm2=cross)
    _rf_resblock(r, "decoder.mid.block_2", "decoder/mid_block2")
    curr = resolution // 2 ** (n - 1)
    for i in reversed(range(n)):
        for j in range(num_res_blocks + 1):
            _rf_resblock(r, f"decoder.up.{i}.block.{j}",
                         f"decoder/up{i}_block{j}")
            if curr in dec_attn:
                _rf_attn(r, f"decoder.up.{i}.attn.{j}",
                         f"decoder/up{i}_attn{j}", norm2=cross)
        if i != 0:
            _conv(r, f"decoder.up.{i}.upsample.conv",
                  f"decoder/up{i}_us/conv")
            curr *= 2
    _norm(r, "decoder.norm_out", "decoder/norm_out/GroupNorm_0")
    _conv(r, "decoder.conv_out", "decoder/conv_out")


def convert_restoreformer(s: Mapping[str, np.ndarray], **config) -> dict:
    """RestoreFormer (``cross=True``) or VQVAEGAN (``cross=False``)
    weights → the port's ``RestoreFormer`` / ``VQVAEGAN`` state_dict."""
    r = UpstreamReader(s)
    restoreformer_names(r, **config)
    return from_flax(r.flat)


# VQFR (vqfr.py:11-586) ---------------------------------------------------


def _vqfr_res(r, t: str, j: str) -> None:
    _norm(r, f"{t}.norm1", f"{j}/norm1/GroupNorm_0")
    _conv(r, f"{t}.conv1", f"{j}/conv1")
    _norm(r, f"{t}.norm2", f"{j}/norm2/GroupNorm_0")
    _conv(r, f"{t}.conv2", f"{j}/conv2")
    if r.has(f"{t}.residual_func.weight", f"{j}/residual_func/kernel"):
        _conv(r, f"{t}.residual_func", f"{j}/residual_func")


def _vqgan_levels(r, side: str, n: int, num_blocks: int,
                  use_attention: bool) -> None:
    """The blocks.{k} Sequentials of the VQ-GAN encoder (level k, after a
    Downsample for k > 0) or decoder (level n-1-k, after an Upsample for
    k > 0), each num_blocks × [Res, Attn at the deepest level]."""
    for k in range(n):
        i = k if side == "encoder" else n - 1 - k
        si, t = 0, f"{side}.blocks.{k}"
        if k != 0:
            _conv(r, f"{t}.{si}.conv",
                  f"{side}/{'down' if side == 'encoder' else 'up'}{i}/conv")
            si += 1
        for j in range(num_blocks):
            _vqfr_res(r, f"{t}.{si}", f"{side}/block{i}_{j}")
            si += 1
            if i == n - 1 and use_attention:
                _cf_attnblock(r, f"{t}.{si}", f"{side}/attn{i}_{j}")
                si += 1


def _vqgan_mid(r, side: str, use_attention: bool) -> None:
    _vqfr_res(r, f"{side}.mid_blocks.0", f"{side}/mid1")
    if use_attention:
        _cf_attnblock(r, f"{side}.mid_blocks.1", f"{side}/mid_attn")
    _vqfr_res(r, f"{side}.mid_blocks.{2 if use_attention else 1}",
              f"{side}/mid2")


def vqfr_names(r, *,
               channel_multipliers: Sequence[int] = (1, 2, 2, 4, 4, 8),
               num_enc_blocks: int = 2, use_enc_attention: bool = True,
               num_dec_blocks: int = 2, use_dec_attention: bool = True
               ) -> None:
    """The VQFRv2 name map (flair_tpu convert_vqfr; the released
    VQFR_v2.pth layout): encoder, token head and codebook, decoder, the
    shared output head and the main branch."""
    n = len(channel_multipliers)
    _conv(r, "inpfeat_extraction", "inpfeat_extraction")
    _conv(r, "encoder.conv_in", "encoder/conv_in")
    _vqgan_levels(r, "encoder", n, num_enc_blocks, use_enc_attention)
    _vqgan_mid(r, "encoder", use_enc_attention)
    _norm(r, "encoder.conv_out.0", "encoder/norm_out/GroupNorm_0")
    _conv(r, "encoder.conv_out.2", "encoder/conv_out")
    if r.has("feat2index.0.weight", "feat2index_norm/scale"):
        _norm(r, "feat2index.0", "feat2index_norm")
        _linear(r, "feat2index.1", "feat2index")
    r.put("quantizer.embedding.weight", "quantizer/embedding")
    _conv(r, "decoder.conv_in", "decoder/conv_in")
    _vqgan_mid(r, "decoder", use_dec_attention)
    _vqgan_levels(r, "decoder", n, num_dec_blocks, use_dec_attention)
    _norm(r, "decoder.conv_out.0", "decoder_out/norm_out/GroupNorm_0")
    _conv(r, "decoder.conv_out.2", "decoder_out/conv_out")
    for i in reversed(range(n)):
        lv = 2 ** i
        t = f"main_branch.align_func_dict.Level_{lv}"
        j = f"align_Level_{lv}"
        _conv(r, f"{t}.offset_conv1.0", f"{j}/off1_0")
        _norm(r, f"{t}.offset_conv1.1", f"{j}/off1_n0/GroupNorm_0")
        _conv(r, f"{t}.offset_conv1.3", f"{j}/off1_1")
        _norm(r, f"{t}.offset_conv1.4", f"{j}/off1_n1/GroupNorm_0")
        _conv(r, f"{t}.offset_conv1.6", f"{j}/off1_2")
        _conv(r, f"{t}.offset_conv2.0", f"{j}/off2")
        _norm(r, f"{t}.offset_conv2.1", f"{j}/off2_n/GroupNorm_0")
        _conv(r, f"{t}.dcn.conv_offset", f"{j}/dcn/conv_offset")
        r.put(f"{t}.dcn.weight", f"{j}/dcn/weight", "conv")
        r.put(f"{t}.dcn.bias", f"{j}/dcn/bias")
        if i != n - 1:
            _conv(r, f"main_branch.pre_upsample_dict.Level_{lv}.1",
                  f"pre_up_{lv}")
            _vqfr_res(r, f"main_branch.decoder_dict.Level_{lv}",
                      f"dec_Level_{lv}")


def convert_vqfr(s: Mapping[str, np.ndarray], **config) -> dict:
    """VQFRv2 weights (vqfr.py:490-586) → the port's ``VQFRv2``
    state_dict."""
    r = UpstreamReader(s)
    vqfr_names(r, **config)
    return from_flax(r.flat)


# YOLOv5-face (facelib/detection/yolov5face/models/yolo.py:95-235) ---------


def _yolo_conv(r, t: str, j: str) -> None:
    """yolov5face Conv (common.py:46-48): conv (no bias) + BN."""
    r.put(f"{t}.conv.weight", f"{j}/conv/kernel", "conv")
    _bn(r, f"{t}.bn", f"{j}/bn")


def yolov5face_names(r, cfg: Mapping) -> None:
    """The YOLOv5-face name map (flair_tpu convert_yolov5face) for
    ``YOLOv5FromConfig(cfg)``: the same [from, number, module, args] walk
    as the interpreter, so torch layer i is the port's ``l{i}_<module>``."""
    from ..models.yolov5face import layer_name

    gd = cfg["depth_multiple"]
    layers = list(cfg["backbone"]) + list(cfg["head"])
    for li, (frm, num, mod, args) in enumerate(layers):
        mod = str(mod)
        t, j = f"model.{li}", layer_name(li, mod)
        n = max(round(num * gd), 1) if num > 1 else num
        if mod == "Conv":
            _yolo_conv(r, t, j)
        elif mod == "StemBlock":
            for sub in ("stem_1", "stem_2a", "stem_2b", "stem_3"):
                _yolo_conv(r, f"{t}.{sub}", f"{j}/{sub}")
        elif mod == "C3":
            for sub in ("cv1", "cv2", "cv3"):
                _yolo_conv(r, f"{t}.{sub}", f"{j}/{sub}")
            for bi in range(n):
                _yolo_conv(r, f"{t}.m.{bi}.cv1", f"{j}/m{bi}/cv1")
                _yolo_conv(r, f"{t}.m.{bi}.cv2", f"{j}/m{bi}/cv2")
        elif mod == "SPP":
            _yolo_conv(r, f"{t}.cv1", f"{j}/cv1")
            _yolo_conv(r, f"{t}.cv2", f"{j}/cv2")
        elif mod == "ShuffleV2Block":
            pairs = ((("branch1.0", "b1_dw"), ("branch1.2", "b1_pw"))
                     if args[1] > 1 else ()) + (
                ("branch2.0", "b2_pw1"), ("branch2.3", "b2_dw"),
                ("branch2.5", "b2_pw2"))
            for ni in range(n):
                tt = f"{t}.{ni}" if n > 1 else t
                for tb, jb in pairs:
                    # each branch conv's BatchNorm is the next entry
                    bn_t = f"{tt}.{tb[:-1]}{int(tb[-1]) + 1}"
                    r.put(f"{tt}.{tb}.weight", f"{j}_{ni}/{jb}_conv/kernel",
                          "conv")
                    _bn(r, bn_t, f"{j}_{ni}/{jb}_bn")
        elif mod == "Detect":
            for i in range(len(frm)):
                _conv(r, f"{t}.m.{i}", f"detect{i}")
        elif mod not in ("nn.Upsample", "Concat"):
            raise ValueError(f"unknown module in config: {mod}")


def convert_yolov5face(s: Mapping[str, np.ndarray], cfg: Mapping) -> dict:
    """YOLOv5-face weights (yolov5n / l-face .pth) → the state_dict of the
    port's ``YOLOv5FromConfig(cfg)``."""
    r = UpstreamReader(s)
    yolov5face_names(r, cfg)
    return from_flax(r.flat)
