"""YOLOv5-face, an alternative face detector (torch.nn, NCHW, inference
BatchNorm).

Counterpart of ``flair_tpu/models/yolov5face.py`` (reference
facelib/detection/yolov5face/**): the yolov5l-face graph written out
(``YOLOv5Face``: StemBlock → C3 / Conv backbone → SPP → PANet head → a
three-scale Detect of 16 outputs an anchor: xywh, objectness, 10 landmark
coordinates and one class), the YAML-built family
(``YOLOv5FromConfig``, with the bundled yolov5l / yolov5n-face configs) and
the host decode + NMS (``decode_predictions``), which takes the JAX
package's channels-last maps. ``load_yolo_yaml`` imports ``yaml`` only when
it is called. Module names follow the flax scopes
(``utils/convert.from_flax``).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm, Conv2d
from .registry import register_model
from .resnet import ConvBN

ANCHORS = np.array(
    [
        [[4, 5], [8, 10], [13, 16]],       # P3/8
        [[23, 29], [43, 55], [73, 105]],   # P4/16
        [[146, 217], [231, 300], [335, 433]],  # P5/32
    ],
    np.float32,
)
STRIDES = (8, 16, 32)


def _up(x, r: int = 2):
    """Nearest ×r (the JAX package's repeat)."""
    return x.repeat_interleave(r, dim=2).repeat_interleave(r, dim=3)


class YConv(ConvBN):
    """Conv (no bias, k // 2 pad) → BatchNorm → SiLU (common.py:42-54)."""

    def forward(self, x):
        return F.silu(super().forward(x))


class YBottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, shortcut: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.add = shortcut and in_ch == features
        self.cv1 = YConv(in_ch, features, 1, dtype=dtype)
        self.cv2 = YConv(features, features, 3, dtype=dtype)

    def forward(self, x):
        h = self.cv2(self.cv1(x))
        return x + h if self.add else h


class C3(nn.Module):
    """CSP bottleneck (common.py:106-117)."""

    def __init__(self, in_ch: int, features: int, n: int = 1,
                 shortcut: bool = True, dtype=torch.float32):
        super().__init__()
        c_ = features // 2
        self.n = n
        self.cv1 = YConv(in_ch, c_, 1, dtype=dtype)
        for i in range(n):
            self.add_module(f"m{i}", YBottleneck(c_, c_, shortcut, dtype))
        self.cv2 = YConv(in_ch, c_, 1, dtype=dtype)
        self.cv3 = YConv(2 * c_, features, 1, dtype=dtype)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class SPP(nn.Module):
    """Max-pools of k × k, stride 1, padded with -inf (JAX ``_maxpool``)."""

    def __init__(self, in_ch: int, features: int,
                 ks: Sequence[int] = (3, 5, 7), dtype=torch.float32):
        super().__init__()
        c_ = in_ch // 2
        self.ks = tuple(ks)
        self.cv1 = YConv(in_ch, c_, 1, dtype=dtype)
        self.cv2 = YConv(c_ * (len(self.ks) + 1), features, 1, dtype=dtype)

    def forward(self, x):
        x = self.cv1(x)
        pools = [x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.ks]
        return self.cv2(torch.cat(pools, dim=1))


class StemBlock(nn.Module):
    """(common.py:57-72): the 2 × 2 max-pool is in ceil mode."""

    def __init__(self, in_ch: int, features: int, dtype=torch.float32):
        super().__init__()
        self.stem_1 = YConv(in_ch, features, 3, 2, dtype=dtype)
        self.stem_2a = YConv(features, features // 2, 1, dtype=dtype)
        self.stem_2b = YConv(features // 2, features, 3, 2, dtype=dtype)
        self.stem_3 = YConv(2 * features, features, 1, dtype=dtype)

    def forward(self, x):
        s1 = self.stem_1(x)
        s2b = self.stem_2b(self.stem_2a(s1))
        s2p = F.max_pool2d(s1, 2, 2, ceil_mode=True)
        return self.stem_3(torch.cat([s2b, s2p], dim=1))


@register_model("yolov5face")
class YOLOv5Face(nn.Module):
    """The yolov5l-face graph (models/yolov5l.yaml). Input (B, 3, H, W) RGB
    in [0, 1], H, W % 32 == 0. Returns the per-level raw maps
    [(B, na·16, Hi, Wi)]; :func:`decode_predictions` takes them
    channels-last."""

    def __init__(self, width: int = 64, depth: Sequence[int] = (3, 9, 9, 3),
                 dtype=torch.float32):
        super().__init__()
        wd, d = width, tuple(depth)
        self.stem = StemBlock(3, wd, dtype)                     # P2/4
        self.c3_1 = C3(wd, wd * 2, d[0], dtype=dtype)
        self.down3 = YConv(wd * 2, wd * 4, 3, 2, dtype=dtype)   # P3/8
        self.c3_3 = C3(wd * 4, wd * 4, d[1], dtype=dtype)
        self.down4 = YConv(wd * 4, wd * 8, 3, 2, dtype=dtype)   # P4/16
        self.c3_5 = C3(wd * 8, wd * 8, d[2], dtype=dtype)
        self.down5 = YConv(wd * 8, wd * 16, 3, 2, dtype=dtype)  # P5/32
        self.spp = SPP(wd * 16, wd * 16, (3, 5, 7), dtype)
        self.c3_8 = C3(wd * 16, wd * 16, d[3], False, dtype)
        # the PANet head
        self.h9 = YConv(wd * 16, wd * 8, 1, dtype=dtype)
        self.h12 = C3(wd * 16, wd * 8, 3, False, dtype)
        self.h13 = YConv(wd * 8, wd * 4, 1, dtype=dtype)
        self.h16 = C3(wd * 8, wd * 4, 3, False, dtype)
        self.h17 = YConv(wd * 4, wd * 4, 3, 2, dtype=dtype)
        self.h19 = C3(wd * 8, wd * 8, 3, False, dtype)
        self.h20 = YConv(wd * 8, wd * 8, 3, 2, dtype=dtype)
        self.h22 = C3(wd * 16, wd * 16, 3, False, dtype)
        for i, c in enumerate((wd * 4, wd * 8, wd * 16)):
            self.add_module(f"detect{i}", Conv2d(c, 3 * 16, 1, dtype=dtype))

    def forward(self, x):
        x = self.c3_1(self.stem(x))
        p3 = self.c3_3(self.down3(x))
        p4 = self.c3_5(self.down4(p3))
        p5 = self.c3_8(self.spp(self.down5(p4)))
        h9 = self.h9(p5)
        x = self.h12(torch.cat([_up(h9), p4], dim=1))
        h13 = self.h13(x)
        o16 = self.h16(torch.cat([_up(h13), p3], dim=1))
        o19 = self.h19(torch.cat([self.h17(o16), h13], dim=1))
        o22 = self.h22(torch.cat([self.h20(o19), h9], dim=1))
        return [getattr(self, f"detect{i}")(f)
                for i, f in enumerate((o16, o19, o22))]


def decode_predictions(outs, conf_thres: float = 0.5,
                       iou_thres: float = 0.45) -> np.ndarray:
    """Host decode + NMS of the first image (models/yolo.py:52-79,
    face_detector.py semantics) of channels-last maps [(B, Hi, Wi, na·16)]
    (numpy, or CPU tensors). Returns (N, 16): x1, y1, x2, y2, conf, 10
    landmark coordinates, class."""
    from .retinaface import nms

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    dets = []
    for lvl, out in enumerate(outs):
        o = np.asarray(out[0], np.float32)
        ny, nx = o.shape[0], o.shape[1]
        o = o.reshape(ny, nx, 3, 16).transpose(2, 0, 1, 3)  # (na, ny, nx, 16)
        gy, gx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        grid = np.stack([gx, gy], -1)[None]  # (1, ny, nx, 2)
        stride = STRIDES[lvl]
        anchor = ANCHORS[lvl].reshape(3, 1, 1, 2)
        xy = (sig(o[..., 0:2]) * 2.0 - 0.5 + grid) * stride
        wh = (sig(o[..., 2:4]) * 2.0) ** 2 * anchor
        obj = sig(o[..., 4:5])
        lm = (o[..., 5:15].reshape(3, ny, nx, 5, 2) * anchor[:, :, :, None, :]
              + grid[:, :, :, None, :] * stride)
        cls = sig(o[..., 15:16])
        conf = (obj * cls).reshape(-1)
        keep = conf > conf_thres
        if not keep.any():
            continue
        xy = xy.reshape(-1, 2)[keep]
        wh = wh.reshape(-1, 2)[keep]
        lm = lm.reshape(-1, 10)[keep]
        boxes = np.concatenate([xy - wh / 2, xy + wh / 2], axis=1)
        dets.append(np.concatenate([boxes, conf[keep, None], lm,
                                    np.ones((keep.sum(), 1))], axis=1))
    if not dets:
        return np.zeros((0, 16), np.float32)
    dets = np.concatenate(dets, axis=0)
    dets = dets[dets[:, 4].argsort()[::-1]]
    return dets[nms(dets[:, :5], iou_thres)]


# ---------------------------------------------------------------------------
# The YAML-built family (models/yolo.py:95-235 parse_model)
# ---------------------------------------------------------------------------


class ShuffleV2Block(nn.Module):
    """ShuffleNet-V2 unit (yolov5face common.py:120-175): a channel split
    at stride 1, two downsampling branches at stride 2, then a shuffle of
    two channel groups."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        bf = features // 2
        self.stride = stride

        def dw(name, c, s):
            self.add_module(f"{name}_conv", Conv2d(
                c, c, 3, s, padding=1, use_bias=False, groups=c,
                dtype=dtype))
            self.add_module(f"{name}_bn", BatchNorm(c))

        def pw(name, cin, c):
            self.add_module(f"{name}_conv", Conv2d(cin, c, 1, use_bias=False,
                                                   dtype=dtype))
            self.add_module(f"{name}_bn", BatchNorm(c))

        if stride > 1:
            dw("b1_dw", in_ch, stride)
            pw("b1_pw", in_ch, bf)
            pw("b2_pw1", in_ch, bf)
        else:
            pw("b2_pw1", in_ch // 2, bf)
        dw("b2_dw", bf, stride)
        pw("b2_pw2", bf, bf)

    def _cbn(self, name, h, act):
        h = getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(h))
        return F.silu(h) if act else h

    def forward(self, x):
        cin = x.shape[1]
        if self.stride > 1:
            b1 = self._cbn("b1_pw", self._cbn("b1_dw", x, False), True)
            b2 = self._cbn("b2_pw1", x, True)
        else:
            b1, b2 = x[:, :cin // 2], self._cbn("b2_pw1", x[:, cin // 2:],
                                                 True)
        b2 = self._cbn("b2_pw2", self._cbn("b2_dw", b2, False), True)
        out = torch.cat([b1, b2.to(b1.dtype)], dim=1)
        # the shuffle of two groups: channel g·c/2 + j → 2·j + g
        b, c, h, w = out.shape
        return out.view(b, 2, c // 2, h, w).transpose(1, 2).reshape(b, c, h, w)


# the bundled face-detector graphs (the numbers of models/yolov5l.yaml and
# models/yolov5n.yaml, [from, number, module, args])
YOLOV5_FACE_ANCHORS = (
    (4, 5, 8, 10, 13, 16),
    (23, 29, 43, 55, 73, 105),
    (146, 217, 231, 300, 335, 433),
)

YOLOV5L_FACE_CFG = {
    "nc": 1, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": YOLOV5_FACE_ANCHORS,
    "backbone": [
        [-1, 1, "StemBlock", [64, 3, 2]],
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 9, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],
        [-1, 9, "C3", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],
        [-1, 1, "SPP", [1024, [3, 5, 7]]],
        [-1, 3, "C3", [1024, False]],
    ],
    "head": [
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
        [[-1, 5], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
        [[-1, 3], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 13], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 9], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],
        [[16, 19, 22], 1, "Detect", []],
    ],
}

YOLOV5N_FACE_CFG = {
    "nc": 1, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": YOLOV5_FACE_ANCHORS,
    "backbone": [
        [-1, 1, "StemBlock", [32, 3, 2]],
        [-1, 1, "ShuffleV2Block", [128, 2]],
        [-1, 3, "ShuffleV2Block", [128, 1]],
        [-1, 1, "ShuffleV2Block", [256, 2]],
        [-1, 7, "ShuffleV2Block", [256, 1]],
        [-1, 1, "ShuffleV2Block", [512, 2]],
        [-1, 3, "ShuffleV2Block", [512, 1]],
    ],
    "head": [
        [-1, 1, "Conv", [128, 1, 1]],
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 1, "C3", [128, False]],
        [-1, 1, "Conv", [128, 1, 1]],
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
        [[-1, 2], 1, "Concat", [1]],
        [-1, 1, "C3", [128, False]],
        [-1, 1, "Conv", [128, 3, 2]],
        [[-1, 11], 1, "Concat", [1]],
        [-1, 1, "C3", [128, False]],
        [-1, 1, "Conv", [128, 3, 2]],
        [[-1, 7], 1, "Concat", [1]],
        [-1, 1, "C3", [128, False]],
        [[14, 17, 20], 1, "Detect", []],
    ],
}


def load_yolo_yaml(path: str) -> dict:
    """A yolov5face model YAML (models/yolov5{l,n}.yaml) → the config dict
    :class:`YOLOv5FromConfig` takes. Needs pyyaml, imported here only."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    # Detect's ['nc', 'anchors'] placeholders resolve to the cfg fields
    for rows in (raw["backbone"], raw["head"]):
        for r in rows:
            if str(r[2]) == "Detect":
                r[3] = []
    return {
        "nc": raw.get("nc", 1),
        "depth_multiple": raw.get("depth_multiple", 1.0),
        "width_multiple": raw.get("width_multiple", 1.0),
        "anchors": tuple(tuple(a) for a in raw["anchors"]),
        "backbone": raw["backbone"],
        "head": raw["head"],
    }


def layer_name(li: int, mod: str) -> str:
    """The flax scope of layer ``li`` of a config."""
    return f"l{li}_{mod.replace('.', '_').lower()}"


class YOLOv5FromConfig(nn.Module):
    """The yolov5face graph interpreter (models/yolo.py:95-235
    parse_model): walks the [from, number, module, args] backbone and head
    lists, keeping every layer's output for the skips. Returns the raw
    detect maps [(B, na·no, Hi, Wi)]."""

    def __init__(self, cfg: Any, dtype=torch.float32):
        super().__init__()
        cfg = dict(cfg)
        gd, gw = cfg["depth_multiple"], cfg["width_multiple"]
        na = len(cfg["anchors"][0]) // 2
        no = cfg["nc"] + 5 + 10        # box (4) + obj (1) + landmarks (10)

        def cdepth(n):
            return max(round(n * gd), 1) if n > 1 else n

        def cwidth(c):
            return c if gw == 1.0 else int(math.ceil(c * gw / 8) * 8)

        self.layers = []    # (from, module, repeats, name)
        chs = []            # each layer's output channels

        def ch_of(f):
            return (chs[-1] if chs else 3) if f == -1 else chs[f]

        detect_from = None
        for li, (frm, num, mod, args) in enumerate(
                list(cfg["backbone"]) + list(cfg["head"])):
            mod = str(mod)
            num = cdepth(num)
            name = layer_name(li, mod)
            cin = (ch_of(frm) if isinstance(frm, int)
                   else [ch_of(f) for f in frm])
            if mod == "StemBlock":
                cout = cwidth(args[0])
                self.add_module(name, StemBlock(cin, cout, dtype))
            elif mod == "Conv":
                cout = cwidth(args[0])
                k = args[1] if len(args) > 1 else 1
                s = args[2] if len(args) > 2 else 1
                self.add_module(name, YConv(cin, cout, k, s, dtype))
            elif mod == "C3":
                cout = cwidth(args[0])
                shortcut = args[1] if len(args) > 1 else True
                self.add_module(name, C3(cin, cout, num, shortcut, dtype))
            elif mod == "SPP":
                cout = cwidth(args[0])
                self.add_module(name, SPP(cin, cout, tuple(args[1]), dtype))
            elif mod == "ShuffleV2Block":
                cout = cwidth(args[0])
                for ni in range(num):   # repeats share args (parse_model)
                    self.add_module(f"{name}_{ni}", ShuffleV2Block(
                        cin if ni == 0 else cout, cout, args[1], dtype))
            elif mod == "nn.Upsample":
                cout = cin
            elif mod == "Concat":
                cout = sum(cin)
            elif mod == "Detect":
                detect_from = list(frm)
                for i, c in enumerate(cin):
                    self.add_module(f"detect{i}", Conv2d(c, na * no, 1,
                                                         dtype=dtype))
                cout = cin[-1]
            else:
                raise ValueError(f"unknown module in config: {mod}")
            self.layers.append((frm, mod, num, name, args))
            chs.append(cout)
        if detect_from is None:
            raise ValueError("config has no Detect layer")

    def forward(self, x):
        ys = []

        def get(f):
            return (ys[-1] if ys else x) if f == -1 else ys[f]

        outs = None
        for frm, mod, num, name, args in self.layers:
            inp = get(frm) if isinstance(frm, int) else [get(f) for f in frm]
            if mod == "ShuffleV2Block":
                y = inp
                for ni in range(num):
                    y = getattr(self, f"{name}_{ni}")(y)
            elif mod == "nn.Upsample":
                y = _up(inp, int(args[1]))
            elif mod == "Concat":
                y = torch.cat(inp, dim=1)
            elif mod == "Detect":
                outs = [getattr(self, f"detect{i}")(f)
                        for i, f in enumerate(inp)]
                y = inp[-1]
            else:
                y = getattr(self, name)(inp)
            ys.append(y)
        return outs
