"""RetinaFace face detector (torch.nn network, host numpy decode).

Counterpart of ``flair_tpu/models/retinaface.py`` (reference
facelib/detection/retinaface/*): ResNet50 or MobileNet-0.25 body → FPN →
SSH context heads → class / box / landmark 1×1 heads over 3 pyramid levels
with 2 anchors each. Priors, box and landmark decoding and NMS are host
numpy, copied from the JAX package: the face count varies by frame, so it
stays off the device. The network runs on its parameters' device in float32
with TF32 off, so the 0.8 / 0.4 thresholds select the same boxes on the card
as on the CPU.
"""

from __future__ import annotations

import math
from itertools import product

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm, Conv2d, random_init_
from .registry import register_model
from .resnet import ConvBN, resnet50

# what the detector's priors and decode read; the same for both networks
PRIOR_CFG = {
    "min_sizes": [[16, 32], [64, 128], [256, 512]],
    "steps": [8, 16, 32],
    "variance": [0.1, 0.2],
    "clip": False,
}
CFG_RESNET50 = {**PRIOR_CFG, "in_channel": 256, "out_channel": 256}
CFG_MOBILENET = {**PRIOR_CFG, "in_channel": 32, "out_channel": 64}


def _leaky(x, slope):
    return torch.where(x >= 0, x, slope * x)


class ConvBNLeaky(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, leaky: float = 0.0, relu: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.leaky, self.relu = leaky, relu
        self.cb = ConvBN(in_ch, out_ch, kernel, stride, dtype)

    def forward(self, x):
        h = self.cb(x)
        return _leaky(h, self.leaky) if self.relu else h


class SSH(nn.Module):
    """Context module: parallel 3/5/7 receptive-field branches
    (retinaface_net.py:37-64)."""

    def __init__(self, in_ch: int, out_channel: int, dtype=torch.float32):
        super().__init__()
        oc = out_channel
        leaky = 0.1 if oc <= 64 else 0.0
        self.conv3X3 = ConvBNLeaky(in_ch, oc // 2, 3, relu=False, dtype=dtype)
        self.conv5X5_1 = ConvBNLeaky(in_ch, oc // 4, 3, leaky=leaky,
                                     dtype=dtype)
        self.conv5X5_2 = ConvBNLeaky(oc // 4, oc // 4, 3, relu=False,
                                     dtype=dtype)
        self.conv7X7_2 = ConvBNLeaky(oc // 4, oc // 4, 3, leaky=leaky,
                                     dtype=dtype)
        self.conv7x7_3 = ConvBNLeaky(oc // 4, oc // 4, 3, relu=False,
                                     dtype=dtype)

    def forward(self, x):
        c3 = self.conv3X3(x)
        c5_1 = self.conv5X5_1(x)
        c5 = self.conv5X5_2(c5_1)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return F.relu(torch.cat([c3, c5, c7], dim=1))


def _up_to(src, dst):
    """Nearest upsampling of ``src`` to ``dst``'s size. The JAX FPN repeats
    by the integer ratio and crops, which fits only where the ratio is
    whole; there it equals nearest interpolation. Other sizes raise, as
    they fail in the JAX package."""
    (sh, sw), (dh, dw) = src.shape[-2:], dst.shape[-2:]
    if dh % sh or dw % sw:
        raise ValueError(f"FPN: level {sh}×{sw} does not divide {dh}×{dw}")
    return F.interpolate(src, size=(dh, dw), mode="nearest")


class FPN(nn.Module):
    """3-level top-down FPN (retinaface_net.py:67-99)."""

    def __init__(self, in_channels, out_channels: int, dtype=torch.float32):
        super().__init__()
        oc = out_channels
        leaky = 0.1 if oc <= 64 else 0.0
        for i, c in enumerate(in_channels):
            self.add_module(f"output{i + 1}",
                            ConvBNLeaky(c, oc, 1, leaky=leaky, dtype=dtype))
        self.merge1 = ConvBNLeaky(oc, oc, 3, leaky=leaky, dtype=dtype)
        self.merge2 = ConvBNLeaky(oc, oc, 3, leaky=leaky, dtype=dtype)

    def forward(self, feats):
        o1 = self.output1(feats[0])
        o2 = self.output2(feats[1])
        o3 = self.output3(feats[2])
        o2 = self.merge2(o2 + _up_to(o3, o2))
        o1 = self.merge1(o1 + _up_to(o2, o1))
        return [o1, o2, o3]


class MobileNetV1(nn.Module):
    """MobileNet-0.25 body (retinaface_net.py:102-137): the three stage
    features. Depthwise blocks are ``{name}_dw`` / ``_dwbn`` / ``_pw`` /
    ``_pwbn``, as the flax scopes."""

    # (name, out channels, stride) of each depthwise block after s1_0
    BLOCKS = ([("s1_1", 16, 1), ("s1_2", 32, 2), ("s1_3", 32, 1),
               ("s1_4", 64, 2), ("s1_5", 64, 1), ("s2_0", 128, 2)]
              + [(f"s2_{i}", 128, 1) for i in range(1, 6)]
              + [("s3_0", 256, 2), ("s3_1", 256, 1)])

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.s1_0 = ConvBNLeaky(3, 8, 3, 2, 0.1, dtype=dtype)
        cin = 8
        for name, oc, stride in self.BLOCKS:
            self.add_module(f"{name}_dw", Conv2d(
                cin, cin, 3, stride, padding=1, use_bias=False, groups=cin,
                dtype=dtype))
            self.add_module(f"{name}_dwbn", BatchNorm(cin))
            self.add_module(f"{name}_pw", Conv2d(cin, oc, 1, use_bias=False,
                                                 dtype=dtype))
            self.add_module(f"{name}_pwbn", BatchNorm(oc))
            cin = oc

    def forward(self, x):
        h = self.s1_0(x)
        feats = []
        for name, _, _ in self.BLOCKS:
            h = _leaky(getattr(self, f"{name}_dwbn")(
                getattr(self, f"{name}_dw")(h)), 0.1)
            h = _leaky(getattr(self, f"{name}_pwbn")(
                getattr(self, f"{name}_pw")(h)), 0.1)
            if name in ("s1_5", "s2_5", "s3_1"):
                feats.append(h)
        return feats


@register_model("retinaface")
class RetinaFace(nn.Module):
    """Detector network (retinaface.py:78-157). Input: (B, 3, H, W) BGR
    with the means [104, 117, 123] subtracted. Returns (loc (B, N, 4),
    conf (B, N, 2) softmaxed, landms (B, N, 10)), anchors in the JAX
    package's order (channels-last reshape of each head)."""

    def __init__(self, network: str = "resnet50", dtype=torch.float32):
        super().__init__()
        self.network = network
        cfg = CFG_RESNET50 if network == "resnet50" else CFG_MOBILENET
        oc = cfg["out_channel"]
        if network == "resnet50":
            self.body = resnet50(dtype)
        else:
            self.body = MobileNetV1(dtype)
        stage2 = cfg["in_channel"]
        self.fpn = FPN([stage2 * 2, stage2 * 4, stage2 * 8], oc, dtype)
        for i in range(3):
            self.add_module(f"ssh{i + 1}", SSH(oc, oc, dtype))
            self.add_module(f"bbox_head{i}", Conv2d(oc, 2 * 4, 1, dtype=dtype))
            self.add_module(f"class_head{i}", Conv2d(oc, 2 * 2, 1,
                                                     dtype=dtype))
            self.add_module(f"landmark_head{i}", Conv2d(oc, 2 * 10, 1,
                                                        dtype=dtype))

    def random_init(self, seed: int = 0, scale: float = 0.02) -> None:
        random_init_(self, seed, scale)

    def forward(self, x):
        feats = self.body(x)
        if self.network == "resnet50":
            feats = feats[1:]           # C3, C4, C5
        fpn = self.fpn(feats)
        locs, confs, landms = [], [], []
        for i, f in enumerate(fpn):
            f = getattr(self, f"ssh{i + 1}")(f)
            b = f.shape[0]
            for out, head, k in ((locs, "bbox_head", 4),
                                 (confs, "class_head", 2),
                                 (landms, "landmark_head", 10)):
                y = getattr(self, f"{head}{i}")(f)
                out.append(y.permute(0, 2, 3, 1).reshape(b, -1, k))
        conf = torch.softmax(torch.cat(confs, dim=1).float(), dim=-1)
        return (torch.cat(locs, dim=1).float(), conf,
                torch.cat(landms, dim=1).float())


# ---------------------------------------------------------------------------
# Host-side priors / decode / NMS (retinaface_utils.py), as in flair_tpu
# ---------------------------------------------------------------------------


def prior_boxes(cfg, image_size) -> np.ndarray:
    """Anchor centres/sizes in normalised coords (retinaface_utils.py:8-40)."""
    h, w = image_size
    anchors = []
    for k, step in enumerate(cfg["steps"]):
        fh = int(math.ceil(h / step))
        fw = int(math.ceil(w / step))
        for i, j in product(range(fh), range(fw)):
            for min_size in cfg["min_sizes"][k]:
                s_kx = min_size / w
                s_ky = min_size / h
                cx = (j + 0.5) * step / w
                cy = (i + 0.5) * step / h
                anchors.append([cx, cy, s_kx, s_ky])
    out = np.asarray(anchors, np.float32).reshape(-1, 4)
    if cfg["clip"]:
        out = np.clip(out, 0, 1)
    return out


def decode_boxes(loc: np.ndarray, priors: np.ndarray, variances) -> np.ndarray:
    """SSD box decoding → (x1, y1, x2, y2) (retinaface_utils.py:214-239)."""
    boxes = np.concatenate(
        [
            priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:],
            priors[:, 2:] * np.exp(loc[:, 2:] * variances[1]),
        ],
        axis=1,
    )
    boxes[:, :2] -= boxes[:, 2:] / 2
    boxes[:, 2:] += boxes[:, :2]
    return boxes


def decode_landms(pre: np.ndarray, priors: np.ndarray, variances) -> np.ndarray:
    """5-landmark decoding (retinaface_utils.py:265-296)."""
    out = [
        priors[:, :2] + pre[:, 2 * i:2 * i + 2] * variances[0] * priors[:, 2:]
        for i in range(5)
    ]
    return np.concatenate(out, axis=1)


def nms(dets: np.ndarray, thresh: float) -> list[int]:
    """Greedy IoU NMS (retinaface_utils.py:349-379 py_cpu_nms)."""
    x1, y1, x2, y2, scores = (dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3],
                              dets[:, 4])
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


class RetinaFaceDetector:
    """Detection: normalise → network on the model's device → decode and
    NMS on the host (retinaface.py:194-266 detect_faces semantics,
    resize = 1). ``model``: a :class:`RetinaFace` in eval mode."""

    def __init__(self, model: RetinaFace):
        self.model = model
        self.cfg = PRIOR_CFG

    @torch.no_grad()
    def network(self, x: np.ndarray):
        """(1, H, W, 3) float32 mean-subtracted BGR → (loc, conf, landms)
        float32 numpy, the network's outputs."""
        dev = next(self.model.parameters()).device
        t = torch.as_tensor(x, device=dev).permute(0, 3, 1, 2)
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            out = self.model(t)
        return tuple(o.cpu().numpy() for o in out)

    def detect_faces(
        self,
        image_bgr: np.ndarray,
        conf_threshold: float = 0.8,
        nms_threshold: float = 0.4,
    ) -> np.ndarray:
        """image_bgr: (H, W, 3) float BGR in [0, 255]. Returns
        (N, 15): x1,y1,x2,y2,score + 5 landmark (x,y) pairs."""
        h, w = image_bgr.shape[:2]
        x = image_bgr.astype(np.float32) - np.array([104.0, 117.0, 123.0])
        loc, conf, landms = self.network(x[None].astype(np.float32))
        loc = np.asarray(loc[0], np.float32)
        scores = np.asarray(conf[0, :, 1], np.float32)
        landms = np.asarray(landms[0], np.float32)

        priors = prior_boxes(self.cfg, (h, w))
        boxes = decode_boxes(loc, priors, self.cfg["variance"]) * np.array(
            [w, h, w, h], np.float32
        )
        lm = decode_landms(landms, priors, self.cfg["variance"]) * np.array(
            [w, h] * 5, np.float32
        )

        inds = scores > conf_threshold
        boxes, lm, scores = boxes[inds], lm[inds], scores[inds]
        order = scores.argsort()[::-1]
        boxes, lm, scores = boxes[order], lm[order], scores[order]
        dets = np.hstack([boxes, scores[:, None]]).astype(np.float32)
        keep = nms(dets, nms_threshold)
        return np.concatenate([dets[keep], lm[keep]], axis=1)
