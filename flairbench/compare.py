"""The comparison that decides ``correct``.

The timed window records, at fixed denoiser calls of the first two
windows, the state that enters a call (x) and what the call returned
(the denoiser's output). Once the window has closed and the program is
freed, the frozen float32 reference works out again, from the seed, the
weights, the clip, the conditioning, the flows and the window-start noise,
and reads six numbers, each the worst frame's relative L2 gap:

- ``start_w1`` / ``start_w2``: the state entering a window's first call
  against q_sample of the reference's conditioning;
- ``eps_w1`` / ``eps_w2``: the denoiser output at a call drawn from the
  seed in window 1 and at window 2's first call, against the reference
  denoiser on the same x;
- ``step_w1`` / ``step_w2``: the state entering the next call against the
  reference's guided step from the program's x and output (the program's
  own state, followed step by step); window 2's step pins the overlap to
  the reference's last step of window 1, taken from the program's x and
  output at that step.

With the face prior on, the reference denoiser takes the VSR++ weights
it works out from the program's ParseNet logits on the init frames, the
reference step fuses the program's restored faces (FLAIR's paste,
``reference/face.py``), and two more numbers are read:

- ``face_w1`` / ``face_w2``: the worst of the gaps in a window's face
  work: at each recorded call, the program's crop against the reference's
  crop of its own x0 (infinite where one side runs the face prior at a
  step and the other does not), the program's VSR++ weights against the
  reference's; and, where the configuration names reference face
  networks, their outputs on the program's recorded inputs against the
  program's.

``lower=True`` reads the control instead: the reference in the nearest
precision below the configuration's, put in the program's place.
"""

from __future__ import annotations

import contextlib

import torch

from .inputs import FACE_NETS, FACE_WEIGHTS, Noise, fill_weights
from .reference import face as face_ref
from .reference.guidance import Guidance, init_frames
from .reference.nn import set_precision
from .roofline import reference_class


def plan(n: int, seed: int) -> dict:
    """The recorded calls for ``n`` denoiser calls a window: the window-1
    call s drawn from the seed, and the calls around the window boundary.
    The window stays open at least until call n + 1 has its x."""
    s = int(torch.randint(0, n - 1, (1,), generator=torch.Generator()
                          .manual_seed(seed % (2 ** 63))))
    return {"s": s, "x": sorted({0, s, s + 1, n - 1, n, n + 1}),
            "out": sorted({s, n - 1, n}), "min_calls": n + 1}


def rel(a: torch.Tensor, r: torch.Tensor) -> float:
    """The worst frame's ||a − r|| / ||r|| over (B, T, ...) tensors."""
    d = (a.float() - r.float()).flatten(2).norm(dim=2)
    return float((d / r.float().flatten(2).norm(dim=2).clamp(min=1e-30)).max())


def rel_images(a: torch.Tensor, r: torch.Tensor) -> float:
    """``rel`` over (N, ...) tensors, one image a row."""
    return rel(a.reshape(1, len(a), -1), r.reshape(1, len(r), -1))


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class FacePrior:
    """The reference's side of a face-on window: the configuration's
    frame → face matrix for each of the ``frames`` images, its reference
    face networks (where named, their weights drawn again from the seed),
    and the program's recorded face tensors ``rec`` by kind and call."""

    def __init__(self, config, seed, rec, frames, dev):
        spec = config["face"]
        self.size = config["output_size"]
        self.mats = torch.tensor(spec["matrix"], dtype=torch.float32,
                                 device=dev).expand(frames, 2, 3)
        self.parser = spec.get("parsenet") is not None
        self.bg_weight = face_ref.TASKS[config["task"]][2]
        self.nets = {}
        for i, name in enumerate(FACE_NETS):
            entry = spec.get(name)
            if entry is not None and entry.get("reference"):
                with torch.device("meta"):
                    net = reference_class(entry)(**entry["kwargs"])
                fill_weights(net, seed, dev, FACE_WEIGHTS, i)
                self.nets[name] = net
        self.rec = {kind: {k: v.to(dev) for k, v in rec.get(kind, {}).items()}
                    for kind in ("weights", "crop", "restored", "parse",
                                 "init_parse")}

    def weights(self, logits, shape):
        """FLAIR's VSR++ weights (video_sample.py:427-444) from ParseNet's
        logits of the init frames: the task's background weight where
        class 0 wins, 1 elsewhere; None without a parser or logits."""
        if not self.parser or logits is None:
            return None
        w = torch.ones(logits.shape[:-1], device=logits.device)
        w[logits.argmax(-1) == 0] = self.bg_weight
        return w.reshape(*shape[:4], 1)

    def net(self, name, faces, lower):
        """The reference network ``name`` on the program's ``faces``, one
        precision lower for the control."""
        net = self.nets[name]
        set_precision(net, lower)
        out = face_ref.APPLY[name](net, faces)
        set_precision(net, False)
        return out

    def crop(self, x0):
        """The faces of (B, T, H, W, 3) frames, (B·T, S, S, 3)."""
        return face_ref.crop(x0.reshape(-1, *x0.shape[2:]), self.mats,
                             self.size)

    def step(self, k, low=lambda v: v):
        """What the reference step fuses after call ``k``: the program's
        restored faces, their logits and the matrices; None where the
        program ran no face prior there."""
        restored = self.rec["restored"].get(k)
        if restored is None:
            return None
        logits = self.rec["parse"].get(k)
        return (low(restored), None if logits is None else low(logits),
                self.mats)


def readings(config, traffic, seed, clip, rec, p, device, lower=False):
    """The numbers of one run: the program's recorded tensors ``rec``
    ({kind: {call: tensor}}, ``harness.Window.buffers``) against the
    reference, or, with ``lower``, the control against the reference on
    the same inputs."""
    dev = torch.device(device)
    n = int(config["steps"][len("ddim"):])
    win, ov = traffic["window"], traffic["overlap"]
    size = config["output_size"]
    cls = reference_class(config)
    with torch.device("meta"):
        ref = cls(**config["model_kwargs"])
    fill_weights(ref, seed, dev)
    g = Guidance(config["task"], config["steps"], size, dev)
    frames = torch.as_tensor(clip, device=dev)
    noise = Noise(seed, dev)
    x = {k: v.to(dev) for k, v in rec["x"].items()}
    out = {k: v.to(dev) for k, v in rec["out"].items()}
    face = (FacePrior(config, seed, rec, frames.shape[0] * win, dev)
            if config.get("face_prior") else None)

    def cond(t):
        v = (g.acp[t] ** 0.5 if cls.CONDITIONING == "noise_level"
             else int(g.timestep_map[t]))
        return torch.full(frames.shape[:1] + (win,), v, device=dev,
                          dtype=torch.float32 if isinstance(v, float)
                          else torch.int64)

    def low(v):
        return v.bfloat16() if lower else v

    vals = {}
    with torch.no_grad(), no_tf32():
        for w, (k0, s) in enumerate(((0, p["s"]), (n, n))):
            sl = frames[:, w * (win - ov):w * (win - ov) + win]
            init, rnn = init_frames(sl, config["task"], size)
            y = (sl * 2 - 1).reshape(-1, *sl.shape[2:])
            z = noise.draw(init.shape, w * (n + 1))
            start = g.start(init, z)
            if lower:
                i_low, _ = init_frames(low(sl), config["task"], size)
                vals[f"start_w{w + 1}"] = rel(g.start(i_low, low(z)), start)
            else:
                vals[f"start_w{w + 1}"] = rel(x[k0], start)
            t = n - 1 - s % n
            kw = {}
            if face is not None:
                logits = face.rec["init_parse"].get(k0)
                wts = face.weights(logits, init.shape)
                if wts is not None:
                    kw["weights"] = wts
                vals[f"face_w{w + 1}"] = face_gaps(
                    face, g, x, out, p, w, s, init, y, logits, wts, lower)
            flows = ref.flows(rnn)
            eps = ref(x[s], cond(t), init, flows, **kw)
            side = out[s]
            if lower:
                set_precision(ref, True)
                side = ref(x[s], cond(t), init, flows, **kw)
                set_precision(ref, False)
            vals[f"eps_w{w + 1}"] = rel(side, eps)
            del flows, eps, side
            pins = None
            if w:
                last = g.update(x[n - 1], out[n - 1], 0, y_w1,
                                face=face and face.step(n - 1))
                pins = last[:, win - ov:win]
            step = g.update(x[s], out[s], t, y, pins, face=face and face.step(s))
            if lower:
                lp = None if pins is None else low(pins)
                step_low = g.update(low(x[s]), low(out[s]), t, low(y), lp,
                                    face=face and face.step(s, low))
                vals[f"step_w{w + 1}"] = rel(step_low, step)
            else:
                vals[f"step_w{w + 1}"] = rel(x[s + 1], step)
            y_w1 = y
    return vals


def face_gaps(face, g, x, out, p, w, s, init, y, logits, wts, lower):
    """``face_w<w + 1>``: the worst gap of window ``w``'s face work (the
    module's docstring); the control's where ``lower``, on the same
    program inputs."""
    inf = float("inf")
    rec, n = face.rec, len(g.acp)
    gaps = [0.0]
    if face.parser:
        if wts is None:          # the program parsed no init frames
            side = None
        elif lower:
            side = face.weights(logits.bfloat16(), init.shape)
        else:
            side = rec["weights"].get(s)
        gaps.append(inf if side is None else rel(side, wts))
    for k in (k for k in p["out"] if k // n == w):
        t = n - 1 - k % n
        crop = rec["crop"].get(k)
        if g.in_face_window(t) != (crop is not None):
            gaps.append(inf)     # one side runs the face prior, one not
            continue
        if crop is None:
            continue
        ref_crop = face.crop(g.x0(x[k], out[k], t, y))
        if lower:
            crop = face.crop(g.x0(x[k].bfloat16(), out[k].bfloat16(), t,
                                  y.bfloat16()))
        gaps.append(rel_images(crop, ref_crop))
        restored = rec["restored"].get(k)
        for name, inp, got in (("codeformer", crop, restored),
                               ("parsenet", restored, rec["parse"].get(k))):
            if name in face.nets and inp is not None:
                side = face.net(name, inp, True) if lower else got
                gaps.append(inf if side is None else rel_images(
                    side, face.net(name, inp, False)))
    if "parsenet" in face.nets:
        frames = init.reshape(-1, *init.shape[2:])
        side = face.net("parsenet", frames, True) if lower else logits
        gaps.append(inf if side is None else rel_images(
            side, face.net("parsenet", frames, False)))
    return max(gaps)


def verdict(vals: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for each number, its limit by kind."""
    return {k: {"value": v, "limit": limits[k.split("_")[0]]}
            for k, v in vals.items()}
