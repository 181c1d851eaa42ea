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
``reference/face.py``), and more numbers are read, each the worst over a
window's recorded face calls:

- ``face_w1`` / ``face_w2``: the program's crop against the reference's
  crop of its own x0 (infinite where one side runs the face prior at a
  step and the other does not), and the program's VSR++ weights against
  the reference's;
- where the configuration names a reference CodeFormer,
  ``codes_w1`` / ``_w2``: the program's recorded code logits against the
  reference's on the program's crop; and ``restored_w1`` / ``_w2``: the
  program's restored faces against the reference's on the program's crop
  with the program's codes (the argmax of its recorded logits, the first
  maximal index as ``torch.argmax`` takes it). Between two sound
  precisions the top two of 1 024 logits often lie closer than rounding,
  so the two sides' own argmaxes differ in some tokens, and each flip
  changes a patch of the face: compared on one set of codes, the logits
  and the generator are judged and no flip decides;
- where it names a reference ParseNet, ``parse_w1`` / ``_w2``: the
  program's logits on its restored faces and on the init frames against
  the reference's on the same inputs.

The limit of each number is its kind's (``codes_w1`` → ``limits.codes``);
``limit_kinds`` says which kinds a configuration needs.

``lower=True`` reads the control instead: the reference in the nearest
precision below the configuration's, put in the program's place, the face
networks on the program's inputs and codes.
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
    """``rel`` over (N, ...) tensors, one image a row; infinite where the
    program's tensor ``a`` is missing or has another shape."""
    if a is None or a.shape != r.shape:
        return float("inf")
    return rel(a.reshape(1, len(a), -1), r.reshape(1, len(r), -1))


def limit_kinds(config) -> set:
    """The kinds of number a configuration is compared by: each needs
    its limit under ``limits``."""
    kinds = {"start", "eps", "step"}
    if config.get("face_prior"):
        spec = config["face"]
        kinds.add("face")
        if (spec.get("codeformer") or {}).get("reference"):
            kinds |= {"codes", "restored"}
        if (spec.get("parsenet") or {}).get("reference"):
            kinds.add("parse")
    return kinds


def check_config(config, where: str) -> None:
    """Raise where a configuration lacks a limit that its numbers need,
    or names a reference CodeFormer without recording the program's code
    logits (``record.codes``)."""
    missing = limit_kinds(config) - set(config["limits"])
    if missing:
        raise ValueError(f"{where}: no limits for {sorted(missing)}")
    if "codes" in limit_kinds(config) and "codes" not in config["face"][
            "codeformer"].get("record", {}):
        raise ValueError(f"{where}: a reference CodeFormer needs the "
                         "program's code logits, record.codes")


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
                # on the device: buffers (ParseNet's running statistics)
                # keep the values they are built with
                with torch.device(dev):
                    net = reference_class(entry)(**entry["kwargs"])
                fill_weights(net, seed, dev, FACE_WEIGHTS, i)
                self.nets[name] = net
        self.rec = {kind: {k: v.to(dev) for k, v in rec.get(kind, {}).items()}
                    for kind in ("weights", "crop", "restored", "codes",
                                 "parse", "init_parse")}

    def weights(self, logits, shape):
        """FLAIR's VSR++ weights (video_sample.py:427-444) from ParseNet's
        logits of the init frames: the task's background weight where
        class 0 wins, 1 elsewhere; None without a parser or logits."""
        if not self.parser or logits is None:
            return None
        w = torch.ones(logits.shape[:-1], device=logits.device)
        w[logits.argmax(-1) == 0] = self.bg_weight
        return w.reshape(*shape[:4], 1)

    def net(self, name, faces, lower, **kw):
        """The reference network ``name`` on the program's ``faces``, one
        precision lower for the control."""
        net = self.nets[name]
        set_precision(net, lower)
        out = face_ref.APPLY[name](net, faces, **kw)
        set_precision(net, False)
        return out

    def codeformer_gaps(self, crop, logits, restored, lower):
        """(codes, restored) of one face call: the program's code logits
        and restored faces, or the control's, against the reference on
        the program's crop with the program's codes; infinite where the
        recorded logits are missing or are not (faces, tokens, codes)."""
        inf = float("inf")
        net = self.nets["codeformer"]
        if (logits is None or logits.dim() != 3 or len(logits) != len(crop)
                or logits.shape[-1] != net.idx_pred.weight.shape[0]):
            return inf, inf
        codes = logits.argmax(-1)
        try:
            ref_out, ref_logits = self.net("codeformer", crop, False,
                                           codes=codes)
        except ValueError:       # not one code a latent token
            return inf, inf
        if lower:
            restored, logits = self.net("codeformer", crop, True,
                                        codes=codes)
        return rel_images(logits, ref_logits), rel_images(restored, ref_out)

    def parse_gap(self, faces, logits, lower):
        """The program's ParseNet logits of ``faces``, or the control's,
        against the reference's."""
        if faces is None:
            return float("inf")
        ref = self.net("parsenet", faces, False)
        return rel_images(self.net("parsenet", faces, True) if lower
                          else logits, ref)

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
                vals.update(face_readings(
                    face, g, x, out, p, w, s, init, y, logits, wts, lower))
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


def face_readings(face, g, x, out, p, w, s, init, y, logits, wts,
                  lower) -> dict:
    """Window ``w``'s face numbers (the module's docstring): each kind's
    worst gap over the window's recorded face calls, 0 where the window
    recorded none; the control's where ``lower``, on the same program
    inputs."""
    inf = float("inf")
    rec, n = face.rec, len(g.acp)
    gaps = {"face": [0.0]}
    if "codeformer" in face.nets:
        gaps.update(codes=[0.0], restored=[0.0])
    if "parsenet" in face.nets:
        gaps["parse"] = [0.0]
    if face.parser:
        if wts is None:          # the program parsed no init frames
            side = None
        elif lower:
            side = face.weights(logits.bfloat16(), init.shape)
        else:
            side = rec["weights"].get(s)
        gaps["face"].append(inf if side is None else rel(side, wts))
    for k in (k for k in p["out"] if k // n == w):
        t = n - 1 - k % n
        crop = rec["crop"].get(k)
        if g.in_face_window(t) != (crop is not None):
            gaps["face"].append(inf)  # one side runs the face prior, one not
            continue
        if crop is None:
            continue
        ref_crop = face.crop(g.x0(x[k], out[k], t, y))
        side = crop
        if lower:
            side = face.crop(g.x0(x[k].bfloat16(), out[k].bfloat16(), t,
                                  y.bfloat16()))
        gaps["face"].append(rel_images(side, ref_crop))
        restored = rec["restored"].get(k)
        if "codeformer" in face.nets:
            c, r = face.codeformer_gaps(crop, rec["codes"].get(k), restored,
                                        lower)
            gaps["codes"].append(c)
            gaps["restored"].append(r)
        if "parsenet" in face.nets:
            gaps["parse"].append(face.parse_gap(
                restored, rec["parse"].get(k), lower))
    if "parsenet" in face.nets:
        gaps["parse"].append(face.parse_gap(
            init.reshape(-1, *init.shape[2:]), logits, lower))
    return {f"{kind}_w{w + 1}": max(v) for kind, v in gaps.items()}


def verdict(vals: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for each number, its limit by kind."""
    return {k: {"value": v, "limit": limits[k.split("_")[0]]}
            for k, v in vals.items()}
