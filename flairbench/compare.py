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

``lower=True`` reads the control instead: the reference in the nearest
precision below the configuration's, put in the program's place.
"""

from __future__ import annotations

import contextlib

import torch

from .inputs import Noise, fill_weights
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


def readings(config, traffic, seed, clip, rec, p, device, lower=False):
    """The six numbers of one run: the program's recorded tensors ``rec``
    ({"x": {k: tensor}, "out": {k: tensor}}) against the reference, or,
    with ``lower``, the control against the reference on the same
    inputs."""
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
            flows = ref.flows(rnn)
            eps = ref(x[s], cond(t), init, flows)
            if lower:
                set_precision(ref, True)
                vals[f"eps_w{w + 1}"] = rel(ref(x[s], cond(t), init, flows),
                                            eps)
                set_precision(ref, False)
            else:
                vals[f"eps_w{w + 1}"] = rel(out[s], eps)
            del flows, eps
            pins = None
            if w:
                last = g.update(x[n - 1], out[n - 1], 0, y_w1)
                pins = last[:, win - ov:win]
            step = g.update(x[s], out[s], t, y, pins)
            if lower:
                lp = None if pins is None else low(pins)
                step_low = g.update(low(x[s]), low(out[s]), t, low(y), lp)
                vals[f"step_w{w + 1}"] = rel(step_low, step)
            else:
                vals[f"step_w{w + 1}"] = rel(x[s + 1], step)
            y_w1 = y
    return vals


def verdict(vals: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for each number, its limit by kind."""
    return {k: {"value": v, "limit": limits[k.split("_")[0]]}
            for k, v in vals.items()}
