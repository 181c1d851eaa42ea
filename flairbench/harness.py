"""One run of one cell: set-up, the timed window, the comparison.

The cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``configs/<config>.json``: the task, the program's model and wrapper,
its widths and dtype, the frozen reference class and the comparison's
limits) and a traffic mix (``workloads/<traffic>.json``: clips, frames,
motion, window and overlap). Per-layer metrics are the readers
``metrics/<name>.py``. A new cell, configuration or metric is new files
and entries; this file reads them by name.

The window drives ``flair_tpu_torch.pipeline.video.restore_video`` as
``python -m flair_tpu_torch.cli`` does (ddim, η = 0) through the
harness's ``Window``, which wraps the program's ``model_apply``. It
records the calls ``compare.plan`` names and closes the window at the
first denoiser call that starts past ``seconds`` (and no earlier than
that plan needs) by raising ``WindowClosed`` out of ``restore_video``; the
window's one synchronize follows.

A configuration with ``"face_prior": true`` runs FLAIR's face prior as
the CLI does, its networks named by the configuration's ``face`` object
(``build_face``), with ``FixedFace`` in RetinaFace's place. The window
then also records, at the planned calls, the VSR++ weights the denoiser
receives, what enters and leaves the face networks, and the outputs of
the submodules that a network's ``record`` entry names (CodeFormer's code
logits).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import os
import sys
import time

import numpy as np
import torch

from . import compare, inputs

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "flair_tpu")


class WindowClosed(Exception):
    """Raised by ``Window`` at the call that closes the timed window."""


def load_cell(name: str):
    """(benchmark, cell, config, traffic) of the cell ``name``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    compare.check_config(config, entry["file"])
    with open(os.path.join(HERE, "workloads", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def steps_per_window(config) -> int:
    return int(config["steps"][len("ddim"):])


class Window:
    """The program's ``model_apply`` as ``restore_video`` calls it, with
    the harness around each call: copies of the planned calls' tensors
    into host buffers (non-blocking), the close, and with ``trace`` a
    CUDA event before and after each call.

    ``slots``: {kind: {call: pinned host tensor}}, the planned copies;
    ``buffers`` holds those written, by kind and call: ``x`` entering a
    call, its ``out``, the VSR++ ``weights`` it received; with ``face``
    (``build_face``'s ``Face``), the ``crop`` entering CodeFormer,
    CodeFormer's output (``restored``), its code logits (``codes``, by
    the configuration's ``record``) and ParseNet's logits on its output
    (``parse``) in the update after a call, and ParseNet's logits on a
    window's init frames (``init_parse``), keyed by the window's first
    call. ``shapes`` keeps each kind's last shape."""

    def __init__(self, apply, *, seconds=0.0, min_calls=0, slots=None,
                 trace=False, face=None):
        self.apply = apply
        self.flows_fn, self.model = apply.flows_fn, apply.model
        self.seconds, self.min_calls = seconds, min_calls
        self.slots = slots or {}
        self.buffers = {kind: {} for kind in self.slots}
        self.shapes = {}
        self.trace, self.events = trace, []
        self.calls, self.t0 = 0, None
        self.face, self.face_call = face, None
        if face is not None:
            face.window = self

    def record(self, kind, k, v):
        self.shapes[kind] = tuple(v.shape)
        buf = self.slots.get(kind, {}).get(k)
        if buf is not None:
            buf.copy_(v, non_blocking=True)
            self.buffers[kind][k] = buf

    def __call__(self, x, t, low_res, rnn_input, vsrpp_weights, flows=None):
        k = self.calls
        self.record("x", k, x)
        if (k >= self.min_calls
                and time.perf_counter() - self.t0 >= self.seconds):
            raise WindowClosed
        if self.trace:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            self.events.append(ev)
            ev[0].record()
        out = self.apply(x, t, low_res, rnn_input, vsrpp_weights, flows)
        if self.trace:
            ev[1].record()
        self.record("out", k, out)
        if vsrpp_weights is not None:
            self.record("weights", k, vsrpp_weights)
        self.calls += 1
        return out

    def codeformer(self, faces):
        """CodeFormer in the update after the last call."""
        k = self.face_call = self.calls - 1
        self.record("crop", k, faces)
        out = self.face.codeformer(faces)
        self.record("restored", k, out)
        return out

    def parsenet(self, faces):
        """ParseNet on the faces CodeFormer just restored, or else on the
        init frames of the window whose first call is next."""
        logits = self.face.parsenet(faces)
        if self.face_call is None:
            self.record("init_parse", self.calls, logits)
        else:
            self.record("parse", self.face_call, logits)
            self.face_call = None
        return logits

    def face_keywords(self) -> dict:
        """``restore_video``'s face keywords: none with the prior off."""
        if self.face is None:
            return {}
        return {"face_helper": self.face.helper,
                "codeformer_apply": self.codeformer,
                "parsenet_apply": self.face.parsenet and self.parsenet}


class FixedFace:
    """RetinaFace's stand-in: the configuration's frame → face matrix for
    every frame. Seeded random detector weights find no reliable face, and
    detection runs once a window on the host, so the benchmark leaves it
    out."""

    def __init__(self, matrix):
        self.matrix = np.asarray(matrix, np.float32)

    def get_affine_matrices(self, frames01, **kw):
        return [self.matrix] * len(frames01)


def model_kwargs(kwargs):
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in kwargs.items()}


@dataclasses.dataclass
class Face:
    """The face prior as a window drives it: RetinaFace's stand-in, the
    networks' appliers (``parsenet`` None where the configuration names
    none), and the ``Window`` that the networks' recording hooks write
    to."""
    helper: FixedFace
    codeformer: object
    parsenet: object = None
    window: object = None

    def recorder(self, kind):
        """A forward hook that records a submodule's output as ``kind``
        under the window's face call (none outside a face call, as in
        ParseNet's pass over the init frames)."""
        def hook(module, args, out):
            w = self.window
            if w is not None and w.face_call is not None:
                w.record(kind, w.face_call, out)
        return hook


def build_face(config, seed, device) -> Face:
    """Each network of the configuration's ``face`` object by its
    registry name, keyword arguments and port wrapper, in the
    configuration's dtype, its weights drawn from a stream of its own;
    a forward hook on each submodule that its ``record`` entry names
    ({kind: submodule}), through the wrapper's ``.model``."""
    from flair_tpu_torch.models.registry import get_model
    from flair_tpu_torch.pipeline import wrappers
    spec = config["face"]
    nets, hooks = [], []
    for i, name in enumerate(inputs.FACE_NETS):
        entry = spec.get(name)
        if entry is None:
            nets.append(None)
            continue
        with torch.device(device):
            net = get_model(entry["model"],
                            dtype=getattr(torch, config["dtype"]),
                            **model_kwargs(entry["kwargs"]))
        inputs.fill_weights(net, seed, device, inputs.FACE_WEIGHTS, i)
        nets.append(getattr(wrappers, entry["wrapper"])(net.to(device).eval()))
        hooks += [(nets[-1].model.get_submodule(sub), kind)
                  for kind, sub in entry.get("record", {}).items()]
    face = Face(FixedFace(spec["matrix"]), *nets)
    for module, kind in hooks:
        module.register_forward_hook(face.recorder(kind))
    return face


def build_program(config, seed, device):
    """The program's denoiser, diffusion, task configuration and face
    prior (None with it off) as the CLI builds them, with the benchmark's
    seeded weights."""
    from flair_tpu_torch.diffusion import make_task_diffusion
    from flair_tpu_torch.models.registry import get_model
    from flair_tpu_torch.pipeline import wrappers
    from flair_tpu_torch.pipeline.video import TASK_CONFIGS, scale_tau
    with torch.device(device):
        model = get_model(config["model"], dtype=getattr(torch, config["dtype"]),
                          **model_kwargs(config["model_kwargs"]))
    inputs.fill_weights(model, seed, device)
    model = model.to(device).eval()
    d = make_task_diffusion(config["task"], config["steps"], device=device)
    apply = getattr(wrappers, config["wrapper"])(d, model)
    cfg = dataclasses.replace(
        TASK_CONFIGS[config["task"]], steps=config["steps"],
        input_size=config["input_size"], output_size=config["output_size"])
    face = None
    if config.get("face_prior"):
        face = build_face(config, seed, device)
        # the CLI keeps the demo's face window as a fraction of the schedule
        cfg = dataclasses.replace(cfg, tau=scale_tau(cfg.tau,
                                                     d.num_timesteps))
    return model, d, apply, cfg, face


def restore(clip, cfg, d, window, traffic, noise, device):
    """``restore_video`` until ``window`` closes; returns its calls."""
    from flair_tpu_torch.pipeline.video import restore_video
    try:
        restore_video(clip, cfg, window, diffusion=d, win=traffic["window"],
                      overlap=traffic["overlap"], sampler="ddim", eta=0.0,
                      device=device, noise_fn=noise, **window.face_keywords())
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the clip ended before the window closed")
    return window.calls


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(config, traffic, seed, seconds, trace, device, t_start):
    """Set-up, warm-up and the timed window. Returns the record the
    result and the comparison need; the program is freed on return."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    n = steps_per_window(config)
    model, d, apply, cfg, face = build_program(config, seed, dev)
    clip = inputs.moving_clip(seed, traffic["clips"], traffic["frames"],
                              config["input_size"], traffic["shift"])
    # warm-up: the first window's preparation and its first calls, with
    # noise of its own
    warm = Window(apply, min_calls=traffic["warmup_calls"], face=face)
    warm.t0 = time.perf_counter()
    restore(clip[:, :traffic["window"]], cfg, d, warm, traffic,
            inputs.Noise(seed + 1, dev), dev)
    sync(dev)
    p = compare.plan(n, seed)
    planned = {"x": p["x"], "out": p["out"], "weights": p["out"],
               "crop": p["out"], "restored": p["out"], "codes": p["out"],
               "parse": p["out"], "init_parse": (0, n)}
    slots = {kind: {k: torch.empty(warm.shapes[kind], pin_memory=cuda)
                    for k in keys}
             for kind, keys in planned.items() if kind in warm.shapes}
    window = Window(apply, seconds=seconds, min_calls=p["min_calls"],
                    slots=slots, trace=trace, face=face)
    prof = contextlib.nullcontext()
    if trace:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # the set-up's objects leave the collector's view, so that collections
    # inside the window scan only what the window makes
    gc.collect()
    gc.freeze()
    rec = {"plan": p, "buffers": window.buffers, "clip": clip}
    with prof as profiler:
        start_ev = None
        window.t0 = time.perf_counter()
        if trace:
            start_ev = torch.cuda.Event(enable_timing=True)
            start_ev.record()
        calls = restore(clip, cfg, d, window, traffic,
                        inputs.Noise(seed, dev), dev)
        sync(dev)
        t_end = time.perf_counter()
    rec.update(calls=calls, window_s=t_end - window.t0,
               setup_s=window.t0 - t_start,
               memory_peak_bytes=(torch.cuda.max_memory_allocated()
                                  if cuda else 0))
    if trace:
        rec["call_spans"] = call_spans(window.events, start_ev, calls, n)
        rec["profiler"] = profiler
    del model, apply, window, warm, face
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def call_spans(events, start_ev, calls, n):
    """Device-timeline ms of each call (its span from the window's start
    and its length), of each update between two calls of a window, and of
    each window's preparation (from the window's start, or from the last
    call of the window before, to the window's first call)."""
    spans = [(start_ev.elapsed_time(s), start_ev.elapsed_time(e))
             for s, e in events[:calls]]
    update, prep = [], [spans[0][0]]
    for k in range(calls - 1):
        gap = spans[k + 1][0] - spans[k][1]
        (prep if (k + 1) % n == 0 else update).append(gap)
    return {"calls_ms": spans, "unet_ms": [e - s for s, e in spans],
            "update_ms": update, "prep_ms": prep}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def end_to_end(rec, config, traffic) -> dict:
    """Every end-to-end metric the harness knows, by name."""
    n = steps_per_window(config)
    stride = traffic["window"] - traffic["overlap"]
    frames = rec["calls"] * stride / n * traffic["clips"]
    return {"frames_per_s": frames / rec["window_s"],
            "peak_mem_gib": rec["memory_peak_bytes"] / 2 ** 30,
            "setup_s": rec["setup_s"]}


def per_layer(summary, names) -> dict:
    """Each named metric's reader ``metrics/<name>.py`` on the trace
    summary; a reader that finds nothing to read returns None and its
    metric is left out."""
    out = {}
    for name in names:
        v = importlib.import_module(f"flairbench.metrics.{name}").read(
            summary)
        if v is not None:
            out[name] = v
    return out


def trace_summary(rec, config, traffic) -> dict:
    """What the per-layer readers read: the reduced trace, the calls'
    spans, the reference's count of one call at the cell's shapes, the
    cell's ``config`` and ``traffic``, and, where the run recorded the
    program's spans (``rec["span_records"]``: ``join.traced_window``'s
    set-up and window records), their numbers under ``spans``
    (``join.span_metrics``) and the join itself under ``attribution``."""
    from . import join, roofline, trace
    n = steps_per_window(config)
    ops, launches = join.events_of(rec.pop("profiler"))
    summary = trace.reduce([op[:3] for op in ops],
                           rec["call_spans"]["calls_ms"], rec["window_s"], n)
    summary.update(rec["call_spans"], steps=rec["calls"],
                   windows=-(-rec["calls"] // n), config=config,
                   traffic=traffic, **roofline.count_call(config, traffic))
    if "span_records" in rec:
        setup, window = rec["span_records"]
        att = join.attribute(ops, launches, window)
        summary.update(attribution=att, spans=join.span_metrics(
            att, join.setup_seconds(setup)))
    return summary
