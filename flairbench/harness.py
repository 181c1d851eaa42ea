"""One run of one cell: set-up, the timed window, the comparison.

The cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``configs/<config>.json``: the task, the program's model and wrapper,
its widths and dtype, the frozen reference class and the comparison's
limits) and a traffic mix (``workloads/<traffic>.json``: clips, frames,
motion, window and overlap). Per-layer metrics are the readers
``metrics/<name>.py``. A new cell, configuration or metric is new files
and entries; this file reads them by name.

The window drives ``flair_tpu_torch.pipeline.video.restore_video`` as
``python -m flair_tpu_torch.cli`` does (ddim, η = 0, face prior off)
through the harness's ``Window``, which wraps the program's
``model_apply``. It records the calls ``compare.plan`` names and closes
the window at the first denoiser call that starts past ``seconds`` (and
no earlier than that plan needs) by raising ``WindowClosed`` out of
``restore_video``; the window's one synchronize follows.
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
    with open(os.path.join(HERE, "workloads", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def steps_per_window(config) -> int:
    return int(config["steps"][len("ddim"):])


class Window:
    """The program's ``model_apply`` as ``restore_video`` calls it, with
    the harness around each call: copies of the planned calls' x and
    output into host buffers (non-blocking), the close, and with
    ``trace`` a CUDA event before and after each call."""

    def __init__(self, apply, *, seconds=0.0, min_calls=0, buffers=None,
                 trace=False):
        self.apply = apply
        self.flows_fn, self.model = apply.flows_fn, apply.model
        self.seconds, self.min_calls = seconds, min_calls
        self.buffers = buffers or {"x": {}, "out": {}}
        self.trace, self.events = trace, []
        self.calls, self.t0 = 0, None

    def __call__(self, x, t, low_res, rnn_input, vsrpp_weights, flows=None):
        k = self.calls
        if k in self.buffers["x"]:
            self.buffers["x"][k].copy_(x, non_blocking=True)
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
        self.out_shape = tuple(out.shape)
        if k in self.buffers["out"]:
            self.buffers["out"][k].copy_(out, non_blocking=True)
        self.calls += 1
        return out


def build_program(config, seed, device):
    """The program's denoiser, diffusion and task configuration as the
    CLI builds them, with the benchmark's seeded weights."""
    from flair_tpu_torch.diffusion import make_task_diffusion
    from flair_tpu_torch.models.registry import get_model
    from flair_tpu_torch.pipeline import wrappers
    from flair_tpu_torch.pipeline.video import TASK_CONFIGS
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["model_kwargs"].items()}
    with torch.device(device):
        model = get_model(config["model"], dtype=getattr(torch, config["dtype"]),
                          **kwargs)
    inputs.fill_weights(model, seed, device)
    model = model.to(device).eval()
    d = make_task_diffusion(config["task"], config["steps"], device=device)
    apply = getattr(wrappers, config["wrapper"])(d, model)
    cfg = dataclasses.replace(
        TASK_CONFIGS[config["task"]], steps=config["steps"],
        input_size=config["input_size"], output_size=config["output_size"])
    return model, d, apply, cfg


def restore(clip, cfg, d, window, traffic, noise, device):
    """``restore_video`` until ``window`` closes; returns its calls."""
    from flair_tpu_torch.pipeline.video import restore_video
    try:
        restore_video(clip, cfg, window, diffusion=d, win=traffic["window"],
                      overlap=traffic["overlap"], sampler="ddim", eta=0.0,
                      device=device, noise_fn=noise)
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
    model, d, apply, cfg = build_program(config, seed, dev)
    clip = inputs.moving_clip(seed, traffic["clips"], traffic["frames"],
                              config["input_size"], traffic["shift"])
    # warm-up: the first window's preparation and its first calls, with
    # noise of its own
    warm = Window(apply, min_calls=traffic["warmup_calls"])
    warm.t0 = time.perf_counter()
    restore(clip[:, :traffic["window"]], cfg, d, warm, traffic,
            inputs.Noise(seed + 1, dev), dev)
    sync(dev)
    p = compare.plan(n, seed)
    shape = (traffic["clips"], traffic["window"], config["output_size"],
             config["output_size"])
    host = dict(pin_memory=cuda)
    buffers = {"x": {k: torch.empty(shape + (3,), **host) for k in p["x"]},
               "out": {k: torch.empty(warm.out_shape, **host)
                       for k in p["out"]}}
    window = Window(apply, seconds=seconds, min_calls=p["min_calls"],
                    buffers=buffers, trace=trace)
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
    rec = {"plan": p, "buffers": buffers, "clip": clip}
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
        rec["spans"] = call_spans(window.events, start_ev, calls, n)
        rec["profiler"] = profiler
    del model, apply, window, warm
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
    spans, and the reference's count of one call at the cell's shapes."""
    from . import roofline, trace
    n = steps_per_window(config)
    summary = trace.reduce(trace.events_of(rec.pop("profiler")),
                           rec["spans"]["calls_ms"], rec["window_s"], n)
    summary.update(rec["spans"], steps=rec["calls"],
                   windows=-(-rec["calls"] // n),
                   **roofline.count_call(config, traffic))
    return summary
