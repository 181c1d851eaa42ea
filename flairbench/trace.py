"""Reduction of one traced window (its device operations as
``join.events_of`` gives them) to what the per-layer metrics read:
device time by kernel and by class, launches, the busy union, and the
idle gaps named by what the harness was driving.

The profiler records device activity only (``torch.profiler`` with the
CUDA activity, kept in memory): recording every host operation as well
slowed the x8 window by ~14 %. The harness's CUDA events give each
denoiser call's span on the same device timeline, relative to an event
recorded at the window's start; the first device operation of the window
follows that event by the host's launch latency, and the spans are placed
from it."""

from __future__ import annotations

from .roofline import kernel_class


def gap_label(mid_ms, calls, steps):
    """What the harness drove at ``mid_ms`` after the window's start:
    ``calls`` lists each call's (start_ms, end_ms); a call k with
    k % steps == 0 starts a window."""
    before = [k for k, (s, _) in enumerate(calls) if s <= mid_ms]
    if not before:
        return "window prep before call 0"
    k = before[-1]
    if mid_ms <= calls[k][1]:
        return f"denoiser call {k}"
    if k + 1 == len(calls):
        return f"window close after call {k}"
    if (k + 1) % steps == 0:
        return f"window prep before call {k + 1}"
    return f"update after call {k}"


def reduce(ops, calls, window_s: float, steps: int) -> dict:
    """Kernels, busy time and idle gaps of the window's device
    operations; ``calls`` as ``gap_label`` takes them."""
    ops = sorted((s, e, n) for n, s, e in ops)
    origin = ops[0][0] if ops else 0
    end = origin + window_s * 1e9
    kernels, gaps, busy, cursor = {}, [], 0, origin
    for s, e, n in ops:
        if not n.startswith(("Memcpy", "Memset")):
            rec = kernels.setdefault(n, [0.0, 0])
            rec[0] += (e - s) / 1e9
            rec[1] += 1
        if s > cursor:
            gaps.append((s - cursor, cursor, s))
        busy += max(0, e - max(s, cursor))
        cursor = max(cursor, e)
    if end > cursor:
        gaps.append((end - cursor, cursor, end))
    classes = {}
    for n, (sec, _) in kernels.items():
        c = kernel_class(n)
        classes[c] = classes.get(c, 0.0) + sec
    gaps.sort(reverse=True)
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "window_s": window_s, "busy_s": busy / 1e9,
        "kernels": kernels, "classes": classes,
        "breakdown": {
            "device_ops": [[f"{kernel_class(n)}: {n[:120]}", sec]
                           for n, (sec, _) in top_ops],
            "idle_gaps": [[gap_label(((a + b) / 2 - origin) / 1e6, calls,
                                     steps), g / 1e9]
                          for g, a, b in gaps[:10]]}}
