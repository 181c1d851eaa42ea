"""Host spans at the port's layer boundaries, kept in memory.

``with span("denoiser"): ...`` marks a stretch of host code. While
recording is off (the default) ``span`` returns one shared no-op object:
no allocation, no clock read. Python code switches recording on:

    from flair_tpu_torch.utils import spans
    spans.start()
    ...                      # restore_video, a training step, ...
    records = spans.stop()

Each record is ``(name, parent_index, t0_ns, t1_ns)``, in the order the
spans were entered; ``parent_index`` is the index of the innermost span
open at entry, or -1. Both stamps are ``time.time_ns()``, the Unix-epoch
clock ``torch.profiler`` stamps its events with, so a kernel's launch
event falls inside the span that launched it. Spans are recorded on the
thread that runs the model; ``start`` and ``stop`` are called outside any
span.

The spans and what reads them (``flairbench``'s per-layer metrics):
``model.build`` (``models/registry.get_model``), ``kernels.load``
(``utils/build.load``), ``window`` and ``prep`` (``pipeline/video``),
``denoiser`` (``pipeline/wrappers``), ``update``
(``diffusion/sampler.guided_sample_steps``), ``resnet``, ``temporal``,
``vsrpp`` and ``attention`` (``models/blocks``, ``models/temporal``,
``models/vsrpp``).
"""

from __future__ import annotations

import time

_records = None      # the open recording's list, or None while off
_open: list = []     # indices of the spans open now, innermost last


class _Off:
    """The shared span of a switched-off recorder."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "records", "index")

    def __init__(self, name: str, records: list):
        self.name, self.records = name, records

    def __enter__(self):
        self.index = len(self.records)
        self.records.append([self.name, _open[-1] if _open else -1,
                             time.time_ns(), 0])
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        self.records[self.index][3] = time.time_ns()
        if _open and _open[-1] == self.index:
            _open.pop()
        return False


def span(name: str):
    """A context manager marking ``name``'s host stretch."""
    if _records is None:
        return _OFF
    return _Span(name, _records)


def start() -> None:
    """Switch recording on, with an empty list."""
    global _records
    _records = []
    _open.clear()


def stop() -> list:
    """Switch recording off and return its records."""
    global _records
    records, _records = _records or [], None
    _open.clear()
    return [tuple(r) for r in records]
