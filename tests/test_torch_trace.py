"""The port's host spans (``flair_tpu_torch.utils.spans``): off is one
shared no-op, on records names, parents and nesting on the profiler's
clock, and ``restore_video`` on the goldens' small x8 and gaussian
configurations records one span per layer boundary without changing a
single output bit."""

import collections

import numpy as np
import pytest
import torch

from flair_tpu_torch.utils import spans
from test_torch_goldens import golden_program


@pytest.fixture(autouse=True)
def _recording_off():
    spans.stop()
    yield
    spans.stop()


def test_off_is_the_shared_noop_and_records_nothing():
    a, b = spans.span("denoiser"), spans.span("update")
    assert a is b
    with a:
        with b:
            pass
    spans.start()
    assert spans.stop() == []


def test_on_records_names_parents_and_nesting():
    spans.start()
    with spans.span("window"):
        with spans.span("prep"):
            pass
        with spans.span("denoiser"):
            with spans.span("resnet"):
                pass
    with pytest.raises(KeyError):
        with spans.span("update"):
            raise KeyError
    records = spans.stop()
    assert [(n, p) for n, p, _, _ in records] == [
        ("window", -1), ("prep", 0), ("denoiser", 0), ("resnet", 2),
        ("update", -1)]
    for name, parent, t0, t1 in records:
        assert t0 <= t1
        if parent >= 0:
            assert records[parent][2] <= t0 and t1 <= records[parent][3]
    assert records[1][3] <= records[2][2]
    # a new recording starts empty
    spans.start()
    with spans.span("window"):
        pass
    assert [r[:2] for r in spans.stop()] == [("window", -1)]
    assert spans.stop() == []


def test_span_stamps_share_the_profilers_clock():
    a = torch.randn(96, 96)
    spans.start()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("denoiser"):
            a @ a
    (_, _, t0, t1), = spans.stop()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert t0 <= e.start_ns() <= e.end_ns() <= t1


def _descendants(records, i):
    """Names of the spans under record ``i``."""
    out, under = [], {i}
    for j in range(i + 1, len(records)):
        if records[j][1] in under:
            under.add(j)
            out.append(records[j][0])
    return out


@pytest.mark.parametrize("gold_name", ["x8_s64", "gaussian_s64"])
def test_restore_video_spans_count_and_change_nothing(gold_name):
    from flair_tpu_torch.models.blocks import (
        AttentionBlock, ResBlock, SR3ResnetBlock, SR3SelfAttention)
    from flair_tpu_torch.models.temporal import (
        TemporalAttention, TemporalWrapper2)
    from flair_tpu_torch.models.vsrpp import BasicVSRPP
    from flair_tpu_torch.pipeline.video import restore_video, window_slices

    clip, cfg, apply, kw = golden_program(gold_name)
    off = restore_video(clip, cfg, apply, **kw)
    spans.start()
    on = restore_video(clip, cfg, apply, **kw)
    records = spans.stop()
    assert np.array_equal(on, off)

    names = collections.Counter(r[0] for r in records)
    windows = len(window_slices(len(clip), kw["win"], kw["overlap"]))
    steps = int(cfg.steps)
    assert names["window"] == names["prep"] == windows
    assert names["denoiser"] == names["update"] == windows * steps
    for name, parent, _, _ in records:
        if name in ("prep", "denoiser", "update"):
            assert records[parent][0] == "window"

    modules = collections.Counter()
    for m in apply.model.modules():
        if isinstance(m, BasicVSRPP):
            modules["vsrpp"] += 1
        elif isinstance(m, (AttentionBlock, SR3SelfAttention)):
            modules["attention"] += 1
        elif isinstance(m, (TemporalAttention, TemporalWrapper2)):
            modules["temporal"] += 1
        elif isinstance(m, ResBlock):
            modules["temporal" if m.dims == 3 else "resnet"] += 1
        elif isinstance(m, SR3ResnetBlock):
            modules["resnet"] += 1
    assert modules["vsrpp"] and modules["temporal"] and modules["resnet"]
    assert bool(modules["attention"]) == ("gaussian" in gold_name)
    # every window here has more than one frame, so each cross-frame
    # module runs once a call
    assert all(length > 1 for _, length in window_slices(
        len(clip), kw["win"], kw["overlap"]))
    calls = [i for i, r in enumerate(records) if r[0] == "denoiser"]
    for i in calls:
        inside = collections.Counter(_descendants(records, i))
        assert inside == modules, (inside, modules)
