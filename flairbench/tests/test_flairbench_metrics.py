"""The benchmark's arithmetic on synthetic inputs: the end-to-end rate,
the bound functions against ``chip_smoke.py``'s values, the FLOP count at
both cells' shapes, the trace reduction and the per-layer readers."""

import importlib

import pytest

from flairbench import harness, roofline, trace

CONFIG = {"steps": "ddim25"}
TRAFFIC = {"window": 10, "overlap": 3, "clips": 1}


def test_frames_per_s_counts_seven_25ths_a_call():
    rec = {"calls": 50, "window_s": 35.0, "memory_peak_bytes": 2 ** 33,
           "setup_s": 12.5}
    e2e = harness.end_to_end(rec, CONFIG, TRAFFIC)
    assert e2e == pytest.approx({"frames_per_s": 50 * 7 / 25 / 35.0,
                                 "peak_mem_gib": 8.0, "setup_s": 12.5})


@pytest.mark.parametrize("shape,ms,binds", [
    ((512, 128, 64), 0.0990, "bytes"), ((256, 256, 128), 0.0391,
                                        "operations")])
def test_dcn_bound_matches_chip_smoke(shape, ms, binds):
    got, what = roofline.dcn_bound_ms(*shape, 2)
    assert round(got, 4) == ms and what == binds


@pytest.mark.parametrize("bh,s,ms", [(40, 1024, 0.0109), (80, 256, 0.00313),
                                     (80, 64, 0.00078)])
def test_flash_bound_matches_chip_smoke(bh, s, ms):
    assert roofline.flash_bound_ms(bh, s, 64, 2)[0] == pytest.approx(
        ms, rel=5e-3)


@pytest.mark.parametrize("cell,tflop,k1,k2", [
    ("x8_window", 58.57, 108, 0), ("gaussian_window", 94.87, 180, 16)])
def test_meta_count_at_the_cell_shapes(cell, tflop, k1, k2):
    _, _, config, traffic = harness.load_cell(cell)
    c = roofline.count_call(config, traffic)
    assert c["flops_call"] / 1e12 == pytest.approx(tflop, rel=1e-3)
    assert c["flops_window"] / 1e12 == pytest.approx(3.772, rel=1e-3)
    assert (c["k1_sites"], c["k2_sites"]) == (k1, k2)


def test_meta_count_adds_the_named_face_networks():
    """The tiny face networks at the small x8 size: per 64² image the
    restorer's two 3×3 convs 3 → 8 → 3 and its code head 8 → 16 a
    pixel, and the parser's 3 → 8 → 19; both run on a window's 4 frames
    in 3 of its 4 steps (τ = 1), the parser once more on its init
    frames."""
    from flairbench_small import TRAFFIC, X8, X8_FACE
    restorer = 2 * 64 * 64 * (9 * (3 * 8 + 8 * 3) + 8 * 16) * 4
    parser = 2 * 64 * 64 * 9 * (3 * 8 + 8 * 19) * 4
    on, off = (roofline.count_call(c, TRAFFIC) for c in (X8_FACE, X8))
    assert on["flops_call"] - off["flops_call"] == pytest.approx(
        (restorer + parser) * 3 / 4)
    assert on["flops_window"] - off["flops_window"] == pytest.approx(parser)


def test_trace_reduction_unions_and_names_gaps():
    ms = 1_000_000
    origin = 5_000 * ms                 # profiler clock at the first op
    calls = [(10.0, 20.0), (40.0, 50.0), (70.0, 80.0)]
    ops = [("Memcpy HtoD", 0, ms),
           ("elementwise_kernel", 12 * ms, 30 * ms),
           ("dcn_raw_bf16", 25 * ms, 35 * ms),       # overlaps the first
           ("Memcpy DtoH", 44 * ms, 45 * ms),
           ("flash_fwd_kernel", 60 * ms, 90 * ms)]
    ops = [(n, s + origin, e + origin) for n, s, e in ops]
    t = trace.reduce(ops, calls, window_s=0.1, steps=2)
    assert t["window_s"] == 0.1
    assert t["busy_s"] == pytest.approx(0.055)
    assert t["kernels"]["dcn_raw_bf16"] == [pytest.approx(0.01), 1]
    assert "Memcpy DtoH" not in t["kernels"]
    assert t["classes"]["flash_attn (K2)"] == pytest.approx(0.03)
    labels = dict((round(s, 3), n) for n, s in t["breakdown"]["idle_gaps"])
    assert labels == {0.011: "window prep before call 0",
                      0.009: "update after call 0",
                      0.015: "window prep before call 2",
                      0.01: "window close after call 2"}


class Event:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_call_spans_split_updates_from_window_prep():
    events = [(Event(10 * k + 2), Event(10 * k + 8)) for k in range(5)]
    s = harness.call_spans(events, Event(0), calls=5, n=2)
    assert s["calls_ms"][1] == (12, 18)
    assert s["unet_ms"] == [6] * 5
    assert s["update_ms"] == [4, 4]          # 0 → 1, 2 → 3
    assert s["prep_ms"] == [2, 4, 4]         # start → 0, 1 → 2, 3 → 4


SUMMARY = {"steps": 50, "windows": 3, "window_s": 35.0, "busy_s": 33.25,
           "flops_call": 58.57e12, "flops_window": 3.77e12,
           "k1_bound_ms": 7.456, "k2_bound_ms": 0.0,
           "kernels": {"dcn_raw_bf16<64, 2>": [2.75, 5400],
                       "vectorized_elementwise_kernel": [10.0, 100000],
                       "cudnn_fprop": [8.0, 50000]},
           "classes": {"dcn_raw (K1)": 2.75, "elementwise": 10.0,
                       "convolution": 8.0},
           "unet_ms": [600.0, 620.0], "update_ms": [10.0], "prep_ms": [],
           "spans": {"unet_device_ms": 466.4, "resnet_ms": 33.3,
                     "temporal_ms": 107.6, "vsrpp_ms": 308.3,
                     "update_device_ms": 1.74, "prep_device_ms": 55.2,
                     "model_build_s": 0.58, "kernel_load_s": 0.004}}
# the span metrics, read from ``summary["spans"]``
SPAN_METRICS = ("unet_device_ms", "resnet_ms", "temporal_ms", "vsrpp_ms",
                "attention_ms", "update_device_ms", "prep_device_ms",
                "model_build_s", "kernel_load_s")


@pytest.mark.parametrize("name,value", [
    ("idle_share", 5.0), ("launches_per_step", 155400 / 50),
    ("k1_roofline", 100 * 7.456 * 50 / 1e3 / 2.75), ("k2_roofline", None),
    ("glue_share", 100 * 10.0 / 20.75), ("unet_ms", 610.0),
    ("update_ms", 10.0), ("window_prep_ms", None),
    ("step_mfu", 100 * (50 * 58.57e12 + 3 * 3.77e12) / 35.0 / 989e12),
    ("unet_device_ms", 466.4), ("resnet_ms", 33.3), ("temporal_ms", 107.6),
    ("vsrpp_ms", 308.3), ("attention_ms", None), ("update_device_ms", 1.74),
    ("prep_device_ms", 55.2), ("model_build_s", 0.58),
    ("kernel_load_s", 0.004)])
def test_reader(name, value):
    got = importlib.import_module(f"flairbench.metrics.{name}").read(SUMMARY)
    assert got == (None if value is None else pytest.approx(value))


class KinetoEvent:
    """A kineto event as ``join.events_of`` reads it."""

    def __init__(self, name, start, end, corr, device):
        self.args = name, start, end, corr, device

    def device_type(self):
        from torch._C._autograd import DeviceType
        return DeviceType.CUDA if self.args[4] else DeviceType.CPU

    def is_user_annotation(self):
        return False

    def name(self):
        return self.args[0]

    def start_ns(self):
        return self.args[1]

    def end_ns(self):
        return self.args[2]

    def correlation_id(self):
        return self.args[3]


class Profiler:
    """A finished profiler holding ``events``."""

    def __init__(self, events):
        results = type("Results", (), {"events": lambda self: events})()
        self.profiler = type("Kineto", (), {"kineto_results": results})()


def traced_record(with_spans):
    """A recorded traced window of the small x8 configuration: the join
    test's kernels, launches and spans, one call, a set-up with a model
    build of 4.5 s."""
    from test_flairbench_join import LAUNCHES, OPS, RECORDS
    events = [KinetoEvent(n, s, e, c, True) for n, s, e, c in OPS]
    events += [KinetoEvent("cudaLaunchKernel", t, t + 1, c, False)
               for c, t in LAUNCHES.items()]
    rec = {"profiler": Profiler(events), "window_s": 0.2, "calls": 1,
           "call_spans": {"calls_ms": [(20.0, 60.0)], "unet_ms": [40.0],
                          "update_ms": [], "prep_ms": [20.0]}}
    if with_spans:
        rec["span_records"] = ([("model.build", -1, 0, 4_500_000_000)],
                               RECORDS)
    return rec


@pytest.mark.parametrize("with_spans", [True, False],
                         ids=["spans", "no_spans"])
def test_trace_summary_carries_the_span_metrics(with_spans):
    from flairbench_small import TRAFFIC, X8
    t = harness.trace_summary(traced_record(with_spans), X8, TRAFFIC)
    assert t["config"] is X8 and t["traffic"] is TRAFFIC
    assert t["kernels"]["dcn_raw_bf16"] == [pytest.approx(0.01), 1]
    got = harness.per_layer(t, SPAN_METRICS)
    if not with_spans:
        assert "spans" not in t and got == {}
        return
    # the join test's numbers: kernels by the span that launched them
    assert got == pytest.approx({
        "unet_device_ms": 24, "update_device_ms": 10, "prep_device_ms": 9,
        "resnet_ms": 9, "vsrpp_ms": 10, "model_build_s": 4.5})
    assert t["attribution"]["coverage"] == pytest.approx(1 - 10 / 53)
