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
           "unet_ms": [600.0, 620.0], "update_ms": [10.0], "prep_ms": []}


@pytest.mark.parametrize("name,value", [
    ("idle_share", 5.0), ("launches_per_step", 155400 / 50),
    ("k1_roofline", 100 * 7.456 * 50 / 1e3 / 2.75), ("k2_roofline", None),
    ("glue_share", 100 * 10.0 / 20.75), ("unet_ms", 610.0),
    ("update_ms", 10.0), ("window_prep_ms", None),
    ("step_mfu", 100 * (50 * 58.57e12 + 3 * 3.77e12) / 35.0 / 989e12)])
def test_reader(name, value):
    got = importlib.import_module(f"flairbench.metrics.{name}").read(SUMMARY)
    assert got == (None if value is None else pytest.approx(value))
