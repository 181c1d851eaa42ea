"""The join of kernels to the program's spans (``flairbench.join``) on a
synthetic trace, the numbers it gives, the records of a window of the
small x8 configuration on the CPU, and that the join loads no JAX."""

import time

import pytest

from flairbench import join

from flairbench_small import SEED, TRAFFIC, X8
from test_flairbench_imports import top_level_modules

MS = 1_000_000          # ns
RECORDS = [             # (name, parent, t0, t1) in ms
    ("window", -1, 0, 100), ("prep", 0, 0, 10), ("denoiser", 0, 20, 60),
    ("resnet", 2, 25, 35), ("vsrpp", 2, 40, 50), ("update", 0, 62, 70)]
RECORDS = [(n, p, a * MS, b * MS) for n, p, a, b in RECORDS]
# (name, device start, device end, correlation id) and each launch's host
# stamp: the device runs behind the host
OPS = [("Memcpy HtoD", 40, 45, 1), ("cat_kernel", 50, 59, 2),
       ("elementwise_kernel", 61, 70, 3), ("dcn_raw_bf16", 70, 80, 4),
       ("elementwise_kernel", 80, 85, 5), ("reduce_kernel", 100, 110, 6),
       ("elementwise_kernel", 150, 160, 7)]
OPS = [(n, s * MS, e * MS, c) for n, s, e, c in OPS]
LAUNCHES = {1: 21 * MS, 2: 5 * MS, 3: 30 * MS, 4: 45 * MS, 5: 55 * MS,
            6: 65 * MS, 7: 150 * MS}


def test_attribute_credits_each_kernel_to_the_span_that_launched_it():
    att = join.attribute(OPS, LAUNCHES, RECORDS)
    s = att["spans"]
    ms = {n: (round(r["device_s"] * 1e3, 6), round(r["self_s"] * 1e3, 6),
              r["launches"], r["self_launches"], r["n"])
          for n, r in s.items()}
    # launched in prep at 5 ms, run at 50-59 ms while the denoiser is open:
    # prep's, not the denoiser's
    assert ms["prep"] == (9, 9, 1, 1, 1)
    assert ms["resnet"] == (9, 9, 1, 1, 1)
    assert ms["vsrpp"] == (10, 10, 1, 1, 1)
    assert ms["denoiser"] == (24, 5, 3, 1, 1)
    # run at 100-110 ms, after the window span closed
    assert ms["update"] == (10, 10, 1, 1, 1)
    assert ms["window"] == (43, 0, 5, 0, 1)
    assert ms[join.NO_SPAN] == (10, 10, 1, 1, 0)
    assert s["vsrpp"]["kernels"] == {"dcn_raw_bf16": [pytest.approx(0.01), 1]}
    # the memory copy makes no kernel, but bounds the gaps
    assert "Memcpy HtoD" not in str(s)
    # gaps by their midpoint on the host clock: 45-50 (vsrpp), 59-61 (the
    # denoiser, at its last ns), 85-100 (the window), 110-150 (no span)
    idle = {n: round(r["idle_s"] * 1e3, 6) for n, r in s.items()}
    assert idle == {"window": 15, "prep": 0, "denoiser": 2, "resnet": 0,
                    "vsrpp": 5, "update": 0, join.NO_SPAN: 40}
    assert att["coverage"] == pytest.approx(1 - 10 / 53)


def test_a_kernel_with_no_launch_event_is_in_no_span():
    att = join.attribute(OPS, {}, RECORDS)
    assert att["coverage"] == 0.0
    assert att["spans"][join.NO_SPAN]["self_launches"] == 6


def test_nested_spans_of_one_name_count_once():
    records = [("temporal", -1, 0, 10 * MS), ("temporal", 0, 2 * MS, 4 * MS)]
    ops = [("k", 5 * MS, 6 * MS, 1), ("k", 7 * MS, 8 * MS, 2)]
    att = join.attribute(ops, {1: 3 * MS, 2: 5 * MS}, records)
    r = att["spans"]["temporal"]
    assert (r["n"], r["launches"], r["self_launches"]) == (1, 2, 2)
    assert r["device_s"] == pytest.approx(2e-3)


def test_split_and_setup_seconds():
    records = [("model.build", -1, 0, 3 * MS),
               ("model.build", 0, 1 * MS, 2 * MS),
               ("kernels.load", -1, 4 * MS, 5 * MS),
               ("window", -1, 6 * MS, 9 * MS),
               ("kernels.load", 3, 6 * MS, 8 * MS),
               ("window", -1, 10 * MS, 20 * MS), ("prep", 5, 11 * MS, 12 * MS)]
    setup, window = join.split(records, 10 * MS)
    assert setup == records[:5]
    assert window == [("window", -1, 10 * MS, 20 * MS),
                      ("prep", 0, 11 * MS, 12 * MS)]
    assert join.setup_seconds(setup) == pytest.approx(
        {"model.build": 3e-3, "kernels.load": 3e-3, "window": 3e-3})
    assert join.split(records, 30 * MS) == (records, [])


def test_span_metrics_checks_and_table():
    att = join.attribute(OPS, LAUNCHES, RECORDS)
    m = join.span_metrics(att, {"model.build": 4.5, "kernels.load": 0.0})
    assert m == pytest.approx({
        "unet_device_ms": 24, "update_device_ms": 10, "prep_device_ms": 9,
        "resnet_ms": 9, "vsrpp_ms": 10, "model_build_s": 4.5})
    c = join.checks(att, unet_ms=30.0)
    assert c["k1_per_call"] == c["k1_in_vsrpp_per_call"] == 1
    assert c["k2_per_call"] == c["k2_in_attention_per_call"] == 0
    assert c["sublayers_ms"] == pytest.approx(19)
    assert c["sublayers_within_denoiser"] and c["denoiser_within_unet_ms"]
    assert not join.checks(att, unet_ms=20.0)["denoiser_within_unet_ms"]
    text = join.table(att)
    assert text.splitlines()[1].split()[:2] == ["window", "1"]
    assert "81.132 %" in text.splitlines()[-1]
    row = {line.split()[0]: line.split() for line in text.splitlines()}
    assert row["prep"][2:7] == ["9.000", "9.000", "9.000", "1.0", "100.0"]
    summary = join.summary_of(att)
    assert summary["denoiser"]["classes"] == {"elementwise": pytest.approx(
        0.005)}


@pytest.mark.parametrize("record", [True, False])
def test_traced_window_splits_the_set_up_from_the_window(record):
    rec = join.traced_window(X8, TRAFFIC, SEED, 0.0, False, "cpu",
                             time.perf_counter(), record=record)
    setup, window = rec["span_records"]
    if not record:
        assert setup == window == []
        return
    seconds = join.setup_seconds(setup)
    assert 0 < seconds["model.build"] + seconds["window"] < rec["setup_s"]
    assert window[0][:2] == ("window", -1)
    # the warm-up's calls are the set-up's
    assert [r[0] for r in setup].count("denoiser") == TRAFFIC["warmup_calls"]
    assert [r[0] for r in window].count("denoiser") == rec["calls"]


def test_the_join_loads_no_jax():
    found = top_level_modules(["flairbench.join",
                               "flair_tpu_torch.utils.spans"])
    assert not found & {"jax", "jaxlib", "flax", "flair_tpu"}
