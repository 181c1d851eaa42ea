"""Every file the benchmark reads is there and is found by its name in
``BENCHMARK.json``; each configuration builds the program's model (and
each face network that names a reference) and the frozen reference with
the same parameters by name and shape, and names submodules to record
that the program's network has."""

import importlib
import json
import os
import re

import pytest
import torch

from flairbench import compare, harness
from flairbench.inputs import FACE_NETS
from flairbench.roofline import reference_class

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    _, entry, config, traffic = harness.load_cell(cell)
    assert entry["chips"] == 1
    # a limit for each kind of number the configuration is compared by:
    # start, eps, step; face with the face prior on; codes and restored
    # with a reference CodeFormer (and its record.codes), parse with a
    # reference ParseNet
    compare.check_config(config, cell)
    assert config["reduced"] == [] and config["limits"].keys() == \
        compare.limit_kinds(config)
    assert traffic["window"] > traffic["overlap"] >= 1
    # the clip outlasts any window: 20 windows of 25 calls
    windows = (traffic["frames"] - traffic["overlap"]) // (
        traffic["window"] - traffic["overlap"])
    assert windows * harness.steps_per_window(config) >= 400


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_is_found(metric):
    reader = importlib.import_module(f"flairbench.metrics.{metric}")
    assert callable(reader.read)


def test_names_and_metrics_keep_to_the_contract():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"frames_per_s", "peak_mem_gib", "setup_s"} <= e2e
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("config", [c["file"] for c in BENCH["configs"]])
def test_program_and_reference_share_parameters(config):
    from flair_tpu_torch.models.registry import get_model
    with open(os.path.join(harness.ROOT, config)) as f:
        cfg = json.load(f)
    # (registry name, reference entry, keyword arguments)
    nets = [(cfg["model"], cfg, cfg["model_kwargs"])]
    if cfg.get("face_prior"):
        nets += [(e["model"], e, e["kwargs"])
                 for e in map(cfg["face"].get, FACE_NETS)
                 if e is not None and e.get("reference")]
    for model, entry, kwargs in nets:
        with torch.device("meta"):
            prog = get_model(model, **harness.model_kwargs(kwargs))
            ref = reference_class(entry)(**kwargs)
        shapes = [sorted((n, tuple(p.shape)) for n, p in m.named_parameters())
                  for m in (prog, ref)]
        assert shapes[0] == shapes[1], model
        # each submodule whose output the window records
        for sub in entry.get("record", {}).values():
            prog.get_submodule(sub)
