"""The harness's run on the CPU at the small sizes: the frozen reference
agrees with the program in float32 for one guided step in each of two
windows, the second pinned; the control (the reference one precision
lower in the program's place) fails the cells' limits; and each fault the
window can have, planted underneath, makes ``correct`` false."""

import time

import pytest
import torch

from flairbench import compare, harness
from flair_tpu_torch.diffusion import sampler
from flair_tpu_torch.pipeline import wrappers

from flairbench_small import BLUR, SEED, TRAFFIC, X8


def run(config, seed=SEED):
    torch.manual_seed(0)
    rec = harness.run_window(config, TRAFFIC, seed, 0.0, False, "cpu",
                             time.perf_counter())
    return rec, compare.readings(config, TRAFFIC, seed, rec["clip"],
                                 rec["buffers"], rec["plan"], "cpu")


def failed(config, vals):
    return [k for k, c in compare.verdict(vals, config["limits"]).items()
            if c["value"] > c["limit"]]


@pytest.mark.parametrize("config", [X8, BLUR], ids=["x8", "gaussian"])
def test_reference_matches_program(config):
    rec, vals = run(config)
    n = harness.steps_per_window(config)
    assert rec["calls"] == n + 1            # the window closes at call n + 1
    assert sorted(vals) == ["eps_w1", "eps_w2", "start_w1", "start_w2",
                            "step_w1", "step_w2"]
    assert max(vals.values()) < 3e-5, vals
    assert not failed(config, vals)


@pytest.mark.parametrize("config", [X8, BLUR], ids=["x8", "gaussian"])
def test_control_fails_the_limits(config):
    rec, _ = run(config)
    low = compare.readings(config, TRAFFIC, SEED, rec["clip"], rec["buffers"],
                           rec["plan"], "cpu", lower=True)
    assert failed(config, low), low


def step_unchanged(monkeypatch):
    orig = sampler.p_sample
    monkeypatch.setattr(sampler, "p_sample",
                        lambda d, out, x, t, z, **kw: (x, orig(
                            d, out, x, t, z, **kw)[1]))


def pins_dropped(monkeypatch):
    orig = sampler.p_sample

    def p_sample(d, out, x, t, z, **kw):
        kw.update(pin_mask=None, pin_values=None)
        return orig(d, out, x, t, z, **kw)
    monkeypatch.setattr(sampler, "p_sample", p_sample)


def denoiser_fault(change):
    def plant(monkeypatch):
        orig = wrappers.wrap_bicubic_model

        def wrap(d, model, **kw):
            apply = orig(d, model, **kw)

            def faulty(*args):
                return change(apply(*args))
            faulty.flows_fn, faulty.model = apply.flows_fn, apply.model
            return faulty
        monkeypatch.setattr(wrappers, "wrap_bicubic_model", wrap)
    return plant


def half_batch(out):
    """Half of the frames left out, the mean of the rest in their place."""
    h = out.shape[1] // 2
    return torch.cat([out[:, :h], out[:, :h].mean(1, keepdim=True).expand(
        -1, out.shape[1] - h, -1, -1, -1)], 1)


def one_frame_altered(out):
    out = out.clone()
    out[:, 1] = -out[:, 1]
    return out


@pytest.mark.parametrize("plant", [
    step_unchanged, pins_dropped, denoiser_fault(half_batch),
    denoiser_fault(one_frame_altered)],
    ids=["step_unchanged", "pins_dropped", "half_batch", "answer_altered"])
def test_planted_fault_is_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    _, vals = run(X8)
    assert failed(X8, vals), vals
