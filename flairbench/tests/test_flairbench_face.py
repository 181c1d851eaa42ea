"""The face prior through the harness on the CPU, at the small x8 size with
the tiny face networks (``flairbench_small.X8_FACE``): the program and
the frozen reference agree within the limits; the control and each fault
of the face work, planted underneath, fail at least one limit; a bf16
CodeFormer that flips codes passes the code and restored numbers, which
a comparison of each side's own codes would not; each fault of the code
path fails its number; a dropped VSR++ gating moves eps; and with the
face prior off the harness calls ``restore_video`` and reads the six
numbers exactly as before."""

import copy
import time

import pytest
import torch
import torch.nn.functional as F

from flairbench import compare, harness, inputs
from flairbench.reference import face as face_ref
from flairbench.reference import vsrpp as ref_vsrpp
from flairbench.reference.tiny_face import TinyCodeFormer
from flair_tpu_torch.diffusion import sampler
from flair_tpu_torch.face import helper
from flair_tpu_torch.pipeline import video

from flairbench_small import (BLUR, SEED, TRAFFIC, X8, X8_FACE,
                              ProgramTinyCodeFormer)

# a seed whose drawn call s has w_t < 1 at its step, so that the fusion
# is part of step_w1 (window 2's compared step has w_t = 1)
FACE_SEED = SEED + 1


def run(config, seed=FACE_SEED):
    torch.manual_seed(0)
    rec = harness.run_window(config, TRAFFIC, seed, 0.0, False, "cpu",
                             time.perf_counter())
    return rec, compare.readings(config, TRAFFIC, seed, rec["clip"],
                                 rec["buffers"], rec["plan"], "cpu")


def failed(config, vals):
    return [k for k, c in compare.verdict(vals, config["limits"]).items()
            if c["value"] > c["limit"]]


@pytest.fixture(scope="module")
def sound():
    return run(X8_FACE)


def test_the_seed_compares_a_fused_step():
    n = harness.steps_per_window(X8_FACE)
    ws, tau = face_ref.window(X8_FACE["task"], n)
    t = n - 1 - compare.plan(n, FACE_SEED)["s"]
    assert tau <= t and ws[t] < 1


def test_reference_matches_program_with_the_face_prior(sound):
    rec, vals = sound
    n = harness.steps_per_window(X8_FACE)
    s = rec["plan"]["s"]
    b = rec["buffers"]
    # the face runs in the updates of steps tau..n-1, the parse of the
    # init frames before each window's first call
    assert sorted(b["crop"]) == sorted(b["restored"]) == sorted(b["parse"]) \
        == sorted(b["codes"]) == [s, n]
    # the code logits of each face: (faces, tokens, codes)
    assert b["codes"][s].shape == (TRAFFIC["window"], 64 * 64, 16)
    assert sorted(b["init_parse"]) == [0, n]
    assert sorted(b["weights"]) == sorted(rec["plan"]["out"])
    # the tiny parser parses every pixel as background: weights 0.93
    assert all(bool((w < 1).all()) for w in b["weights"].values())
    assert sorted(vals) == sorted(
        f"{k}_w{w}" for k in ("start", "eps", "face", "codes", "restored",
                              "parse", "step") for w in (1, 2))
    assert max(vals.values()) < 1e-4, vals
    assert not failed(X8_FACE, vals)


def test_control_fails_the_face_limits(sound):
    rec, _ = sound
    low = compare.readings(X8_FACE, TRAFFIC, FACE_SEED, rec["clip"],
                           rec["buffers"], rec["plan"], "cpu", lower=True)
    assert {f"{k}_w{w}" for k in ("face", "eps", "codes", "restored",
                                   "parse") for w in (1, 2)} <= set(
        failed(X8_FACE, low)), low


def own_codes_gap(config, rec, seed=FACE_SEED):
    """The comparison as it stood before the code logits were recorded:
    the program's restored faces against the reference CodeFormer on
    the program's crop with the reference's own codes; and the codes
    that the two sides' argmaxes choose differently."""
    prior = compare.FacePrior(config, seed, rec["buffers"],
                              TRAFFIC["window"], torch.device("cpu"))
    gaps, flips = [], 0
    with torch.no_grad():
        for k, crop in prior.rec["crop"].items():
            out, logits = prior.net("codeformer", crop, False)
            gaps.append(compare.rel_images(prior.rec["restored"][k], out))
            flips += int((logits.argmax(-1)
                          != prior.rec["codes"][k].argmax(-1)).sum())
    return max(gaps), flips


def test_bf16_codes_flip_and_pass():
    """A CodeFormer in bf16 chooses other codes than float32 for some
    tokens; compared on its own codes it passes, compared on each side's
    own codes (the earlier reading) it would fail ``restored``."""
    config = copy.deepcopy(X8_FACE)
    config["face"]["codeformer"]["model"] = "bench_tiny_codeformer_bf16"
    rec, vals = run(config)
    assert not failed(config, vals), vals
    own, flips = own_codes_gap(config, rec)
    assert flips >= 1
    assert own > config["limits"]["restored"], own


def codes_shifted(monkeypatch):
    """The generator gets the next code after the argmax."""
    monkeypatch.setattr(ProgramTinyCodeFormer, "lookup",
                        lambda self, c: TinyCodeFormer.lookup(
                            self, (c + 1) % len(self.quantize.embedding)))


def adain_left_out(monkeypatch):
    def forward(self, x, w=0.0, adain=False, codes=None):
        return TinyCodeFormer.forward(self, x, w, False, codes)
    monkeypatch.setattr(ProgramTinyCodeFormer, "forward", forward)


def head_scaled(monkeypatch):
    """The code head's logits 1.1 times what they should be (the codes,
    their argmax, unchanged)."""
    init = ProgramTinyCodeFormer.__init__

    def __init__(self, **kw):
        init(self, **kw)
        self.idx_pred.register_forward_hook(lambda m, a, out: 1.1 * out)
    monkeypatch.setattr(ProgramTinyCodeFormer, "__init__", __init__)


def hook_on_the_wrong_submodule(config):
    config["face"]["codeformer"]["record"] = {"codes": "conv_in"}


@pytest.mark.parametrize("plant,number", [
    (codes_shifted, "restored"), (adain_left_out, "restored"),
    (head_scaled, "codes"), (hook_on_the_wrong_submodule, "codes")],
    ids=["codes_shifted", "adain_left_out", "head_scaled",
         "hook_on_the_wrong_submodule"])
def test_planted_code_fault_fails_its_number(plant, number, monkeypatch):
    config = copy.deepcopy(X8_FACE)
    if plant is hook_on_the_wrong_submodule:
        plant(config)
    else:
        plant(monkeypatch)
    _, vals = run(config)
    assert {f"{number}_w1", f"{number}_w2"} <= set(failed(config, vals)), \
        vals


@pytest.mark.parametrize("drop", [("limits", "codes"),
                                  ("limits", "parse"),
                                  ("record", "codes")],
                         ids=["limit_codes", "limit_parse", "record"])
def test_config_without_what_its_numbers_need_fails(drop):
    config = copy.deepcopy(X8_FACE)
    compare.check_config(config, "x8_face")
    where, key = drop
    holder = (config if where == "limits"
              else config["face"]["codeformer"])[where]
    del holder[key]
    with pytest.raises(ValueError):
        compare.check_config(config, "x8_face")


def mask_unblurred(monkeypatch):
    monkeypatch.setattr(helper, "gaussian_blur", lambda x, k, s: x)


def paste_unclamped(monkeypatch):
    """The port's face function with the paste's two clamps left out."""
    def make(codeformer_apply, parsenet_apply=None, *, face_size=512, **kw):
        def face_fn(x0, x_t, mats):
            b, t, h, w, c = x0.shape
            frames = x0.reshape(b * t, h, w, c)
            m = mats.reshape(-1, 2, 3)
            border = torch.as_tensor(helper._GRAY_BORDER, dtype=x0.dtype)
            crop = helper.warp_affine(frames - border, m, (face_size,) * 2,
                                      mode="bicubic") + border
            restored = codeformer_apply(crop.clamp(-1, 1))
            cmap = torch.as_tensor(helper.MASK_COLORMAP)
            mask = cmap[parsenet_apply(restored).argmax(-1)][..., None]
            mask = helper.gaussian_blur(helper.gaussian_blur(mask, 101, 26.0),
                                        101, 26.0)
            e = helper._MASK_BORDER
            mask = F.pad(mask[:, e:-e, e:-e], (0, 0, e, e, e, e))
            pasted = helper.warp_affine(
                torch.cat([restored, mask], -1),
                helper.invert_affine_batch(m), (h, w), mode="bicubic")
            inv_mask = pasted[..., 3:]
            fused = frames * (1 - inv_mask) + pasted[..., :3] * inv_mask
            return fused.reshape(b, t, h, w, c)
        return face_fn
    monkeypatch.setattr(video, "make_face_fn_p", make)


def fused_outside_the_window(monkeypatch):
    orig = sampler.p_sample
    w = video.TASK_CONFIGS["x8_bicubic"].w

    def p_sample(d, out, x, t, z, **kw):
        if kw.get("face_fn") is not None and not kw["in_face_window"]:
            kw.update(in_face_window=True, w_t=w)
        return orig(d, out, x, t, z, **kw)
    monkeypatch.setattr(sampler, "p_sample", p_sample)


@pytest.mark.parametrize("plant", [
    mask_unblurred, paste_unclamped, fused_outside_the_window],
    ids=["mask_unblurred", "paste_unclamped", "fused_outside_the_window"])
def test_planted_face_fault_is_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    _, vals = run(X8_FACE)
    assert failed(X8_FACE, vals), vals


def test_gating_moves_eps_within_its_limit(sound, monkeypatch):
    """The VSR++ weights dropped from the reference: with every pixel
    background (0.93) eps moves by ~4 %, thousands of times the sound
    run's gap, yet under x8's eps limit (0.07), which the bf16 trunk's
    noise sets: no limit of the cell sees the gating (PERF.md)."""
    rec, vals = sound
    orig = ref_vsrpp.BasicVSRPP.forward
    monkeypatch.setattr(ref_vsrpp.BasicVSRPP, "forward",
                        lambda self, h, b, flows, weights=None:
                        orig(self, h, b, flows))
    dropped = compare.readings(X8_FACE, TRAFFIC, FACE_SEED, rec["clip"],
                               rec["buffers"], rec["plan"], "cpu")
    for k in ("eps_w1", "eps_w2"):
        assert 0.03 < dropped[k] < X8_FACE["limits"]["eps"]
        assert dropped[k] > 1e3 * vals[k]


@pytest.mark.parametrize("config,face", [(X8, False), (X8_FACE, True)],
                         ids=["face_off", "face_on"])
def test_restore_keywords(config, face, monkeypatch):
    seen = {}

    def restore_video(clip, cfg, window, **kw):
        seen.update(kw)
        raise harness.WindowClosed
    monkeypatch.setattr(video, "restore_video", restore_video)
    _, d, apply, cfg, prior = harness.build_program(config, SEED, "cpu")
    window = harness.Window(apply, face=prior)
    harness.restore(None, cfg, d, window, TRAFFIC, inputs.Noise(SEED, "cpu"),
                    "cpu")
    parent = {"diffusion", "win", "overlap", "sampler", "eta", "device",
              "noise_fn"}
    assert set(seen) == parent | ({"face_helper", "codeformer_apply",
                                   "parsenet_apply"} if face else set())
    # the CLI's face window at ddim4: tau = max(1, round(5 · 4 / 100))
    assert (prior is not None) == face and (not face or cfg.tau == 1)


# the six numbers of the small cells through the harness before the face
# prior was added (its tree's flairbench on the CPU, one thread, torch
# 2.13.0+cpu), as float.hex
PARENT = {
    "x8": {"start_w1": "0x1.f2d5260000000p-27",
           "eps_w1": "0x1.5215340000000p-19",
           "step_w1": "0x1.7f17b60000000p-24",
           "start_w2": "0x1.e3e9840000000p-27",
           "eps_w2": "0x1.6fd35c0000000p-19",
           "step_w2": "0x1.76d1300000000p-24"},
    "gaussian": {"start_w1": "0x0.0p+0", "eps_w1": "0x1.cb16c60000000p-18",
                 "step_w1": "0x1.4eac2e0000000p-24", "start_w2": "0x0.0p+0",
                 "eps_w2": "0x1.9bbc640000000p-18",
                 "step_w2": "0x1.547f7c0000000p-24"}}


@pytest.mark.parametrize("name,config", [("x8", X8), ("gaussian", BLUR)])
def test_face_off_readings_equal_the_parents(name, config):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, vals = run(config, SEED)
    finally:
        torch.set_num_threads(threads)
    assert {k: float(v).hex() for k, v in vals.items()} == PARENT[name]
