"""The port's CLI (``flair_tpu_torch.cli``) against ``flair_tpu.cli``.

- Argument plumbing: both CLIs on the same argv (the port's with
  ``--device cpu``), the model build and ``restore_video`` stubbed in each;
  the config, sampler, η, frame shapes and output files that reach
  ``restore_video`` agree (``--input-dirs`` batching and clip-name
  disambiguation, ``--sampler ddim --steps 25`` → ``ddim25``, the tau
  rescale, every guidance flag, ``--frames``, ``--window`` /
  ``--overlap``, ``--t-start``, ``--eta``; the port maps the JAX samplers
  ``steps`` / ``scan`` / ``scan_p`` to its ``steps``).
- End to end, both CLIs for real on one 8² PNG clip at the goldens' x8
  configuration (``goldens/x8_s64``: 5 frames, windows of 3 overlapping by
  1, 4 DDIM steps, ``--checkpoint goldens/x8_s64/params.npz`` in both),
  zero noise in both: the output PNGs agree within 1/255, with the face
  off, and with the face on (tiny CodeFormer, ParseNet and MobileNet-0.25
  RetinaFace carried across as ``.npz`` in ``--face-checkpoint-dir``, and
  ``detect_faces`` stubbed to one fixed detection in both).
"""

import dataclasses
import json
import os

import cv2
import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "goldens", "x8_s64")
MODEL_KW = dict(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
                attn_res=(32,), vsrpp_res=(64,), image_size=64, res_blocks=1,
                num_frames=3, head_dim=8)
FACE_CF_KW = dict(dim_embd=64, n_head=4, n_layers=1, codebook_size=32,
                  latent_size=256, connect_list=("32", "64"), nf=32,
                  ch_mult=(1, 2, 2))      # 64² faces, a 16² latent
FACE_PN_KW = dict(in_size=64, out_size=64, min_feat_size=16, base_ch=16,
                  res_depth=1, ch_range=(16, 64))


def write_clip(root, name, t=3, s=8, seed=0):
    d = root / name
    d.mkdir(parents=True)
    rs = np.random.RandomState(seed)
    for i in range(t):
        cv2.imwrite(str(d / f"{i:02d}.png"),
                    (rs.rand(s, s, 3) * 255).astype(np.uint8))
    return str(d)


def pngs(out_dir):
    return sorted(os.path.relpath(os.path.join(dp, f), out_dir)
                  for dp, _, fs in os.walk(out_dir) for f in fs)


def stub_cli(monkeypatch, pkg):
    """Stubs the model build and ``restore_video`` of ``pkg``'s CLI; returns
    the dict the stub fills with what reached ``restore_video``."""
    import importlib

    cli = importlib.import_module(f"{pkg}.cli")
    seen = {}

    def fake_restore_video(frames, cfg, model_apply, **kw):
        seen.update(frames=np.asarray(frames), cfg=cfg,
                    sampler=kw.get("sampler"), eta=kw.get("eta"),
                    win=kw.get("win"), overlap=kw.get("overlap"),
                    face=kw.get("face_helper") is not None)
        lead = frames.shape[:-3]
        return np.full(lead + (cfg.output_size, cfg.output_size, 3), 0.5,
                       np.float32)

    if pkg == "flair_tpu":
        import flair_tpu.pipeline.video as pv
        import flair_tpu.pipeline.wrappers as pw

        monkeypatch.setattr(cli, "build_model", lambda *a, **k: (None, {}))
        for name in ("wrap_bicubic_model", "wrap_blur_model"):
            monkeypatch.setattr(pw, name, lambda d, m, p: None)
        monkeypatch.setattr(pv, "restore_video", fake_restore_video)
    else:
        monkeypatch.setattr(cli, "build_model", lambda *a, **k: None)
        for name in ("wrap_bicubic_model", "wrap_blur_model"):
            monkeypatch.setattr(cli, name, lambda d, m: None)
        monkeypatch.setattr(cli, "restore_video", fake_restore_video)
    return cli, seen


ARGVS = {
    "batched_ddim": ["x8_bicubic", "--input-dirs", "{a},{b}",
                     "--sampler", "ddim", "--steps", "25", "--no-face"],
    "basename_collision": ["x8_bicubic", "--input-dirs", "{c},{d}",
                           "--no-face"],
    "every_flag": ["gaussian", "--input-dir", "{a}", "--steps", "50",
                   "--tau", "3", "--w", "0.5", "--rho", "0.2",
                   "--noise-level", "1.5", "--zeta", "2", "--jpeg-qf", "40",
                   "--t-start", "30", "--frames", "2", "--window", "4",
                   "--overlap", "1", "--sampler", "scan_p", "--eta", "0.3",
                   "--exact-dcn", "--no-face"],
    "jpeg_tau_rescale": ["jpeg", "--input-dir", "{a}", "--steps", "ddim10",
                         "--sampler", "scan", "--no-face"],
    "x16_steps": ["x16_bicubic", "--input-dir", "{b}", "--steps", "20",
                  "--no-face"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_cli_plumbing_matches_flair_tpu(tmp_path, monkeypatch, case):
    dirs = dict(a=write_clip(tmp_path, "clipA", seed=1),
                b=write_clip(tmp_path, "clipB", seed=2),
                c=write_clip(tmp_path / "runA", "frames", seed=3),
                d=write_clip(tmp_path / "runB", "frames", seed=4))
    argv = [a.format(**dirs) for a in ARGVS[case]]
    got = {}
    for pkg in ("flair_tpu", "flair_tpu_torch"):
        cli, seen = stub_cli(monkeypatch, pkg)
        out = str(tmp_path / f"out_{pkg}")
        extra = ["--device", "cpu"] if pkg == "flair_tpu_torch" else []
        assert cli.main(argv + ["--output-dir", out] + extra) == 0
        got[pkg] = dict(seen, files=pngs(out))
        monkeypatch.undo()
    j, t = got["flair_tpu"], got["flair_tpu_torch"]
    assert dataclasses.asdict(t["cfg"]) == dataclasses.asdict(j["cfg"])
    np.testing.assert_array_equal(t["frames"], j["frames"])
    assert t["files"] == j["files"] and t["files"]
    assert (t["eta"], t["win"], t["overlap"], t["face"]) == (
        j["eta"], j["win"], j["overlap"], j["face"])
    assert t["sampler"] == {"ddim": "ddim"}.get(j["sampler"], "steps")
    if case == "batched_ddim":
        assert t["frames"].shape == (2, 3, 8, 8, 3)
        assert t["cfg"].steps == "ddim25" and t["cfg"].tau == 1
    if case == "basename_collision":
        assert "frames_1/0000.png" in t["files"]


def test_build_face_stack_takes_the_task(monkeypatch):
    """``build_face_stack(task, ...)`` as the JAX CLI calls it
    (flair_tpu/cli.py:110); the task is not read. Small models stand in
    for the full-width ones."""
    from flair_tpu_torch import cli
    from flair_tpu_torch.models.codeformer import CodeFormer
    from flair_tpu_torch.models.parsenet import ParseNet
    from flair_tpu_torch.models.retinaface import RetinaFace

    monkeypatch.setattr(cli, "RetinaFace",
                        lambda network: RetinaFace(network="mobile0.25"))
    monkeypatch.setattr(cli, "CodeFormer",
                        lambda dtype: CodeFormer(**FACE_CF_KW, dtype=dtype))
    monkeypatch.setattr(cli, "ParseNet",
                        lambda dtype: ParseNet(**FACE_PN_KW, dtype=dtype))
    faces = torch.zeros(1, 64, 64, 3)
    outs = []
    for task in ("x8_bicubic", "gaussian"):
        helper, cf, pn = cli.build_face_stack(task, checkpoint_dir=None,
                                              output_size=64, device="cpu")
        assert helper.face_size == 64
        with torch.no_grad():
            outs.append((cf(faces), pn(faces)))
    assert outs[0][0].shape == (1, 64, 64, 3)
    assert outs[0][1].shape == (1, 64, 64, 19)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_cli_rejects_bad_input(tmp_path, monkeypatch):
    from flair_tpu_torch import cli

    a = write_clip(tmp_path, "a", s=8)
    b = write_clip(tmp_path, "b", s=16)
    with pytest.raises(SystemExit):
        cli.main(["x8_bicubic", "--input-dirs", f"{a},{b}", "--no-face",
                  "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["x8_bicubic", "--no-face", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["x8_bicubic", "--input-dir", a, "--no-face"])


# ------------------------------------------------------------ end to end ---


def golden_config(pkg_configs):
    meta = json.load(open(os.path.join(GOLD, "meta.json")))
    return dataclasses.replace(
        pkg_configs["x8_bicubic"], input_size=meta["size"] // meta["factor"],
        output_size=meta["size"], w=meta["w"], rho=meta["rho"],
        zeta=meta["zeta"], tau=meta["tau"])


def flax_face_npz(dirname):
    """Tiny flax CodeFormer, ParseNet and MobileNet-0.25 RetinaFace, every
    leaf perturbed, written as flat .npz files."""
    import jax
    import jax.numpy as jnp
    from flair_tpu.models.codeformer import CodeFormer
    from flair_tpu.models.parsenet import ParseNet
    from flair_tpu.models.retinaface import RetinaFace
    from flair_tpu.utils.checkpoint import flatten_params

    rng = np.random.default_rng(11)
    x = jnp.zeros((1, 64, 64, 3))
    os.makedirs(dirname)
    for name, module, init in (
            ("codeformer", CodeFormer(**FACE_CF_KW),
             lambda m, k: m.init(k, x, w=1.0, adain=True)),
            ("parsenet", ParseNet(**FACE_PN_KW), lambda m, k: m.init(k, x)),
            ("retinaface", RetinaFace(network="mobile0.25"),
             lambda m, k: m.init(k, x))):
        flat = flatten_params(jax.jit(lambda k: init(module, k))(
            jax.random.PRNGKey(3)))
        np.savez(os.path.join(dirname, f"{name}.npz"), **{
            k: (np.abs(v) + 0.5 if k.endswith("/var") else v
                + rng.standard_normal(v.shape) * 0.05).astype(np.float32)
            for k, v in flat.items()})


def fixed_detection():
    """One face: a box and the FFHQ template's landmarks at 64², moved."""
    from flair_tpu_torch.face.helper import FFHQ_TEMPLATE_512

    marks = FFHQ_TEMPLATE_512 / 8.0 * 0.9 + np.array([4.0, 2.0])
    return np.concatenate([[6.0, 4.0, 58.0, 60.0, 0.99],
                           marks.reshape(-1)])[None].astype(np.float32)


def patch_jax_side(monkeypatch, face):
    import jax
    import jax.numpy as jnp
    from flair_tpu.models import codeformer, parsenet, registry, retinaface
    from flair_tpu.models.sr3 import BicubicUNet
    from flair_tpu.pipeline import video

    monkeypatch.setitem(video.TASK_CONFIGS, "x8_bicubic",
                        golden_config(video.TASK_CONFIGS))
    monkeypatch.setattr(registry, "get_model",
                        lambda name, **kw: BicubicUNet(**MODEL_KW))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=None, dtype=jnp.float32:
                        jnp.zeros(shape if shape is not None else (), dtype))
    if face:
        cf, pn, rf = (codeformer.CodeFormer, parsenet.ParseNet,
                      retinaface.RetinaFace)
        monkeypatch.setattr(codeformer, "CodeFormer",
                            lambda **kw: cf(**FACE_CF_KW))
        monkeypatch.setattr(parsenet, "ParseNet",
                            lambda **kw: pn(**FACE_PN_KW))
        monkeypatch.setattr(retinaface, "RetinaFace",
                            lambda **kw: rf(network="mobile0.25"))
        monkeypatch.setattr(retinaface.RetinaFaceDetector, "detect_faces",
                            lambda self, img, *a, **k: fixed_detection())


def patch_port_side(monkeypatch, face):
    from flair_tpu_torch import cli
    from flair_tpu_torch.diffusion import sampler
    from flair_tpu_torch.models.codeformer import CodeFormer
    from flair_tpu_torch.models.parsenet import ParseNet
    from flair_tpu_torch.models.retinaface import RetinaFace, RetinaFaceDetector
    from flair_tpu_torch.models.sr3 import BicubicUNet
    from flair_tpu_torch.pipeline import video

    monkeypatch.setitem(video.TASK_CONFIGS, "x8_bicubic",
                        golden_config(video.TASK_CONFIGS))
    monkeypatch.setattr(cli, "get_model",
                        lambda name, **kw: BicubicUNet(**MODEL_KW))

    def zeros(shape, like, *a, **k):
        return torch.zeros(tuple(shape), dtype=like.dtype, device=like.device)

    monkeypatch.setattr(video, "draw_noise", zeros)
    monkeypatch.setattr(sampler, "draw_noise", zeros)
    if face:
        monkeypatch.setattr(cli, "CodeFormer",
                            lambda dtype: CodeFormer(**FACE_CF_KW, dtype=dtype))
        monkeypatch.setattr(cli, "ParseNet",
                            lambda dtype: ParseNet(**FACE_PN_KW, dtype=dtype))
        monkeypatch.setattr(cli, "RetinaFace",
                            lambda network: RetinaFace(network="mobile0.25"))
        monkeypatch.setattr(RetinaFaceDetector, "detect_faces",
                            lambda self, img, *a, **k: fixed_detection())


@pytest.mark.parametrize("face", [False, True], ids=["face_off", "face_on"])
def test_cli_end_to_end_matches_flair_tpu(tmp_path, monkeypatch, face):
    import flair_tpu.cli as jcli
    from flair_tpu_torch import cli as tcli

    degraded = np.load(os.path.join(GOLD, "degraded01.npy"))   # (5, 8, 8, 3)
    clip = tmp_path / "clip"
    clip.mkdir()
    for i, f in enumerate(degraded):
        cv2.imwrite(str(clip / f"{i:04d}.png"),
                    (f[..., ::-1] * 255).round().astype(np.uint8))
    argv = ["x8_bicubic", "--input-dir", str(clip), "--sampler", "ddim",
            "--steps", "4", "--tau", "0", "--window", "3", "--overlap", "1",
            "--checkpoint", os.path.join(GOLD, "params.npz")]
    if face:
        flax_face_npz(str(tmp_path / "faces"))
        argv += ["--face-checkpoint-dir", str(tmp_path / "faces")]
    else:
        argv += ["--no-face"]
    out = {}
    for pkg, cli, patch, extra in (
            ("jax", jcli, patch_jax_side, []),
            ("port", tcli, patch_port_side, ["--device", "cpu"])):
        patch(monkeypatch, face)
        out_dir = str(tmp_path / pkg)
        assert cli.main(argv + ["--output-dir", out_dir] + extra) == 0
        monkeypatch.undo()
        out[pkg] = np.stack([cv2.imread(os.path.join(out_dir, f))
                             for f in pngs(out_dir)]).astype(np.int32)
    assert out["port"].shape == out["jax"].shape == (5, 64, 64, 3)
    assert np.abs(out["port"] - out["jax"]).max() <= 1
