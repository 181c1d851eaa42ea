"""The float32 reference CodeFormer and ParseNet against the port's, on the
CPU: the same parameters and buffers by name and shape at the registry
defaults (on ``meta``, no forward at that size), and, at a small size that
keeps GroupNorm's 32 groups, the same outputs from one seeded draw by
name, the reference given the port's codes."""

import pytest
import torch

from flairbench import compare, inputs
from flairbench.reference import face as face_ref
from flairbench.reference.codeformer import CodeFormer
from flairbench.reference.nn import set_precision
from flairbench.reference.parsenet import ParseNet
from flair_tpu_torch.models.registry import get_model

NETS = {"codeformer": CodeFormer, "parsenet": ParseNet}
SMALL = {"codeformer": dict(dim_embd=64, n_head=4, n_layers=2,
                            codebook_size=64, latent_size=64,
                            connect_list=["16", "32"], nf=32,
                            ch_mult=[1, 2, 2]),
         "parsenet": dict(in_size=64, out_size=64, min_feat_size=16,
                          base_ch=32, res_depth=2)}
SIZE = {"codeformer": 32, "parsenet": 64}


def shapes(named):
    return sorted((n, tuple(p.shape)) for n, p in named)


@pytest.mark.parametrize("name", sorted(NETS))
def test_registry_defaults_share_parameters_and_buffers(name):
    with torch.device("meta"):
        prog, ref = get_model(name), NETS[name]()
    assert shapes(prog.named_parameters()) == shapes(ref.named_parameters())
    assert shapes(prog.named_buffers()) == shapes(ref.named_buffers())


def small_pair(name):
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in SMALL[name].items()}
    prog, ref = get_model(name, **kw), NETS[name](**SMALL[name])
    index = inputs.FACE_NETS.index(name)
    for net in (prog, ref):
        inputs.fill_weights(net, 11, "cpu", inputs.FACE_WEIGHTS, index)
    gen = torch.Generator().manual_seed(3)
    faces = torch.rand(3, SIZE[name], SIZE[name], 3, generator=gen) * 2 - 1
    return prog.eval(), ref, faces


@pytest.mark.parametrize("name", sorted(NETS))
def test_small_forward_matches_the_port(name):
    prog, ref, faces = small_pair(name)
    x = faces.permute(0, 3, 1, 2)
    with torch.no_grad():
        if name == "codeformer":
            out, logits, latent = prog(x, w=1.0, adain=True)
            r_out, r_logits, r_latent = ref(x, w=1.0, adain=True,
                                            codes=logits.argmax(-1))
            pairs = [(out, r_out), (logits, r_logits), (latent, r_latent)]
        else:
            pairs = list(zip(prog(x), ref(x)))
    for got, want in pairs:
        assert compare.rel_images(got, want) <= 1e-5


def test_given_codes_replace_the_argmax():
    _, ref, faces = small_pair("codeformer")
    with torch.no_grad():
        out, logits = face_ref.codeformer(ref, faces)
        codes = logits.argmax(-1)
        same, _ = face_ref.codeformer(ref, faces, codes)
        other, _ = face_ref.codeformer(ref, faces, (codes + 1) % 64)
        with pytest.raises(ValueError):
            face_ref.codeformer(ref, faces, codes[:, 1:])
    assert torch.equal(out, same)
    assert compare.rel_images(other, out) > 0.1


@pytest.mark.parametrize("name", sorted(NETS))
def test_control_rounds_the_products(name):
    """One precision lower, every product rounded: the outputs move by
    float8's error, and set back, the reference is float32 again."""
    _, ref, faces = small_pair(name)
    with torch.no_grad():
        want = face_ref.APPLY[name](ref, faces)
        set_precision(ref, True)
        low = face_ref.APPLY[name](ref, faces)
        set_precision(ref, False)
        again = face_ref.APPLY[name](ref, faces)
    first = (lambda v: v[1]) if name == "codeformer" else (lambda v: v)
    assert compare.rel_images(first(low), first(want)) > 1e-2
    assert torch.equal(first(again), first(want))
