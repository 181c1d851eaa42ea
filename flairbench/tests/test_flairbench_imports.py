"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names, and the reference loads nothing of the
program either."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROBE = """
import json, sys
for m in sys.argv[1:]:
    __import__(m)
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""
HARNESS = ["flairbench.run", "flairbench.harness", "flairbench.compare",
           "flairbench.control", "flairbench.trace", "flairbench.roofline",
           "flair_tpu_torch.pipeline.video", "flair_tpu_torch.pipeline.wrappers",
           "flair_tpu_torch.models.registry", "flair_tpu_torch.ops.dcn",
           "flair_tpu_torch.ops.attention"]
REFERENCE = ["flairbench.reference.nn", "flairbench.reference.vsrpp",
             "flairbench.reference.sr3", "flairbench.reference.adm",
             "flairbench.reference.guidance", "flairbench.reference.face",
             "flairbench.reference.tiny_face",
             "flairbench.reference.codeformer",
             "flairbench.reference.parsenet", "flairbench.inputs"]


def top_level_modules(modules):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", PROBE, *modules], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.splitlines()[-1]))


@pytest.mark.parametrize("modules,banned", [
    (HARNESS, {"jax", "jaxlib", "flax", "flair_tpu"}),
    (REFERENCE, {"jax", "jaxlib", "flax", "flair_tpu", "flair_tpu_torch"})],
    ids=["harness_and_program", "reference"])
def test_no_banned_top_level_module(modules, banned):
    found = top_level_modules(modules)
    assert "flairbench" in found
    assert not found & banned, found & banned
