"""The port stands alone: no JAX and no slice3d_tpu import, and the weight
bridge inverts the JAX package's torch importer."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from torch_refs import TorchSliceNetRef, randomize_bn_stats
from slice3d_tpu.convert import torch_import
import slice3d_tpu_torch
from slice3d_tpu_torch.convert import slicenet_state_dict
from slice3d_tpu_torch.models.slicenet import init_slicenet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "slice3d_tpu_torch")


def test_import_leaves_jax_out():
    code = ("import sys, slice3d_tpu_torch, slice3d_tpu_torch.pipeline, "
            "slice3d_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'slice3d_tpu' or m.startswith('slice3d_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", ["package", "chip_smoke"])
def test_no_jax_or_reference_imports(where):
    if where == "package":
        files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
                 if f.endswith(".py")]
    else:
        files = [os.path.join(ROOT, "chip_smoke.py")]
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "slice3d_tpu"), (path, name)


def test_weight_bridge_round_trip():
    """reference torch state_dict -> flax (torch_import) -> port is the identity,
    and the port's model has exactly the reference's keys and shapes."""
    ref = randomize_bn_stats(TorchSliceNetRef(12), seed=3)
    sd = ref.state_dict()
    back = slicenet_state_dict(torch_import.slicenet_model(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k].to(v.dtype), v), k
    port = init_slicenet(0).state_dict()
    assert {k: v.shape for k, v in port.items()} == {k: v.shape for k, v in sd.items()}
    init_slicenet(0).load_state_dict(back)  # strict


def test_resolve_device_defaults_to_cuda():
    assert slice3d_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert slice3d_tpu_torch.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            slice3d_tpu_torch.resolve_device()
