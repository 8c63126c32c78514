"""The port's SliceNet folded paths against the JAX SliceNetModel (CPU, fp32).

JAX seed-0 weights (BatchNorm statistics randomized so a mean/var mix-up
shows) are carried into the port by ``slice3d_tpu_torch.convert``; n_slices
12, img 32; atol 5e-4 / rtol 1e-3 as in tests/test_model_parity.py.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.slicenet import SliceNetModel as JaxSliceNet
from slice3d_tpu_torch import camera
from slice3d_tpu_torch.convert import slicenet_state_dict
from slice3d_tpu_torch.models.slicenet import SliceNetModel, init_slicenet

N_SLICES, IMG, M = 12, 32, 97
TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomized_bn(variables, seed):
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                   variables["batch_stats"])

    def fill(tree):
        for v in tree.values():
            if isinstance(v, dict) and "mean" in v:
                v["mean"] = rng.normal(0, 0.1, v["mean"].shape).astype(np.float32)
                v["var"] = rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)
            elif isinstance(v, dict):
                fill(v)

    fill(stats)
    return {"params": variables["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def models():
    jmodel = JaxSliceNet(n_slices=N_SLICES)
    variables = randomized_bn(
        init_variables(jmodel, types.SimpleNamespace(img_size=IMG), seed=0), seed=2)
    model = SliceNetModel(N_SLICES)
    model.load_state_dict(slicenet_state_dict(variables))
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (1, IMG, IMG, 3)).astype(np.float32)
    rot, proj = camera.camera_matrices(0.5, 0.1, 1.2)
    qry = (rng.uniform(-0.5, 0.5, (1, M, 3)) @ rot).astype(np.float32)
    inputs = dict(img=img, qry=qry, trans=proj[None].astype(np.float32))
    j_packed, j_slices = jmodel.apply(variables, jnp.asarray(img),
                                      method=JaxSliceNet.encode_folded)
    with torch.no_grad():
        packed, slices = model.eval().encode_folded(torch.from_numpy(img))
    return jmodel, variables, model, inputs, (j_packed, j_slices), (packed, slices)


def test_encode_folded_matches_jax(models):
    _, _, _, _, (j_packed, j_slices), (packed, slices) = models
    assert [tuple(p.shape) for p in packed] == [p.shape for p in j_packed]
    assert [p.shape[1] for p in packed] == [2, 4, 8, 16, 32]  # img 32 pyramid
    for a, b in zip(packed, j_packed):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(slices.numpy(), np.asarray(j_slices), **TOL)


def test_query_folded_matches_jax(models):
    jmodel, variables, model, inp, (j_packed, _), (packed, _) = models
    want = jmodel.apply(variables, j_packed, jnp.asarray(inp["qry"]),
                        jnp.asarray(inp["trans"]), method=JaxSliceNet.query_folded)
    with torch.no_grad():
        got = model.query_folded(packed, torch.from_numpy(inp["qry"]),
                                 torch.from_numpy(inp["trans"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_query_presampled_matches_jax(models):
    jmodel, variables, model, inp, _, _ = models
    rng = np.random.default_rng(5)
    sampled = rng.normal(size=(1, M, N_SLICES, 128)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(inp["qry"]), jnp.asarray(sampled),
                        method=JaxSliceNet.query_presampled)
    with torch.no_grad():
        got = model.query_presampled(torch.from_numpy(inp["qry"]),
                                     torch.from_numpy(sampled))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_slicenet_is_seeded():
    a, b, c = init_slicenet(0), init_slicenet(0), init_slicenet(1)
    d = init_slicenet(generator=torch.Generator().manual_seed(0))
    sa, sb, sc, sd = (m.state_dict() for m in (a, b, c, d))
    for k in sa:
        assert torch.equal(sa[k], sb[k]) and torch.equal(sa[k], sd[k]), k
    assert not torch.equal(sa["fc_s.weight"], sc["fc_s.weight"])
    assert not a.training
