"""The port's fused FFN and split-encoder route against the JAX package (CPU).

``fused_ffn_ref`` is held against the Pallas kernel ``_fused_ffn_tpu`` run in
interpret mode at N = 1500 rows (not a multiple of its 1024-row block): at
atol 1e-5 in fp32 (the two sum in another order; reading 1.7e-6), and in
bf16 within a bf16 rounding flip of the output (both round h after the ReLU
and the output to bf16 from fp32 sums taken in another order; |got - want|
<= 2e-2 + 1e-2 |want| against outputs up to ~4, whose bf16 ulp is 2^-6 at
most; reading 7.8e-3, one ulp at 1-2, on 109 of 192,000 outputs).  The
split route of the port's encoder layer is held against the JAX layer with
``fused_ffn=True`` and the whole-layer kernel switched off
(``SLICE3D_DISABLE_FUSED_ENCODER``), its FFN through the Pallas kernel in
interpret mode, at atol 5e-5 / rtol 1e-4 (fp32).  The kernel itself is
compared with the plain version on the card by tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from slice3d_tpu.models.layers import TransformerEncoderLayer as JaxLayer
from slice3d_tpu.ops import pallas_ffn
from slice3d_tpu_torch.models.gtslice import GTSliceModel
from slice3d_tpu_torch.models.layers import ROUTES, TransformerEncoderLayer
from slice3d_tpu_torch.models.slicenet import init_slicenet
from slice3d_tpu_torch.ops import fused_ffn as ff
from test_torch_encoder import flax_layer_params, port_params

D, F, N = 128, 2048, 1500
# bf16: a rounding flip of an output below 4 (see the module note)
BF16_TOL = dict(atol=2e-2, rtol=1e-2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The Pallas FFN kernel in interpret mode, reachable on the CPU."""
    orig = pallas_ffn.pl.pallas_call
    monkeypatch.setattr(pallas_ffn.pl, "pallas_call", functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_ffn, "pallas_available", lambda: True)


def _ffn_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w1 = (rng.normal(size=(D, F)) * 0.08).astype(np.float32)  # JAX layout (d, f)
    b1 = (rng.normal(size=(F,)) * 0.02).astype(np.float32)
    w2 = (rng.normal(size=(F, D)) * 0.03).astype(np.float32)
    b2 = (rng.normal(size=(D,)) * 0.02).astype(np.float32)
    return x, w1, b1, w2, b2


def _port_args(x, w1, b1, w2, b2, dtype):
    """The port's arguments: x in ``dtype``, the weights in nn.Linear's
    layout (the transposes of the JAX function's)."""
    t = torch.from_numpy
    return (t(x).to(dtype), t(np.ascontiguousarray(w1.T)), t(b1),
            t(np.ascontiguousarray(w2.T)), t(b2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(pallas_interpret, dtype):
    x, w1, b1, w2, b2 = _ffn_inputs(1)
    jdt = jnp.dtype(dtype)
    # __wrapped__: past the jit cache, so the interpret patch is what runs
    want = pallas_ffn._fused_ffn_tpu.__wrapped__(
        jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jnp.asarray(b1), jnp.asarray(w2, jdt),
        jnp.asarray(b2))
    want = np.asarray(want.astype(jnp.float32))
    got = ff.fused_ffn_ref(*_port_args(x, w1, b1, w2, b2, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (N, D)
    tol = dict(atol=1e-5, rtol=0) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = _port_args(*_ffn_inputs(2), torch.float32)
    before = ff.launches
    got = ff.fused_ffn(args[0].reshape(3, N // 3, D), *args[1:])
    assert ff.launches == before  # no kernel launch for a CPU tensor
    assert tuple(got.shape) == (3, N // 3, D)
    torch.testing.assert_close(got.reshape(N, D), ff.fused_ffn_ref(*args), rtol=0, atol=0)
    with pytest.raises(ValueError):
        ff.fused_ffn(torch.zeros((4, D), device="meta"), *args[1:])


@pytest.mark.parametrize("head_tokens", [0, 1])
def test_split_layer_matches_jax(pallas_interpret, monkeypatch, head_tokens):
    monkeypatch.setenv("SLICE3D_DISABLE_FUSED_ENCODER", "1")
    rng = np.random.default_rng(30 + head_tokens)
    x = rng.normal(size=(1, 90, 13, D)).astype(np.float32)
    fp = flax_layer_params(40 + head_tokens)
    jlayer = JaxLayer(d_model=D, n_heads=4, d_ff=F, head_tokens=head_tokens, fused_ffn=True)
    want = np.asarray(jax.jit(jlayer.apply)({"params": jax.tree_util.tree_map(
        jnp.asarray, fp)}, jnp.asarray(x)))
    tol = dict(atol=5e-5, rtol=1e-4)
    outs = {}
    for route in ROUTES:
        layer = TransformerEncoderLayer(D, 4, F, head_tokens=head_tokens, route=route)
        layer.load_state_dict(port_params(fp))
        with torch.no_grad():
            outs[route] = layer(torch.from_numpy(x)).numpy()
        assert outs[route].shape == want.shape == (1, 90, head_tokens or 13, D)
    np.testing.assert_allclose(outs["split"], want, **tol)
    np.testing.assert_allclose(outs["split"], outs["fused"], **tol)
    np.testing.assert_allclose(outs["split"], outs["plain"], **tol)


def test_route_is_validated_and_threaded_through_the_models():
    with pytest.raises(ValueError, match="route"):
        TransformerEncoderLayer(route="fast")
    with pytest.raises(ValueError, match="route"):
        GTSliceModel(route="fused_ffn")
    model = init_slicenet(0, route="split")
    assert [layer.route for layer in model.att_decoder.layers] == ["split"] * 3
    assert model.state_dict().keys() == init_slicenet(0).state_dict().keys()
