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


def test_kernel_tiles_are_the_sources():
    """The wrappers' ``KERNEL_TILES`` state the constants of the head
    kernels' sources, so a tile or ring size changed in a .cu or .cuh file
    without the wrapper (its F check and message, chip_smoke.py's weight
    bytes) fails here on the CPU."""
    import os
    import re

    from slice3d_tpu_torch.ops import fused_encoder as fe

    for mod in (fe, ff):
        for name, tiles in mod.KERNEL_TILES.items():
            with open(os.path.join(mod._CSRC, name)) as f:
                src = f.read()
            for const, size in tiles.items():
                found = re.findall(rf"^constexpr int {const} = (\d+);", src, flags=re.M)
                assert found == [str(size)], (mod.__name__, name, const, found)
        assert mod.F_MULTIPLE == mod.KERNEL_TILES["ffn_tile.cuh"]["FT"]
    assert fe.KERNEL_TILES["ffn_tile.cuh"] == ff.KERNEL_TILES["ffn_tile.cuh"]


@pytest.mark.parametrize("n,f,rows,want", [
    (1, 2048, 192, 1), (192, 2048, 192, 1), (193, 2048, 192, 2),
    (33_800, 2048, 192, 177), (439_400, 2048, 128, 3433),
    (439_400, 2048, 192, 2289), (200, 64, 128, 2)])
def test_weight_bytes_per_call_counts_row_tiles(n, f, rows, want):
    """``want`` row tiles, each reading W1 and W2 once."""
    assert ff.weight_bytes_per_call(n, f, tile_rows=rows) == want * 4 * D * f


@pytest.mark.parametrize("n,head_tokens,grid,tiles", [
    (33_800, 0, 132, 3756), (33_800, 1, 132, 394), (33_800, 1, 66, 329), (1, 1, 132, 1),
    (129, 1, 132, 129), (16_897, 1, 132, 260), (16_903, 1, 132, 261),
    (16_896, 1, 132, 132), (16_895, 1, 132, 132)])
def test_encoder_weight_bytes_follow_its_tiles(n, head_tokens, grid, tiles):
    """Full layers pack 128 // 13 = 9 points a tile; trimmed ones take as
    few points a tile as fill the rounds of 128-point tiles (33,800 points:
    3 rounds of 132 blocks, 394 tiles of 86 points; 16,896: one round of
    full 128-point tiles)."""
    from slice3d_tpu_torch.ops import fused_encoder as fe

    per_tile = 2 * (4 * D * D + 2 * D * 2048)
    assert fe.weight_bytes_per_call(n, 13, head_tokens, grid=grid) == tiles * per_tile


def test_weight_bytes_per_call_defaults_to_the_kernel_tiling():
    assert ff.TILE_ROWS == 64 * ff.KERNEL_TILES["fused_ffn.cu"]["CONSUMERS"] == 192
    assert ff.weight_bytes_per_call(439_400) == ff.weight_bytes_per_call(
        439_400, tile_rows=ff.TILE_ROWS)


def test_prepared_weights_are_reused_until_a_weight_changes():
    """The wrapper casts a weight set once: the same tensors give the same
    prepared set (bf16 weights, fp32 vectors) call after call, and an
    in-place update of one weight, or another tensor in its place, gives a
    new one that holds the new values."""
    rng = np.random.default_rng(3)
    w1, w2 = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((64, D), (D, 64)))
    b1, b2 = torch.zeros(64), torch.zeros(D)
    first = ff.prepared_weights(w1, b1, w2, b2)
    assert ff.prepared_weights(w1, b1, w2, b2) is first
    assert [t.dtype for t in first.weights] == [torch.bfloat16] * 2
    assert [t.dtype for t in first.vectors] == [torch.float32] * 2
    with torch.no_grad():
        w2.mul_(2)
    second = ff.prepared_weights(w1, b1, w2, b2)
    assert second is not first
    torch.testing.assert_close(second.weights[1], w2.to(torch.bfloat16), rtol=0, atol=0)
    assert ff.prepared_weights(w1, b1, w2, b2) is second
    third = ff.prepared_weights(w1.clone(), b1, w2, b2)
    assert third is not second and ff.prepared_weights(w1, b1, w2, b2) is not third


def test_encoder_layer_prepares_its_weights_once():
    """The layer hands the wrapper a fresh dict of the same parameters each
    call: one prepared set serves them until a parameter is updated in place
    (as load_state_dict and optimizers do)."""
    from slice3d_tpu_torch.ops import fused_encoder as fe

    layer = TransformerEncoderLayer(D, 4, 256)
    first = fe.prepared_params(dict(layer.named_parameters()))
    assert fe.prepared_params(dict(layer.named_parameters())) is first
    assert first.weights[0].shape == (3 * D, D) and first.vectors[4].shape == (256,)
    layer.load_state_dict({k: v + 1 for k, v in layer.state_dict().items()})
    second = fe.prepared_params(dict(layer.named_parameters()))
    assert second is not first
    torch.testing.assert_close(second.vectors[4], layer.linear1.bias.detach(), rtol=0, atol=0)
