"""The port's spatial attention against the JAX Pallas kernels (CPU).

``spatial_attention_ref`` is held against
``slice3d_tpu.ops.pallas_attention.spatial_attention`` run in interpret mode,
at atol 1e-5 (fp32 throughout; the two sum in another order), and
``spatial_attention_bwd_ref`` against ``_attention_backward`` in interpret
mode: at atol 1e-5 in fp32 (readings 3.1e-7), and in bf16 within a bf16
rounding flip (|got - want| <= 2e-3 + 1e-2 |want|, readings 4.9e-4 against
gradients up to 0.53, whose bf16 ulp is 2^-9 to 2^-8: both round dS, dq and
the fp32 dk/dv to bf16 at the same points, from fp32 sums taken in another
order).  The
autograd Function passes ``gradcheck`` in fp64.  The wrapper takes the
plain versions for a CPU tensor, and the UNet's routing rule mirrors the
JAX one's shape condition.
"""

import math
import os
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from slice3d_tpu.ops import pallas_attention as jax_attention
from slice3d_tpu_torch.ops import spatial_attention as sa


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores, and a thread pool per worker spends its time waiting for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,scale", [((2, 3, 1024, 24), 1.0 / math.sqrt(24)),
                                         ((1, 2, 1536, 48), 0.25)],
                         ids=["dh24-t1024", "dh48-t1536"])
def test_plain_matches_pallas_interpret(shape, scale):
    q, k, v = _qkv(shape, sum(shape))
    want = jax_attention.spatial_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           scale, interpret=True)
    got = sa.spatial_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_cpu_tensor_takes_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 1024, 24), 5))
    before = sa.launches
    got = sa.spatial_attention(q, k, v, 0.3)
    assert sa.launches == before  # no kernel on the CPU
    torch.testing.assert_close(got, sa.spatial_attention_ref(q, k, v, 0.3), rtol=0, atol=0)
    # bf16 on the CPU too: the plain version rounds where the TPU kernel does
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = sa.spatial_attention(qb, kb, vb, 0.3)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, sa.spatial_attention_ref(qb, kb, vb, 0.3),
                               rtol=0, atol=0)


@pytest.mark.parametrize("t", [256, 512, 1000, 1024, 1536, 2048, 4096, 4608])
def test_eligibility_mirrors_jax(monkeypatch, t):
    """Same shape rule as ``attention_kernel_eligible`` (with the TPU check
    forced on: on the card the port's rule is the shape rule alone)."""
    monkeypatch.setattr(jax_attention, "pallas_available", lambda: True)
    assert sa.attention_kernel_eligible(t) == jax_attention.attention_kernel_eligible(t)
    # every eligible T is one the kernel's tiling takes, and the wrapper's
    # multiple covers every tile of both kernels
    if sa.attention_kernel_eligible(t):
        assert t % sa.KERNEL_T_MULTIPLE == 0
    assert all(sa.KERNEL_T_MULTIPLE % tile == 0
               for tiles in sa.KERNEL_TILES.values() for tile in tiles.values())


def test_kernel_tiles_are_the_sources():
    """``KERNEL_TILES`` states the constants of the kernels' sources, so a
    tile changed in a .cu file without the wrapper fails here on the CPU
    (the UNet would otherwise send a length that the kernel refuses)."""
    for name, tiles in sa.KERNEL_TILES.items():
        with open(os.path.join(sa._CSRC, name)) as f:
            src = f.read()
        for const, size in tiles.items():
            found = re.findall(rf"^constexpr int {const} = (\d+);", src, flags=re.M)
            assert found == [str(size)], (name, const, found)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [24, 48])
def test_bwd_ref_matches_pallas_interpret(dh, dtype):
    shape, scale = (1, 2, 1024, dh), dh ** -0.5
    q, k, v = _qkv(shape, dh)
    do = np.random.default_rng(dh + 1).normal(size=shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = jax_attention._attention_backward(
        *(jnp.asarray(a, jdt) for a in (q, k, v, do)), scale,
        max(512 // 4, 128), interpret=True)
    tdt = getattr(torch, dtype)
    got = sa.spatial_attention_bwd_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v, do)),
                                       scale)
    tol = dict(atol=1e-5, rtol=0) if dtype == "float32" else dict(atol=2e-3, rtol=1e-2)
    for g, w in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol)


def test_autograd_function_passes_gradcheck():
    """fp64 on the CPU: the Function's forward and backward are the plain
    versions, which then compute in fp64."""
    rng = np.random.default_rng(9)
    qkv = [torch.from_numpy(rng.normal(size=(1, 2, 16, 4))).requires_grad_()
           for _ in range(3)]
    assert torch.autograd.gradcheck(lambda q, k, v: sa.spatial_attention(q, k, v, 0.7), qkv)


def test_bwd_ref_blocks_accumulate_like_one_block():
    """Three query blocks (128, 128 and a ragged 44 rows, fp64) give
    autograd's gradients of the plain forward."""
    rng = np.random.default_rng(10)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 1, 300, 4))) for _ in range(4))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(sa.spatial_attention_ref(*qkv, 0.4), qkv, do)
    for g, w in zip(sa.spatial_attention_bwd_ref(q, k, v, do, 0.4), want):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-10)


def test_cpu_grad_takes_the_plain_backward():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 1024, 24), 11))
    do = torch.from_numpy(np.random.default_rng(12).normal(size=q.shape).astype(np.float32))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (sa.launches, sa.launches_bwd)
    out = sa.spatial_attention(*qkv, 0.2)
    assert out.grad_fn is not None  # the Function, not a tensor cut from the graph
    got = torch.autograd.grad(out, qkv, do)
    assert (sa.launches, sa.launches_bwd) == before  # no kernel on the CPU
    for g, w in zip(got, sa.spatial_attention_bwd_ref(q, k, v, do, 0.2)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
