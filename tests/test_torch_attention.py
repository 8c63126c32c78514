"""The port's spatial attention against the JAX Pallas kernel (CPU, fp32).

``spatial_attention_ref`` is held against
``slice3d_tpu.ops.pallas_attention.spatial_attention`` run in interpret mode,
at atol 1e-5 (fp32 throughout; the two sum in another order).  The wrapper
takes the plain version for a CPU tensor, and the UNet's routing rule
mirrors the JAX one's shape condition.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from slice3d_tpu.ops import pallas_attention as jax_attention
from slice3d_tpu_torch.ops import spatial_attention as sa


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
    # every eligible T is one the kernel's tiling takes
    if sa.attention_kernel_eligible(t):
        assert t % sa.KERNEL_T_MULTIPLE == 0
