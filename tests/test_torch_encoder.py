"""The port's fused encoder layer against the JAX Pallas kernel.

On the CPU the Pallas kernel runs in interpret mode, exactly as
tests/test_pallas_kernels.py runs it, and the port's wrapper takes the plain
PyTorch version (its CUDA kernel has no CPU mode).  The kernel itself is
compared with the plain version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from slice3d_tpu_torch.models.layers import TransformerEncoderLayer
from slice3d_tpu_torch.ops import fused_encoder as fe

D, F = 128, 2048


def flax_layer_params(seed, scale=0.05):
    rng = np.random.default_rng(seed)

    def g(*shape, s=scale):
        return rng.normal(size=shape).astype(np.float32) * s

    return {
        "qkv": {"kernel": g(D, 3 * D), "bias": g(3 * D, s=0.02)},
        "out_proj": {"kernel": g(D, D), "bias": g(D, s=0.02)},
        "ff1": {"kernel": g(D, F), "bias": g(F, s=0.02)},
        "ff2": {"kernel": g(F, D), "bias": g(D, s=0.02)},
        "norm1": {"scale": 1 + g(D, s=0.1), "bias": g(D, s=0.1)},
        "norm2": {"scale": 1 + g(D, s=0.1), "bias": g(D, s=0.1)},
    }


def port_params(p):
    """Flax layer tree -> the layer's torch parameter names."""
    tt = lambda a: torch.from_numpy(np.array(a))
    return {
        "self_attn.in_proj_weight": tt(p["qkv"]["kernel"].T),
        "self_attn.in_proj_bias": tt(p["qkv"]["bias"]),
        "self_attn.out_proj.weight": tt(p["out_proj"]["kernel"].T),
        "self_attn.out_proj.bias": tt(p["out_proj"]["bias"]),
        "linear1.weight": tt(p["ff1"]["kernel"].T), "linear1.bias": tt(p["ff1"]["bias"]),
        "linear2.weight": tt(p["ff2"]["kernel"].T), "linear2.bias": tt(p["ff2"]["bias"]),
        "norm1.weight": tt(p["norm1"]["scale"]), "norm1.bias": tt(p["norm1"]["bias"]),
        "norm2.weight": tt(p["norm2"]["scale"]), "norm2.bias": tt(p["norm2"]["bias"]),
    }


@pytest.mark.parametrize("head_tokens", [0, 1])
def test_encoder_layer_matches_pallas_interpret(monkeypatch, head_tokens):
    monkeypatch.setenv("SLICE3D_PALLAS_INTERPRET", "1")
    from slice3d_tpu.ops.pallas_encoder import fused_encoder_layer as pallas_layer

    rng = np.random.default_rng(10 + head_tokens)
    x = rng.normal(size=(1, 300, 13, D)).astype(np.float32)  # 300: no block multiple
    fp = flax_layer_params(20 + head_tokens)
    want = np.asarray(pallas_layer(jnp.asarray(x), fp, n_heads=4,
                                   head_tokens=head_tokens))
    params = port_params(fp)
    tol = dict(atol=5e-5, rtol=1e-4)

    before = fe.launches
    ref = fe.fused_encoder_layer_ref(torch.from_numpy(x), params, head_tokens=head_tokens)
    np.testing.assert_allclose(ref.numpy(), want, **tol)
    # the wrapper takes the plain version for a CPU tensor, and counts no launch
    wrapped = fe.fused_encoder_layer(torch.from_numpy(x), params, head_tokens=head_tokens)
    np.testing.assert_array_equal(wrapped.numpy(), ref.numpy())
    assert fe.launches == before

    for route in ("fused", "plain"):
        layer = TransformerEncoderLayer(D, 4, F, head_tokens=head_tokens, route=route)
        layer.load_state_dict(params)
        with torch.no_grad():
            got = layer(torch.from_numpy(x))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, **tol)


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 2, 13, D), device="meta")
    with pytest.raises(ValueError):
        fe.fused_encoder_layer(x, port_params(flax_layer_params(0)))
