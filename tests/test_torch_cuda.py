"""Card-only tests of the port's CUDA kernels (marked ``cuda``).

They skip without a card.  The machine with the card has no JAX, so this file
imports none, and it runs without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from slice3d_tpu_torch.ops import fused_encoder as fe

D, F = 128, 2048


def layer_params(seed, device):
    rng = np.random.default_rng(seed)

    def g(*shape, s=0.05):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * s).to(device)

    return {
        "self_attn.in_proj_weight": g(3 * D, D), "self_attn.in_proj_bias": g(3 * D, s=0.02),
        "self_attn.out_proj.weight": g(D, D), "self_attn.out_proj.bias": g(D, s=0.02),
        "linear1.weight": g(F, D), "linear1.bias": g(F, s=0.02),
        "linear2.weight": g(D, F), "linear2.bias": g(D, s=0.02),
        "norm1.weight": 1 + g(D, s=0.1), "norm1.bias": g(D, s=0.1),
        "norm2.weight": 1 + g(D, s=0.1), "norm2.bias": g(D, s=0.1),
    }


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 2000], ids=["one", "ragged", "many"])
@pytest.mark.parametrize("head_tokens", [0, 1])
def test_kernel_matches_plain(card, n, head_tokens):
    """bf16 kernel vs the plain version on the same bf16 inputs: both round
    at the same points, so they differ by bf16 rounding flips only (a flip
    of a LayerNorm output in [4, 8) is 0.03125: hence rtol)."""
    rng = np.random.default_rng(30 + head_tokens)
    x = torch.from_numpy(rng.normal(size=(2, n, 13, D)).astype(np.float32))
    x = x.to(card).to(torch.bfloat16)
    params = layer_params(40, card)
    before = fe.launches
    got = fe.fused_encoder_layer(x, params, head_tokens=head_tokens)
    torch.cuda.synchronize()
    assert fe.launches == before + 1
    want = fe.fused_encoder_layer_ref(x, params, head_tokens=head_tokens)
    assert got.shape == want.shape == (2, n, head_tokens or 13, D)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    params = layer_params(41, card)
    x = torch.zeros((1, 4, 13, D), device=card)
    with pytest.raises(TypeError):  # fp32 has no instantiation
        fe.fused_encoder_layer(x, params)
    with pytest.raises(ValueError):
        fe.fused_encoder_layer(x.to(torch.bfloat16), params, head_tokens=2)
    with pytest.raises(ValueError):
        fe.fused_encoder_layer(torch.zeros((1, 4, 17, D), device=card,
                                           dtype=torch.bfloat16), params)
