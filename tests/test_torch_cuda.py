"""Card-only tests of the port's CUDA kernels (marked ``cuda``).

They skip without a card.  The machine with the card has no JAX, so this file
imports none, and it runs without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from slice3d_tpu_torch import camera
from slice3d_tpu_torch.models import layers
from slice3d_tpu_torch.models.slicenet import init_slicenet
from slice3d_tpu_torch.ops import fused_encoder as fe
from slice3d_tpu_torch.ops import fused_ffn as ff
from slice3d_tpu_torch.ops import spatial_attention as sa
from slice3d_tpu_torch.pipeline import Reconstructor

D, F = 128, 2048
# kernel vs plain spatial attention: bf16 rounding of the probabilities
ATTN_TOL = dict(atol=1e-2, rtol=2e-2)
# backward kernel vs plain (dq, dk, dv): D = rowsum(do o) from the bf16 output
# against the plain version's fp32 rowsum(dp p), and bf16 rounding of dS (the
# tolerance of chip_smoke.py, where the readings are written down)
ATTN_BWD_TOL = dict(atol=0.08, rtol=0.04)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 1024, 24), (1, 2, 4096, 24),
                                   (2, 3, 1024, 48), (1, 2, 1536, 48)],
                         ids=["dh24-t1024", "dh24-t4096", "dh48-t1024", "dh48-t1536"])
def test_spatial_attention_matches_plain(card, shape):
    """bf16 kernel vs the plain version on the same bf16 inputs.  The kernel
    rounds the unnormalised exp(s - m) to bf16 and divides at the end, the
    plain version normalises and then rounds: they differ by bf16 rounding
    of the probabilities, a few bf16 ulps of the output."""
    rng = np.random.default_rng(sum(shape))
    # q, k ~ N(0, 4): a peaked softmax with outputs of order 1
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * s)
               .to(card).to(torch.bfloat16) for s in (2.0, 2.0, 1.0))
    scale = shape[-1] ** -0.5
    before = sa.launches
    got = sa.spatial_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert sa.launches == before + 1
    want = sa.spatial_attention_ref(q, k, v, scale)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)


@pytest.mark.cuda
def test_spatial_attention_rejects_what_it_does_not_take(card):
    x = torch.zeros((1, 2, 1024, 24), device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # fp32 has no instantiation
        sa.spatial_attention(x.float(), x.float(), x.float(), 0.2)
    with pytest.raises(ValueError):  # ragged T
        y = torch.zeros((1, 2, 1000, 24), device=card, dtype=torch.bfloat16)
        sa.spatial_attention(y, y, y, 0.2)
    with pytest.raises(ValueError):  # T a multiple of 64 but not of the 128-row tiles
        y = torch.zeros((1, 2, 1088, 24), device=card, dtype=torch.bfloat16)
        sa.spatial_attention(y, y, y, 0.2)
    with pytest.raises(ValueError):  # a head width with no instantiation
        y = torch.zeros((1, 2, 1024, 40), device=card, dtype=torch.bfloat16)
        sa.spatial_attention(y, y, y, 0.2)
    with pytest.raises(ValueError):  # k on the CPU
        sa.spatial_attention(x, x.cpu(), x, 0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 1024, 24), (1, 2, 4096, 24),
                                   (2, 3, 1024, 48), (1, 2, 1536, 48)],
                         ids=["dh24-t1024", "dh24-t4096", "dh48-t1024", "dh48-t1536"])
def test_spatial_attention_backward_matches_plain(card, shape):
    """Through autograd: the forward kernel saves the rows' log-sum-exp, the
    backward kernel gives dq, dk, dv of the plain backward's rounding."""
    rng = np.random.default_rng(sum(shape) + 1)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * s)
                   .to(card).to(torch.bfloat16) for s in (2.0, 2.0, 1.0, 1.0))
    scale = shape[-1] ** -0.5
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (sa.launches, sa.launches_bwd)
    out = sa.spatial_attention(*qkv, scale)
    got = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    assert (sa.launches, sa.launches_bwd) == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, sa.spatial_attention_bwd_ref(q, k, v, do, scale)):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), **ATTN_BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [24, 48])
def test_spatial_attention_one_head_at_the_shortest_length(card, dh):
    """bh = 1 and T = 1024, the shortest length the UNet routes to the
    kernels: one block row of each grid, both ways."""
    shape = (1, 1, 1024, dh)
    rng = np.random.default_rng(dh + 2)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * s)
                   .to(card).to(torch.bfloat16) for s in (2.0, 2.0, 1.0, 1.0))
    scale = dh ** -0.5
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (sa.launches, sa.launches_bwd)
    out = sa.spatial_attention(*qkv, scale)
    got = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    assert (sa.launches, sa.launches_bwd) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out.detach().float(),
                               sa.spatial_attention_ref(q, k, v, scale).float(), **ATTN_TOL)
    for g, w in zip(got, sa.spatial_attention_bwd_ref(q, k, v, do, scale)):
        torch.testing.assert_close(g.float(), w.float(), **ATTN_BWD_TOL)


@pytest.mark.cuda
def test_spatial_attention_backward_repeats(card):
    """Two runs on the same inputs: dk and dv bit-equal (each block owns its
    keys), dq within one bf16 ulp of its magnitude (its fp32 sum over the
    key blocks is taken in the order their additions reach L2)."""
    shape = (2, 4, 4096, 24)
    rng = np.random.default_rng(77)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * s)
                   .to(card).to(torch.bfloat16) for s in (2.0, 2.0, 1.0, 1.0))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = sa.spatial_attention(*qkv, 24 ** -0.5)
    runs = [torch.autograd.grad(out, qkv, do, retain_graph=True) for _ in range(2)]
    torch.cuda.synchronize()
    (dq1, dk1, dv1), (dq2, dk2, dv2) = runs
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    mag = torch.maximum(dq1.float().abs(), dq2.float().abs())
    # one bf16 ulp of |x|: 2^(floor(log2 |x|) - 7)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    assert bool(((dq1.float() - dq2.float()).abs() <= ulp).all())


@pytest.mark.cuda
def test_spatial_attention_without_grad_launches_the_forward_alone(card):
    x = torch.zeros((1, 2, 1024, 24), device=card, dtype=torch.bfloat16)
    before = (sa.launches, sa.launches_bwd)
    out = sa.spatial_attention(x, x, x, 0.2)  # no input requires grad
    assert out.grad_fn is None and (sa.launches, sa.launches_bwd) == (before[0] + 1,
                                                                      before[1])
    with pytest.raises(TypeError):  # fp32 has no instantiation, with grad either
        y = torch.zeros((1, 2, 1024, 24), device=card, requires_grad=True)
        sa.spatial_attention(y, y, y, 0.2)


@pytest.mark.cuda
def test_fused_encoder_kernel_refuses_autograd(card):
    params = {k: v.requires_grad_() for k, v in layer_params(42, card).items()}
    x = torch.zeros((1, 4, 13, D), device=card, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="inference only"):
        fe.fused_encoder_layer(x, params)
    with torch.no_grad():
        assert fe.fused_encoder_layer(x, params).shape == (1, 4, 13, D)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 2000], ids=["one", "ragged", "many"])
def test_fused_ffn_matches_plain(card, n):
    """bf16 kernel vs the plain version on the same bf16 inputs: both round
    h and the output to bf16 from fp32 sums, in another order (a flip of an
    output in [2, 4) is 2^-6: hence rtol)."""
    params = layer_params(50, card)
    x = torch.from_numpy(np.random.default_rng(n).normal(size=(3, n, D)).astype(np.float32))
    x = x.to(card).to(torch.bfloat16)
    args = [params[k] for k in ("linear1.weight", "linear1.bias", "linear2.weight",
                                "linear2.bias")]
    before = ff.launches
    got = ff.fused_ffn(x, *args)
    torch.cuda.synchronize()
    assert ff.launches == before + 1
    want = ff.fused_ffn_ref(x, *args)
    assert got.shape == want.shape == (3, n, D) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)


@pytest.mark.cuda
def test_fused_ffn_rejects_what_it_does_not_take(card):
    params = layer_params(51, card)
    args = [params[k] for k in ("linear1.weight", "linear1.bias", "linear2.weight",
                                "linear2.bias")]
    x = torch.zeros((4, D), device=card)
    with pytest.raises(TypeError):  # fp32 has no instantiation
        ff.fused_ffn(x, *args)
    with pytest.raises(ValueError):  # F not a multiple of 64
        ff.fused_ffn(x.to(torch.bfloat16), args[0][:100], args[1][:100], args[2][:, :100],
                     args[3])
    with pytest.raises(ValueError):  # a weight on the CPU
        ff.fused_ffn(x.to(torch.bfloat16), args[0].cpu(), *args[1:])
    with pytest.raises(RuntimeError, match="inference only"):
        ff.fused_ffn(x.to(torch.bfloat16), args[0].requires_grad_(), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("head_tokens", [0, 1])
def test_split_route_on_the_card(card, head_tokens, monkeypatch):
    """The split layer launches the FFN kernel once and no encoder kernel,
    and agrees with itself on the FFN's plain version within bf16 flips of
    the LayerNorm outputs."""
    layer = layers.TransformerEncoderLayer(D, 4, F, head_tokens=head_tokens, route="split")
    layer.load_state_dict({k: v.cpu() for k, v in layer_params(52, card).items()})
    layer = layer.to(card)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 300, 13, D))
                         .astype(np.float32)).to(card).to(torch.bfloat16)
    before = (fe.launches, ff.launches)
    with torch.no_grad():
        got = layer(x)
        torch.cuda.synchronize()
        assert (fe.launches, ff.launches) == (before[0], before[1] + 1)
        monkeypatch.setattr(layers, "fused_ffn", ff.fused_ffn_ref)
        want = layer(x)
    assert got.shape == want.shape == (2, 300, head_tokens or 13, D)
    torch.testing.assert_close(got.float(), want.float(), atol=5e-2, rtol=2e-2)


@pytest.mark.cuda
def test_batched_reconstruction_on_the_card(card):
    """B = 2 through the fused kernel: each object's field is that of a
    batch-1 run, within bf16 rounding flips, and every chunk launched it."""
    model = init_slicenet(0, dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    _, proj = camera.camera_matrices(0.0, 0.0, 1.2)
    feeds = [{"img_input": rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32),
              "trans_mat_wo_rot_tp": proj.astype(np.float32)} for _ in range(2)]
    kw = dict(resolution0=16, upsampling_steps=1, chunk_size=4096)
    before = fe.launches
    grids, stats = Reconstructor(model, batch_size=2, **kw).build_grids(feeds)
    assert fe.launches > before
    for feed, grid, st in zip(feeds, grids, stats):
        one, one_stats = Reconstructor(model, **kw).build_grid(feed)
        assert grid.shape == one.shape == (33, 33, 33) and np.isfinite(grid).all()
        assert abs(st["n_points_evaluated"] - one_stats["n_points_evaluated"]) \
            <= 0.01 * one_stats["n_points_evaluated"]
        np.testing.assert_allclose(grid, one, atol=5e-2, rtol=0)
