"""Card-only tests of the port's CUDA kernels (marked ``cuda``).

They skip without a card.  The machine with the card has no JAX, so this file
imports none, and it runs without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib
import math

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
# the fp32 kernels vs their plain versions with TF32 off: both in true fp32,
# apart by summation order and the exponential; the plain version with TF32
# matmuls must fail these (chip_smoke.py phase 19, where the readings are)
ATTN_F32_TOL = dict(atol=5e-5, rtol=5e-5)
ATTN_BWD_F32_TOL = dict(atol=2e-4, rtol=1e-4)
# the fp32 head kernels vs their plain versions with TF32 off: both in true
# fp32, apart by summation order (and the exponential in the layer); the
# plain versions with TF32 matmuls must fail it (chip_smoke.py phase 3,
# where the readings are)
HEAD_F32_TOL = dict(atol=1e-5, rtol=1e-5)


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
    with pytest.raises(TypeError):  # fp16 has no kernel (bf16 and fp32 have)
        fe.fused_encoder_layer(x.half(), params)
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
    with pytest.raises(TypeError):  # fp16 has no instantiation
        sa.spatial_attention(x.half(), x.half(), x.half(), 0.2)
    with pytest.raises(TypeError):  # one dtype a call
        sa.spatial_attention(x.float(), x, x.float(), 0.2)
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
    with pytest.raises(TypeError):  # fp16 has no instantiation, with grad either
        y = torch.zeros((1, 2, 1024, 24), device=card, dtype=torch.float16,
                        requires_grad=True)
        sa.spatial_attention(y, y, y, 0.2)


@contextlib.contextmanager
def _tf32_matmuls():
    """The plain versions' matmuls in TF32 within: the control the fp32
    tolerances must tell from fp32."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _violations(got, want, tol) -> int:
    return int(((got - want).abs() > tol["atol"] + tol["rtol"] * want.abs()).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 1024, 24), (1, 2, 4096, 24),
                                   (2, 3, 1024, 48), (1, 2, 1536, 48)],
                         ids=["dh24-t1024", "dh24-t4096", "dh48-t1024", "dh48-t1536"])
def test_spatial_attention_f32_matches_plain(card, shape):
    """fp32 kernel vs the plain version on the same fp32 inputs (TF32 off):
    summation order and the exponential apart; the plain version with TF32
    matmuls fails the same tolerance.  Launches count on the fp32 counter."""
    rng = np.random.default_rng(sum(shape) + 5)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * s).to(card)
               for s in (2.0, 2.0, 1.0))
    scale = shape[-1] ** -0.5
    before = (sa.launches, sa.launches_f32)
    got = sa.spatial_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert (sa.launches, sa.launches_f32) == (before[0], before[1] + 1)
    want = sa.spatial_attention_ref(q, k, v, scale)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **ATTN_F32_TOL)
    with _tf32_matmuls():
        assert _violations(sa.spatial_attention_ref(q, k, v, scale), want, ATTN_F32_TOL) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 1024, 24), (1, 2, 4096, 24),
                                   (2, 3, 1024, 48), (1, 2, 1536, 48)],
                         ids=["dh24-t1024", "dh24-t4096", "dh48-t1024", "dh48-t1536"])
def test_spatial_attention_f32_backward_matches_plain(card, shape):
    """Through autograd in fp32: the fp32 forward kernel saves the rows'
    log-sum-exp, the fp32 backward kernels give dq, dk, dv of the plain
    backward within ``ATTN_BWD_F32_TOL``, which the plain backward with TF32
    matmuls fails; launches count on the fp32 counters alone."""
    rng = np.random.default_rng(sum(shape) + 6)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * s).to(card)
                   for s in (2.0, 2.0, 1.0, 1.0))
    scale = shape[-1] ** -0.5
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (sa.launches, sa.launches_bwd, sa.launches_f32, sa.launches_bwd_f32)
    out = sa.spatial_attention(*qkv, scale)
    got = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    assert (sa.launches, sa.launches_bwd, sa.launches_f32, sa.launches_bwd_f32) == (
        before[0], before[1], before[2] + 1, before[3] + 1)
    want = sa.spatial_attention_bwd_ref(q, k, v, do, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, **ATTN_BWD_F32_TOL)
    with _tf32_matmuls():
        control = sa.spatial_attention_bwd_ref(q, k, v, do, scale)
    assert sum(_violations(c, w, ATTN_BWD_F32_TOL) for c, w in zip(control, want)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [24, 48])
def test_spatial_attention_f32_forward_repeats(card, dh):
    """The fp32 forward sums in a fixed order (no atomics): two runs give
    bit-equal outputs and row log-sum-exps, and the log-sum-exp the
    backward reads is the exact one (fp64) to within ``ATTN_F32_TOL``'s
    atol in log2 units: an error d in L is a relative error d ln 2 in
    every probability the backward recomputes from it."""
    shape = (2, 4, 4096 if dh == 24 else 1024, dh)
    rng = np.random.default_rng(77 + dh)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * s).to(card)
               for s in (2.0, 2.0, 1.0))
    scale = dh ** -0.5
    runs = [sa._forward_kernel(q, k, v, scale, with_lse=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    exact = torch.logsumexp((q.double() @ k.double().transpose(-1, -2)) * scale, -1)
    torch.testing.assert_close(runs[0][1].double(), exact / math.log(2),
                               atol=ATTN_F32_TOL["atol"], rtol=0)


@pytest.mark.cuda
def test_spatial_attention_f32_backward_repeats(card):
    """The fp32 backward sums every gradient in a fixed order (no atomics):
    two runs on the same inputs give bit-equal dq, dk, dv."""
    shape = (2, 4, 4096, 24)
    rng = np.random.default_rng(78)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * s).to(card)
                   for s in (2.0, 2.0, 1.0, 1.0))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = sa.spatial_attention(*qkv, 24 ** -0.5)
    runs = [torch.autograd.grad(out, qkv, do, retain_graph=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


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
    with pytest.raises(TypeError):  # fp16 has no kernel (bf16 and fp32 have)
        ff.fused_ffn(x.half(), *args)
    with pytest.raises(ValueError):  # F not a multiple of 64
        ff.fused_ffn(x.to(torch.bfloat16), args[0][:100], args[1][:100], args[2][:, :100],
                     args[3])
    with pytest.raises(ValueError):  # a weight on the CPU
        ff.fused_ffn(x.to(torch.bfloat16), args[0].cpu(), *args[1:])
    with pytest.raises(RuntimeError, match="inference only"):
        ff.fused_ffn(x.to(torch.bfloat16), args[0].requires_grad_(), *args[1:])


def _encoder_case(card, n, t, head_tokens, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(1, n, t, D)).astype(np.float32))
    return x.to(card).to(torch.bfloat16), layer_params(seed + 1, card)


# A full-layer tile packs 128 // 13 = 9 points.  A trimmed tile holds
# ceil(N / (rounds * SMs)) points, rounds being the waves of one persistent
# block an SM that 128-point tiles would take: N = 128 SMs is one wave of
# full 128-point tiles, one point less leaves the last tile a point short,
# and one point more takes two waves of 65-point tiles.  ("sms", k) stands
# for N = 128 points an SM of the card, plus k.
@pytest.mark.cuda
@pytest.mark.parametrize("head_tokens,n", [
    (0, 17), (0, 19), (0, 9 * 132 * 2 + 5),
    (1, 127), (1, 129), (1, 128 * 132 + 7),
    (1, ("sms", 0)), (1, ("sms", -1)), (1, ("sms", 1))],
    ids=["full-edge-1", "full-edge+1", "full-two-waves",
         "trim-edge-1", "trim-edge+1", "trim-two-waves",
         "trim-full-tiles", "trim-full-tiles-1", "trim-full-tiles+1"])
def test_encoder_tile_edges_and_waves(card, head_tokens, n):
    """N one point before and after a tile's edge, N whose trimmed tiles are
    full 128-point tiles, and N over more than one wave of persistent
    blocks: every point matches the plain version."""
    if isinstance(n, tuple):
        n = 128 * torch.cuda.get_device_properties(card).multi_processor_count + n[1]
    x, params = _encoder_case(card, n, 13, head_tokens, 60 + n % 7)
    got = fe.fused_encoder_layer(x, params, head_tokens=head_tokens)
    torch.cuda.synchronize()
    want = fe.fused_encoder_layer_ref(x, params, head_tokens=head_tokens)
    assert got.shape == want.shape == (1, n, head_tokens or 13, D)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 13, 16])
@pytest.mark.parametrize("head_tokens", [0, 1])
def test_encoder_token_counts(card, t, head_tokens):
    """T = 1 (128 points a tile), 13 (the head's) and 16 (8 points, no spare
    rows)."""
    x, params = _encoder_case(card, 301, t, head_tokens, 70 + t)
    got = fe.fused_encoder_layer(x, params, head_tokens=head_tokens)
    torch.cuda.synchronize()
    want = fe.fused_encoder_layer_ref(x, params, head_tokens=head_tokens)
    assert got.shape == want.shape == (1, 301, head_tokens or t, D)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("head_tokens", [0, 1])
def test_encoder_runs_repeat_bit_for_bit(card, head_tokens):
    x, params = _encoder_case(card, 3000, 13, head_tokens, 80)
    a = fe.fused_encoder_layer(x, params, head_tokens=head_tokens)
    b = fe.fused_encoder_layer(x, params, head_tokens=head_tokens)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [129, 191, 192, 193, 255, 257, 384, 2 * 132 * 192 + 77])
def test_fused_ffn_ragged_tail(card, rows):
    """Rows past N are never stored: N one row before, at and after the
    edges of the kernel's 192-row tiles (192, 384), ragged tails inside a
    tile, and a call over more than one wave of blocks."""
    params = layer_params(53, card)
    args = [params[k] for k in ("linear1.weight", "linear1.bias", "linear2.weight",
                                "linear2.bias")]
    x = torch.from_numpy(np.random.default_rng(rows).normal(size=(rows + 64, D))
                         .astype(np.float32)).to(card).to(torch.bfloat16)
    got = ff.fused_ffn(x[:rows], *args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ff.fused_ffn_ref(x[:rows], *args).float(),
                               atol=2e-2, rtol=1e-2)


@pytest.mark.cuda
def test_weights_are_prepared_once_on_the_card(card):
    """Two calls share one prepared set (casts and maps); an in-place update
    of a weight makes a new one, and the kernel then computes with it."""
    x, params = _encoder_case(card, 50, 13, 0, 95)
    fe.fused_encoder_layer(x, params)
    prep = fe.prepared_params(params)
    assert prep.maps is not None
    fe.fused_encoder_layer(x, params)
    assert fe.prepared_params(params) is prep
    with torch.no_grad():
        params["linear2.weight"].mul_(-1)
    got = fe.fused_encoder_layer(x, params)
    torch.cuda.synchronize()
    assert fe.prepared_params(params) is not prep
    torch.testing.assert_close(got.float(), fe.fused_encoder_layer_ref(x, params).float(),
                               atol=2e-2, rtol=1e-2)


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


@pytest.fixture
def no_tf32():
    """fp32 convolutions and matmuls on the card without TF32."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


@pytest.mark.cuda
def test_card_metrics_match_cpu(card):
    """Chamfer, F-score, Hausdorff and ICP on the card (fp32 matmul blocks)
    against the CPU (the JAX package's fused multiply-add chains): squared
    distances within a few ulps of |a|^2, the means to relative 1e-5, the
    threshold counts within 2 points."""
    from slice3d_tpu_torch.eval import icp, metrics

    rng = np.random.default_rng(40)
    a = rng.uniform(-0.5, 0.5, (20000, 3)).astype(np.float32)
    b = (a[:15000] + rng.normal(0, 0.006, (15000, 3))).astype(np.float32)
    d2, idx = metrics.nearest(a, b)
    c_d2, c_idx = metrics.nearest(a, b, device="cpu")
    np.testing.assert_allclose(d2, c_d2, atol=1e-6, rtol=0)
    assert (idx == c_idx).mean() > 0.999
    small = metrics.nearest(a, b, block_elems=15000 * 1000)
    np.testing.assert_array_equal(small[0], d2)
    got, want = metrics.chamfer_metrics(a, b), metrics.chamfer_metrics(a, b, device="cpu")
    for k in ("chamfer_l1", "chamfer_l2"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    for k, n in (("precision", len(a)), ("recall", len(b))):
        assert abs(got[k] - want[k]) <= 2 / n, k
    assert metrics.hausdorff_distance(a, b) == pytest.approx(
        metrics.hausdorff_distance(a, b, device="cpu"), rel=1e-4)
    ang = 0.1
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    dst = (a[:3000] @ r.T + 0.02)[rng.permutation(3000)]
    tm, _, _ = icp.icp(a[:3000], dst)
    c_tm, _, _ = icp.icp(a[:3000], dst, device="cpu")
    np.testing.assert_allclose(tm, c_tm, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_refine_step_on_the_card_matches_cpu(card, no_tf32):
    """One polish step against an analytic field, and two through SliceNet's
    plain fp32 head, on the card and on the CPU with the same draws."""
    from slice3d_tpu_torch import pipeline
    from slice3d_tpu_torch.mesh import isosurface
    from slice3d_tpu_torch.mesh.refine import refine_mesh

    g = np.linspace(-0.5, 0.5, 17).astype(np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    m = isosurface((0.3 - np.sqrt(x * x + y * y + z * z)).astype(np.float32), 0.0)
    verts = (m.vertices / 16 - 0.5).astype(np.float32)
    table = np.random.default_rng(41).dirichlet(np.full(3, 0.5), (2, 1 << 16)).astype(np.float32)

    def draws(step, n):
        return table[step, :n]

    def logit(p):
        return (0.3 - torch.linalg.vector_norm(p, dim=-1)) * 20.0

    got, losses = refine_mesh(verts, m.faces, logit, steps=1, lr=1e-3, draws=draws)
    want, c_losses = refine_mesh(verts, m.faces, logit, steps=1, lr=1e-3, draws=draws,
                                 device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(losses, c_losses, rtol=1e-4)

    model = init_slicenet(0, route="plain")
    _, proj = camera.camera_matrices(0.0, 0.0, 1.2)
    feed = {"img_input": np.random.default_rng(42).uniform(-1, 1, (64, 64, 3)).astype(np.float32),
            "trans_mat_wo_rot_tp": proj.astype(np.float32)}
    probe, _ = Reconstructor(model, resolution0=8, upsampling_steps=0,
                             device="cpu").build_grid(feed)
    mid = np.sort(probe.reshape(-1))[probe.size // 2:probe.size // 2 + 2].mean()
    kw = dict(resolution0=16, upsampling_steps=0, refine_steps=2,
              threshold=float(1 / (1 + np.exp(-mid))))
    orig = pipeline.refine_mesh
    # one draw table at both steps, so that the two steps' losses compare
    pipeline.refine_mesh = lambda *a, **k: orig(*a, draws=lambda step, n: table[0, :n], **k)
    try:
        mesh, stats = Reconstructor(model, **kw).reconstruct(feed)
        c_mesh, c_stats = Reconstructor(model, device="cpu", **kw).reconstruct(feed)
    finally:
        pipeline.refine_mesh = orig
    np.testing.assert_array_equal(mesh.faces, c_mesh.faces)
    np.testing.assert_allclose(mesh.vertices, c_mesh.vertices, atol=1e-3, rtol=0)
    assert stats["refine_loss_last"] < stats["refine_loss_first"]


@pytest.mark.cuda
def test_disn_and_camnet_on_the_card(card, no_tf32):
    """DISN's fp32 logit grid and CameraNet's fp32 pose on the card against
    the CPU; the bf16 DISN grid within bf16 rounding of the fp32 one."""
    from slice3d_tpu_torch.models.camnet import init_camnet
    from slice3d_tpu_torch.models.disn import init_disn

    rng = np.random.default_rng(43)
    img = rng.uniform(-1, 1, (128, 128, 3)).astype(np.float32)
    feed = {"img_input": img,
            "trans_mat_right": camera.full_projection_matrix(0.4, 0.2, 1.2).astype(np.float32),
            "obj_rot_mat": camera.camera_matrices(0.4, 0.2, 1.2)[0].astype(np.float32)}
    kw = dict(resolution0=16, upsampling_steps=1, chunk_size=4096)
    model = init_disn(0)
    grid, stats = Reconstructor(model, **kw).build_grid(feed)
    c_grid, c_stats = Reconstructor(model, device="cpu", **kw).build_grid(feed)
    np.testing.assert_allclose(grid, c_grid, atol=1e-3, rtol=0)
    bf16, _ = Reconstructor(init_disn(0, dtype=torch.bfloat16), **kw).build_grid(feed)
    assert np.isfinite(bf16).all()
    np.testing.assert_allclose(bf16, grid, atol=5e-2 * float(np.abs(grid).max()), rtol=0)
    cam = init_camnet(0)
    with torch.no_grad():
        out = cam.to(card)(torch.from_numpy(img[None]).to(card))
        c_out = cam.cpu()(torch.from_numpy(img[None]))
    for k in out:
        np.testing.assert_allclose(out[k].cpu().numpy(), c_out[k].numpy(), atol=1e-4, rtol=0)


def _reg_batch(seed, b=2, size=32, q=16):
    rng = np.random.default_rng(seed)
    cams = [camera.camera_matrices(az, el, 1.2) for az, el in
            rng.uniform((0.0, -0.17), (2 * np.pi, 0.7), (b, 2))]
    qry = rng.uniform(-0.5, 0.5, (b, q, 3)).astype(np.float32)
    sdf = (np.linalg.norm(qry, axis=-1) - 0.3).astype(np.float32)
    return {"img_input": rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32),
            "img_slices": rng.uniform(-1, 1, (b, 12, size, size, 3)).astype(np.float32),
            "qry_norot": qry, "sdf": sdf, "occ": (sdf <= 0).astype(np.float32),
            "obj_rot_mat": np.stack([c[0] for c in cams]).astype(np.float32),
            "trans_mat_wo_rot_tp": np.stack([c[1] for c in cams]).astype(np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["slicenet", "gtslice"])
def test_regression_train_step_on_the_card_matches_cpu(card, no_tf32, name):
    """One fp32 step (SliceNet with the VGG19 term) on the card and on the CPU
    from the same weights: logs to relative 1e-4, gradients within 5e-3 of
    the largest gradient + 1e-2 relative (chip_smoke.py's REG_GRAD_FP32_TOL),
    BatchNorm statistics at 1e-5; no head kernel launches."""
    from slice3d_tpu_torch.config import Options
    from slice3d_tpu_torch.models.random_init import random_init_
    from slice3d_tpu_torch.models.vgg import VGG19Features
    from slice3d_tpu_torch.train.train_reg import RegressionTrainer

    vgg = random_init_(VGG19Features(), torch.Generator().manual_seed(1))
    batch = _reg_batch(2)
    runs = {}
    fe.launches = ff.launches = 0
    for dev in ("cpu", "cuda"):
        tr = RegressionTrainer(Options(name_model=name, img_size=32, n_qry=16, n_bs=2),
                               vgg19=vgg if name == "slicenet" else None, device=dev)
        st, logs = tr.train_step(tr.init_state(seed=3), batch)
        runs[dev] = ({k: float(v) for k, v in logs.items()},
                     {n: p.grad.cpu() for n, p in st.model.named_parameters()},
                     {n: b.cpu() for n, b in st.model.named_buffers()})
    torch.cuda.synchronize()
    assert fe.launches == ff.launches == 0
    (c_logs, c_grads, c_bufs), (g_logs, g_grads, g_bufs) = runs["cpu"], runs["cuda"]
    for k, v in c_logs.items():
        assert g_logs[k] == pytest.approx(v, rel=1e-4, abs=1e-7), k
    big = max(float(g.abs().max()) for g in c_grads.values())
    for n, g in c_grads.items():
        torch.testing.assert_close(g_grads[n], g, atol=5e-3 * big, rtol=1e-2, msg=n)
    for n, b in c_bufs.items():
        if n.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(g_bufs[n], b, atol=1e-5, rtol=0, msg=n)


@pytest.mark.cuda
def test_regression_train_step_bf16_on_the_card(card):
    """train_dtype bfloat16: bf16 layers on fp32 master weights, fp32 losses
    near the fp32 step's."""
    from slice3d_tpu_torch.config import Options
    from slice3d_tpu_torch.train.train_reg import RegressionTrainer

    batch = _reg_batch(4)
    logs = {}
    for dtype in ("float32", "bfloat16"):
        tr = RegressionTrainer(Options(img_size=32, n_qry=16, n_bs=2, train_dtype=dtype))
        st, out = tr.train_step(tr.init_state(seed=5), batch)
        logs[dtype] = {k: float(v) for k, v in out.items()}
        assert all(p.dtype == torch.float32 for p in st.model.parameters())
    assert all(np.isfinite(v) for v in logs["bfloat16"].values())
    assert logs["bfloat16"]["loss"] == pytest.approx(logs["float32"]["loss"], rel=2e-2)


@pytest.mark.cuda
def test_device_preprocess_on_the_card(card):
    """The card's composite/resize/normalise: the host path's values bit for
    bit at the source size, the CPU's resize within 1e-5."""
    from slice3d_tpu_torch.data.dataset import preprocess_image
    from slice3d_tpu_torch.data.device_transforms import preprocess_rgba_device

    raw = np.random.default_rng(6).integers(0, 256, (4, 64, 64, 4), dtype=np.uint8)
    raw[:, :8, :8, 3] = 0
    for white_bg in (False, True):
        got = preprocess_rgba_device(torch.from_numpy(raw).to(card), 64, white_bg).cpu().numpy()
        want = np.stack([preprocess_image(r, 64, white_bg) for r in raw])
        np.testing.assert_array_equal(got, want)
    got = preprocess_rgba_device(torch.from_numpy(raw).to(card), 16).cpu()
    torch.testing.assert_close(got, preprocess_rgba_device(torch.from_numpy(raw), 16),
                               atol=1e-5, rtol=0)


def _f32_case(card, shape, seed):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    return x.to(card), layer_params(seed + 1, card)


def _ffn_args(params):
    return [params[k] for k in ("linear1.weight", "linear1.bias", "linear2.weight",
                                "linear2.bias")]


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 5, 13, 16])
@pytest.mark.parametrize("head_tokens", [0, 1])
def test_encoder_f32_matches_plain(card, no_tf32, t, head_tokens):
    """fp32 kernels vs the plain version on the same fp32 inputs (TF32 off),
    T from 1 to 16 and N = 301 points (no multiple of a tile of 128 // T
    points, nor of 128 rows): within ``HEAD_F32_TOL``, which the plain
    version with TF32 matmuls fails.  One fp32 launch, no bf16 one."""
    x, params = _f32_case(card, (1, 301, t, D), 90 + t)
    before = (fe.launches, fe.launches_f32, ff.launches, ff.launches_f32)
    with torch.no_grad():
        got = fe.fused_encoder_layer(x, params, head_tokens=head_tokens)
        torch.cuda.synchronize()
        assert (fe.launches, fe.launches_f32, ff.launches, ff.launches_f32) == (
            before[0], before[1] + 1, before[2], before[3])
        want = fe.fused_encoder_layer_ref(x, params, head_tokens=head_tokens)
        assert got.shape == want.shape == (1, 301, head_tokens or t, D)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, **HEAD_F32_TOL)
        with _tf32_matmuls():
            control = fe.fused_encoder_layer_ref(x, params, head_tokens=head_tokens)
    assert _violations(control, want, HEAD_F32_TOL) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 127, 129, 3000 + 77])
def test_fused_ffn_f32_matches_plain(card, no_tf32, rows):
    """fp32 FFN kernel vs the plain version (TF32 off), N one row, around
    the 128-row tile and over many tiles: within ``HEAD_F32_TOL``, which
    the plain version with TF32 matmuls fails (from two rows on: cuBLAS
    takes one row as a matrix-vector product, which has no TF32 path).
    One fp32 launch, no bf16 one."""
    x, params = _f32_case(card, (rows, D), 93)
    args = _ffn_args(params)
    before = (fe.launches, fe.launches_f32, ff.launches, ff.launches_f32)
    with torch.no_grad():
        got = ff.fused_ffn(x, *args)
        torch.cuda.synchronize()
        assert (fe.launches, fe.launches_f32, ff.launches, ff.launches_f32) == (
            before[0], before[1], before[2], before[3] + 1)
        want = ff.fused_ffn_ref(x, *args)
        assert got.shape == want.shape == (rows, D) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, **HEAD_F32_TOL)
        with _tf32_matmuls():
            control = ff.fused_ffn_ref(x, *args)
    assert _violations(control, want, HEAD_F32_TOL) > 0 or rows == 1


@pytest.mark.cuda
@pytest.mark.parametrize("head_tokens", [0, 1])
def test_f32_head_kernels_repeat_bit_for_bit(card, head_tokens):
    """No atomics: two runs of each fp32 kernel on the same inputs are
    bit-equal."""
    x, params = _f32_case(card, (1, 3000, 13, D), 95)
    with torch.no_grad():
        runs = [fe.fused_encoder_layer(x, params, head_tokens=head_tokens) for _ in range(2)]
        ffn = [ff.fused_ffn(x[0, :, head_tokens], *_ffn_args(params)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs) and torch.equal(*ffn)


@pytest.mark.cuda
def test_f32_kernels_refuse_autograd_and_other_dtypes(card):
    x, params = _f32_case(card, (1, 4, 13, D), 96)
    with pytest.raises(RuntimeError, match="inference only"):
        fe.fused_encoder_layer(x.requires_grad_(), params)
    with pytest.raises(TypeError):
        fe.fused_encoder_layer(x.detach().double(), params)
    with pytest.raises(TypeError):
        ff.fused_ffn(x.detach()[0, :, 0].double(), *_ffn_args(params))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "split"])
def test_f32_slicenet_runs_the_f32_kernels(card, no_tf32, route):
    """An fp32 SliceNet on the card takes its route's fp32 kernel, three
    launches a head call (fused: the layer; split: its FFN) and no bf16
    launch, and agrees with the CPU's fp32 field."""
    model = init_slicenet(0, route=route)
    rng = np.random.default_rng(5)
    _, proj = camera.camera_matrices(0.0, 0.0, 1.2)
    feed = {"img_input": rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32),
            "trans_mat_wo_rot_tp": proj.astype(np.float32)}
    kw = dict(resolution0=16, upsampling_steps=1, chunk_size=4096)
    cpu, _ = Reconstructor(model, device="cpu", **kw).build_grid(feed)
    before = (fe.launches, fe.launches_f32, ff.launches, ff.launches_f32)
    grid, _ = Reconstructor(model, **kw).build_grid(feed)
    counts = [a - b for a, b in zip((fe.launches, fe.launches_f32, ff.launches,
                                     ff.launches_f32), before)]
    f32 = counts[1] if route == "fused" else counts[3]
    assert f32 > 0 and f32 % 3 == 0 and counts[0] == counts[2] == 0
    assert counts[3 if route == "fused" else 1] == 0
    np.testing.assert_allclose(grid, cpu, atol=1e-3, rtol=0)
