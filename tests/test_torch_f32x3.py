"""The 3xTF32 arithmetic and packing of the fp32 kernels redesigned for Hopper's
tensor cores (CPU).

csrc/fused_ffn_f32x3.cu and csrc/fused_encoder_f32x3.cu (both on
csrc/ffn_tile_f32x3.cuh), csrc/spatial_attention_f32x3.cu and
csrc/spatial_attention_bwd_f32x3.cu take every fp32 product as three TF32
products of operands split into hi = tf32(x) and lo = tf32(x - hi) (d +=
lo.hi + hi.lo + hi.hi).  They run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phases 3 and 19).  Here: the packed weight stream's planes are
TF32-exact and rebuild each weight to within 2^-22 of it, the W2 permutation
is undone by its inverse, and a torch emulation of each kernel's arithmetic
(TF32 operands rounded by bit masking, exact TF32 products, fp32 sums) over
the kernels' layouts is held against the JAX package, whose Pallas kernels
run in interpret mode, at the fp32 tolerances the card holds the kernels to:
the FFN against ``_fused_ffn_tpu`` and the encoder layer against
``fused_encoder_layer`` at ``HEAD_F32_TOL``, the forward against
``_attention_forward`` at ``ATTN_F32_TOL`` and the backward against
``_attention_backward`` at ``ATTN_BWD_F32_TOL``.  One TF32 product (hi.hi
alone) fails each of them on many elements, so the tolerances tell 3xTF32
from TF32.  The new sources use TF32 only through the split helpers of
csrc/attention_sm90.cuh.
"""

import functools
import math
import os
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from slice3d_tpu.ops import pallas_attention as jax_attention
from slice3d_tpu.ops import pallas_encoder, pallas_ffn
from slice3d_tpu_torch.ops import fused_encoder as fe
from slice3d_tpu_torch.ops import fused_ffn as ff
from slice3d_tpu_torch.ops import spatial_attention as sa

D = 128
# the card's tolerances for the fp32 kernels against their plain versions
# (tests/test_torch_cuda.py, chip_smoke.py)
HEAD_F32_TOL = dict(atol=1e-5, rtol=1e-5)
ATTN_F32_TOL = dict(atol=5e-5, rtol=5e-5)
ATTN_BWD_F32_TOL = dict(atol=2e-4, rtol=1e-4)
FT = ff.KERNEL_TILES["ffn_tile_f32x3.cuh"]["FT"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _violations(got, want, tol) -> int:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return int((np.abs(got - want) > tol["atol"] + tol["rtol"] * np.abs(want)).sum())


def _unplane(p: torch.Tensor, r: int, k: int) -> torch.Tensor:
    """An (r, k) matrix from its plane: element (i, c) at (c // 4) r 4 + 4 i + c % 4."""
    return p.reshape(k // 4, r, 4).transpose(0, 1).reshape(r, k)


def _mm(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b as the tensor cores take it from split operands: the TF32
    products are exact in fp32, their sums rounded in fp32; 3 products
    (lo.hi + hi.lo + hi.hi) or 1 (hi.hi)."""
    ah, al = ff.tf32_split(a)
    bh, bl = ff.tf32_split(b)
    if products == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _weights(seed: int, f: int):
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(f, D)) * 0.08).astype(np.float32)  # nn.Linear layout
    b1 = (rng.normal(size=(f,)) * 0.02).astype(np.float32)
    w2 = (rng.normal(size=(D, f)) * 0.03).astype(np.float32)
    b2 = (rng.normal(size=(D,)) * 0.02).astype(np.float32)
    return [torch.from_numpy(a) for a in (w1, b1, w2, b2)]


def test_tf32_split_rounds_to_nearest_and_rebuilds():
    """hi and lo are TF32 (low 13 bits zero); hi is the nearest TF32 value
    (ties away from zero) and hi + lo is within 2^-22 |w| of w."""
    rng = np.random.default_rng(0)
    mags = 10.0 ** rng.integers(-6, 6, 4000)
    w = torch.from_numpy(np.concatenate([rng.normal(size=4000) * mags, [0.0, -0.0, 1.0, -3.0]])
                         .astype(np.float32))
    hi, lo = ff.tf32_split(w)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    wd, hd, ld = (t.double() for t in (w, hi, lo))
    assert ((wd - hd).abs() <= wd.abs() * 2.0 ** -11).all()
    assert ((wd - hd - ld).abs() <= wd.abs() * 2.0 ** -22).all()
    # a tie (bit 12 set, bits 0-11 clear) rounds away from zero
    tie = torch.tensor([0x3F801000], dtype=torch.int32).view(torch.float32)
    assert ff.tf32_split(tie)[0].view(torch.int32).item() == 0x3F802000
    assert ff.tf32_split(-tie)[0].view(torch.int32).item() == 0xBF802000 - 2 ** 32


def test_planes_are_the_core_matrix_layout():
    """Element (r, c) of an (R, K) matrix sits at (c // 4) R 4 + 4 r + c % 4."""
    r, k = 24, 16
    m = torch.arange(r * k, dtype=torch.float32).reshape(r, k)
    flat = ff.planes(m)
    for i in range(r):
        for c in range(k):
            assert flat[(c // 4) * r * 4 + 4 * i + c % 4] == m[i, c]
    assert torch.equal(_unplane(flat, r, k), m)


def test_packed_planes_are_tf32_and_rebuild_the_weights():
    """Every plane of the stream is TF32-exact, and per F-tile hi + lo of the
    W1 item rebuild W1's rows, and of the W2 item W2's columns (permuted),
    to within 2^-22 of each weight."""
    f = 96
    w1, _, w2, _ = _weights(1, f)
    stream = ff.ffn_stream_f32x3(w1, w2)
    assert stream.dtype == torch.float32 and stream.numel() == 4 * f * D
    assert not (stream.view(torch.int32) & 0x1FFF).any()
    items = stream.reshape(f // FT, 4, FT * D)
    perm = [8 * (i // 8) + ff.kperm(i % 8) for i in range(FT)]
    for s in range(f // FT):
        got1 = _unplane(items[s, 0], FT, D).double() + _unplane(items[s, 1], FT, D).double()
        want1 = w1[s * FT:(s + 1) * FT].double()
        assert ((got1 - want1).abs() <= want1.abs() * 2.0 ** -22).all()
        got2 = _unplane(items[s, 2], D, FT).double() + _unplane(items[s, 3], D, FT).double()
        want2 = w2[:, [s * FT + p for p in perm]].double()
        assert ((got2 - want2).abs() <= want2.abs() * 2.0 ** -22).all()


def test_w2_permutation_is_undone_by_its_inverse():
    """kperm permutes each 8 columns; its inverse (kslot in
    csrc/attention_sm90.cuh: 4 (m % 2) + m // 2) brings W2 back from the
    stream, hi plane plus lo plane."""
    kslot = [4 * (m % 2) + m // 2 for m in range(8)]
    assert sorted(ff.kperm(k) for k in range(8)) == list(range(8))
    assert all(ff.kperm(kslot[m]) == m for m in range(8))
    f = 64
    w1, _, w2, _ = _weights(2, f)
    items = ff.ffn_stream_f32x3(w1, w2).reshape(f // FT, 4, FT * D)
    back = torch.cat([(_unplane(items[s, 2], D, FT) + _unplane(items[s, 3], D, FT))
                      [:, [8 * (m // 8) + kslot[m % 8] for m in range(FT)]]
                      for s in range(f // FT)], 1)
    assert ((back.double() - w2.double()).abs() <= w2.double().abs() * 2.0 ** -22).all()


def _ffn_emulated(x, stream, b1, b2, f, products):
    """csrc/ffn_tile_f32x3.cuh's arithmetic over the packed stream: per
    F-tile GEMM 1 from the W1 item's planes, relu(hid + b1) with its columns
    in the W2 item's order, GEMM 2 from the W2 item's planes (the tile's
    partial, summed into the output in fp32)."""
    items = stream.reshape(f // FT, 4, FT * D)
    perm = [8 * (i // 8) + ff.kperm(i % 8) for i in range(FT)]
    out = torch.zeros((x.shape[0], D), dtype=torch.float32)
    xh, xl = ff.tf32_split(x)
    for s in range(f // FT):
        w1h, w1l = (_unplane(items[s, i], FT, D) for i in (0, 1))
        hid = (xh @ w1h.t() if products == 1 else xl @ w1h.t() + xh @ w1l.t() + xh @ w1h.t())
        h = torch.relu(hid + b1[s * FT:(s + 1) * FT])[:, perm]
        hh, hl = ff.tf32_split(h)
        w2h, w2l = (_unplane(items[s, i], D, FT) for i in (2, 3))
        out += (hh @ w2h.t() if products == 1 else hl @ w2h.t() + hh @ w2l.t() + hh @ w2h.t())
    return out + b2


@pytest.fixture(scope="module")
def ffn_case():
    """x, the weights and the JAX Pallas FFN's output (interpret mode)."""
    f, n = 2048, 192
    w1, b1, w2, b2 = _weights(3, f)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(n, D)).astype(np.float32))
    orig = pallas_ffn.pl.pallas_call
    pallas_ffn.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        want = pallas_ffn._fused_ffn_tpu.__wrapped__(
            jnp.asarray(x.numpy()), jnp.asarray(w1.numpy().T), jnp.asarray(b1.numpy()),
            jnp.asarray(w2.numpy().T), jnp.asarray(b2.numpy()))
    finally:
        pallas_ffn.pl.pallas_call = orig
    return x, (w1, b1, w2, b2), np.asarray(want, np.float32)


@pytest.mark.parametrize("products", [3, 1], ids=["3xtf32", "1xtf32"])
def test_ffn_emulation_against_jax(ffn_case, products):
    """3xTF32 over the packed stream agrees with the JAX FFN at the card's
    fp32 tolerance; one TF32 product does not (thousands of violations)."""
    x, (w1, b1, w2, b2), want = ffn_case
    got = _ffn_emulated(x, ff.ffn_stream_f32x3(w1, w2), b1, b2, w1.shape[0], products)
    bad = _violations(got.numpy(), want, HEAD_F32_TOL)
    if products == 3:
        np.testing.assert_allclose(got.numpy(), want, **HEAD_F32_TOL)
    else:
        assert bad > 1000, bad


def _bwd_emulated(q, k, v, o, lse, do, scale, tile, products):
    """csrc/spatial_attention_bwd_f32x3.cu's arithmetic: D = rowsum(do o);
    the dq kernel over key tiles (S, dP, P = exp2(S c - L), dS, dQ += dS k);
    the dk/dv kernel over query tiles (S^T, dP^T, P^T, dS^T, dV += P^T do,
    dK += dS^T q); every product split, each tile's partial summed in fp32.
    The contraction over a tile runs in the kernels' permuted order (each 8
    rows by kperm, on both operands)."""
    c = scale * math.log2(math.e)
    t = q.shape[-2]
    perm = torch.tensor([8 * (i // 8) + ff.kperm(i % 8) for i in range(tile)])
    mm = functools.partial(_mm, products=products)
    delta = (do * o).sum(-1, keepdim=True)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    for j0 in range(0, t, tile):  # dq: key tiles
        kt, vt = k[..., j0:j0 + tile, :], v[..., j0:j0 + tile, :]
        p = torch.exp2(mm(q, kt.transpose(-1, -2)) * c - lse[..., None])
        ds = p * (mm(do, vt.transpose(-1, -2)) - delta) * scale
        dq += mm(ds[..., perm], kt[..., perm, :])
    for i0 in range(0, t, tile):  # dk, dv: query tiles
        qt, dot = q[..., i0:i0 + tile, :], do[..., i0:i0 + tile, :]
        lt, dlt = lse[..., i0:i0 + tile], delta[..., i0:i0 + tile, 0]
        pt = torch.exp2(mm(k, qt.transpose(-1, -2)) * c - lt[..., None, :])
        dst = pt * (mm(v, dot.transpose(-1, -2)) - dlt[..., None, :]) * scale
        dv += mm(pt[..., perm], dot[..., perm, :])
        dk += mm(dst[..., perm], qt[..., perm, :])
    return dq, dk, dv


@pytest.fixture(scope="module")
def bwd_case():
    """q, k, v, do at (1, 2, 512, 24), the forward's output and row
    log-sum-exp (log2 units, as the fp32 forward kernel saves it), and the
    JAX Pallas backward's dq, dk, dv (interpret mode)."""
    shape, scale = (1, 2, 512, 24), 24 ** -0.5
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) * s for s in (2.0, 2.0, 1.0, 1.0))
    want = jax_attention._attention_backward(*(jnp.asarray(a) for a in (q, k, v, do)), scale,
                                             max(512 // 4, 128), interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    logits = (tq.double() @ tk.double().transpose(-1, -2)) * scale
    lse = (torch.logsumexp(logits, -1) * math.log2(math.e)).float()
    out = sa.spatial_attention_ref(tq, tk, tv, scale)
    return (tq, tk, tv, out, lse, tdo, scale), [np.asarray(w, np.float32) for w in want]


@pytest.mark.parametrize("products", [3, 1], ids=["3xtf32", "1xtf32"])
def test_backward_emulation_against_jax(bwd_case, products):
    """3xTF32 as the backward kernels take it agrees with the JAX backward at
    the card's fp32 tolerance; one TF32 product does not."""
    args, want = bwd_case
    tile = sa.KERNEL_TILES["spatial_attention_bwd_f32x3.cu"]["TILE24"]
    got = _bwd_emulated(*args, tile, products)
    bad = sum(_violations(g.numpy(), w, ATTN_BWD_F32_TOL) for g, w in zip(got, want))
    if products == 3:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **ATTN_BWD_F32_TOL)
    else:
        assert bad > 100, bad


def _fwd_emulated(q, k, v, scale, tile, products):
    """csrc/spatial_attention_f32x3.cu's arithmetic: per key tile S = q k^T,
    the online softmax in fp32 (running max m of the raw logits, running
    sum l, alpha = exp2((m_old - m) c), exactly 1 while the max stays),
    P = exp2(S c - m c) split from its accumulator, O = O alpha + P v with
    the tile's keys in the kernel's permuted order (each 8 by kperm, on P's
    columns and v's rows, as v^T's planes hold them); out = O / l and the
    row log-sum-exp L = m c + log2 l (log2 units), every product split."""
    c = scale * math.log2(math.e)
    perm = torch.tensor([8 * (i // 8) + ff.kperm(i % 8) for i in range(tile)])
    mm = functools.partial(_mm, products=products)
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros(q.shape[:-1] + (1,))
    o = torch.zeros_like(q)
    for j0 in range(0, q.shape[-2], tile):
        kt, vt = k[..., j0:j0 + tile, :], v[..., j0:j0 + tile, :]
        s = mm(q, kt.transpose(-1, -2))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mx) * c)
        p = torch.exp2(s * c - mx * c)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p[..., perm], vt[..., perm, :])
        m = mx
    return o / l, (m * c + torch.log2(l))[..., 0]


@pytest.fixture(scope="module", params=[24, 48], ids=["dh24", "dh48"])
def fwd_case(request):
    """q, k, v at (1, 2, 512, DH), the JAX Pallas forward's output
    (interpret mode) and the rows' exact log-sum-exp (fp64, log2 units)."""
    dh = request.param
    shape, scale = (1, 2, 512, dh), dh ** -0.5
    rng = np.random.default_rng(6 + dh)
    q, k, v = (rng.normal(size=shape).astype(np.float32) * s for s in (2.0, 2.0, 1.0))
    want = jax_attention._attention_forward(*(jnp.asarray(a) for a in (q, k, v)), scale, 512,
                                            interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    logits = (tq.double() @ tk.double().transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, -1) * math.log2(math.e)
    return (tq, tk, tv, scale), np.asarray(want, np.float32), lse.numpy()


@pytest.mark.parametrize("products", [3, 1], ids=["3xtf32", "1xtf32"])
def test_forward_emulation_against_jax(fwd_case, products):
    """3xTF32 as the forward kernel takes it agrees with the JAX forward at
    the card's fp32 tolerance, and its log-sum-exp (which the backward
    reads) with the exact one to 1e-5 in log2 units; one TF32 product does
    not."""
    (q, k, v, scale), want, lse = fwd_case
    tile = sa.KERNEL_TILES["spatial_attention_f32x3.cu"][f"TILE{q.shape[-1]}"]
    got, got_lse = _fwd_emulated(q, k, v, scale, tile, products)
    if products == 3:
        np.testing.assert_allclose(got.numpy(), want, **ATTN_F32_TOL)
        np.testing.assert_allclose(got_lse.numpy(), lse, atol=1e-5, rtol=0)
    else:
        assert _violations(got.numpy(), want, ATTN_F32_TOL) > 100


def _ln(v, w, b):
    mu = v.mean(-1, keepdim=True)
    var = ((v - mu) ** 2).mean(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + 1e-5) * w + b


def _unitems(items: torch.Tensor, r: int, k: int):
    """(hi, lo) (r, K) matrices from their items (K // k, 2, r k) of k columns."""
    return tuple(torch.cat([_unplane(it[part], r, k) for it in items], 1) for part in (0, 1))


def _layer_emulated(x, p, head_tokens, products):
    """csrc/fused_encoder_f32x3.cu's arithmetic over its packed streams: per
    head q|k|v = x Wh^T + b from the attention stream's planes, the T x T
    core and softmax in fp32, o; then o Wo^T from the Wo items, + bo + x,
    LayerNorm 1 -> h1, the FFN over the stream's F-tiles (``_ffn_emulated``),
    + b2 + h1 rebuilt from its planes (hi + lo), LayerNorm 2."""
    n, t, d = x.shape
    tiles = fe.KERNEL_TILES["fused_encoder_f32x3.cu"]
    nh, dh, kc = tiles["NH"], tiles["DH"], tiles["KC"]
    attn, post = fe._pack_f32(*(p[k] for k in ("self_attn.in_proj_weight",
                                               "self_attn.out_proj.weight",
                                               "linear1.weight", "linear2.weight")))
    items = attn.reshape(nh, d // kc, 2, 3 * dh * kc)

    def mm(a, w):  # a @ (hi + lo)^T, a split: three TF32 products, or hi.hi
        ah, al = ff.tf32_split(a)
        return ah @ w[0].t() if products == 1 else al @ w[0].t() + ah @ w[1].t() + ah @ w[0].t()

    bias = p["self_attn.in_proj_bias"].reshape(3, nh, dh)
    o = torch.zeros((n, head_tokens or t, d))
    for h in range(nh):
        qkv = mm(x, _unitems(items[h], 3 * dh, kc)) + bias[:, h].reshape(-1)
        q, k, v = qkv.split(dh, -1)
        q = q[:, :head_tokens] if head_tokens else q
        probs = torch.softmax(q @ k.transpose(-1, -2) * dh ** -0.5, -1)
        o[..., h * dh:(h + 1) * dh] = probs @ v
    wo = _unitems(post[:2 * d * d].reshape(d // FT, 2, d * FT), d, FT)
    x_res = x[:, :head_tokens] if head_tokens else x
    h1 = _ln(x_res + (mm(o, wo) + p["self_attn.out_proj.bias"]), p["norm1.weight"],
             p["norm1.bias"]).reshape(-1, d)
    ffn = _ffn_emulated(h1, post[2 * d * d:], p["linear1.bias"], p["linear2.bias"],
                        p["linear1.weight"].shape[0], products)
    hi, lo = ff.tf32_split(h1)
    out = _ln((hi + lo) + ffn, p["norm2.weight"], p["norm2.bias"])
    return out.reshape(n, head_tokens or t, d)


@pytest.fixture(scope="module")
def layer_case():
    """x (40 points of 13 tokens), a layer's weights in the JAX tree and
    under the port's names, and the JAX Pallas layer's output (interpret
    mode) at head_tokens 0 and 1."""
    rng = np.random.default_rng(8)

    def g(*shape, s=0.05):
        return rng.normal(size=shape).astype(np.float32) * s

    fp = {"qkv": {"kernel": g(D, 3 * D), "bias": g(3 * D, s=0.02)},
          "out_proj": {"kernel": g(D, D), "bias": g(D, s=0.02)},
          "ff1": {"kernel": g(D, 2048), "bias": g(2048, s=0.02)},
          "ff2": {"kernel": g(2048, D), "bias": g(D, s=0.02)},
          "norm1": {"scale": 1 + g(D, s=0.1), "bias": g(D, s=0.1)},
          "norm2": {"scale": 1 + g(D, s=0.1), "bias": g(D, s=0.1)}}
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    params = {"self_attn.in_proj_weight": tt(fp["qkv"]["kernel"].T),
              "self_attn.in_proj_bias": tt(fp["qkv"]["bias"]),
              "self_attn.out_proj.weight": tt(fp["out_proj"]["kernel"].T),
              "self_attn.out_proj.bias": tt(fp["out_proj"]["bias"]),
              "linear1.weight": tt(fp["ff1"]["kernel"].T), "linear1.bias": tt(fp["ff1"]["bias"]),
              "linear2.weight": tt(fp["ff2"]["kernel"].T), "linear2.bias": tt(fp["ff2"]["bias"]),
              "norm1.weight": tt(fp["norm1"]["scale"]), "norm1.bias": tt(fp["norm1"]["bias"]),
              "norm2.weight": tt(fp["norm2"]["scale"]), "norm2.bias": tt(fp["norm2"]["bias"])}
    x = rng.normal(size=(1, 40, 13, D)).astype(np.float32)
    old = os.environ.get("SLICE3D_PALLAS_INTERPRET")
    os.environ["SLICE3D_PALLAS_INTERPRET"] = "1"
    try:
        want = {ht: np.asarray(pallas_encoder.fused_encoder_layer(
            jnp.asarray(x), fp, n_heads=4, head_tokens=ht))[0] for ht in (0, 1)}
    finally:
        if old is None:
            del os.environ["SLICE3D_PALLAS_INTERPRET"]
        else:
            os.environ["SLICE3D_PALLAS_INTERPRET"] = old
    return torch.from_numpy(x[0]), params, want


@pytest.mark.parametrize("products", [3, 1], ids=["3xtf32", "1xtf32"])
@pytest.mark.parametrize("head_tokens", [0, 1])
def test_encoder_layer_emulation_against_jax(layer_case, head_tokens, products):
    """3xTF32 as the encoder layer's kernels take it (the packed streams'
    planes, LayerNorms on fp32, h1 rebuilt from its planes) agrees with the
    JAX layer at fp32 within the card's ``HEAD_F32_TOL``; one TF32 product
    does not."""
    x, params, want = layer_case
    got = _layer_emulated(x, params, head_tokens, products).numpy()
    assert got.shape == want[head_tokens].shape
    if products == 3:
        np.testing.assert_allclose(got, want[head_tokens], **HEAD_F32_TOL)
    else:
        assert _violations(got, want[head_tokens], HEAD_F32_TOL) > 100


SOURCES = {"spatial_attention_bwd_f32x3.cu": ["cuda_runtime.h", "math.h", "stdint.h",
                                              "attention_sm90.cuh"],
           "spatial_attention_f32x3.cu": ["cuda_runtime.h", "math.h", "stdint.h",
                                          "attention_sm90.cuh"],
           "fused_ffn_f32x3.cu": ["cuda_runtime.h", "stdint.h", "ffn_tile_f32x3.cuh"],
           "fused_encoder_f32x3.cu": ["cuda_runtime.h", "math.h", "stdint.h",
                                      "ffn_tile_f32x3.cuh"],
           "ffn_tile_f32x3.cuh": ["attention_sm90.cuh"]}
# the 3xTF32 helpers of attention_sm90.cuh: the split and the three-product steps
TF32_HELPERS = {"tf32_split", "tf32_split_store4", "tf32x3_ss", "tf32x3_rs", "tf32x3_from_acc"}
# the product steps each source runs itself (fused_ffn_f32x3.cu's are the tile
# header's; the encoder layer's RS products are the tile header's FFN)
PRODUCTS = dict.fromkeys(SOURCES, {"tf32x3_ss", "tf32x3_rs"})
PRODUCTS.update({"fused_ffn_f32x3.cu": set(), "fused_encoder_f32x3.cu": {"tf32x3_ss"}})


@pytest.mark.parametrize("name", list(SOURCES))
def test_3xtf32_sources_reach_tf32_through_the_split_helpers(name):
    """The redesigned fp32 sources reach the tensor cores only through the
    3xTF32 helpers (no single TF32 product, no conversion of their own), use
    no bf16 or half type, no library kernel and no assembly of their own, and
    include what they need alone."""
    with open(os.path.join(sa._CSRC, name)) as f:
        code = "\n".join(line.split("//")[0] for line in f)  # comments aside
    words = set(re.findall(r"\w*tf32\w*", code, flags=re.I))
    assert words <= TF32_HELPERS, (name, words - TF32_HELPERS)
    assert PRODUCTS[name] <= words, (name, words)
    mma = set(re.findall(r"\w*mma\w*", code))
    assert mma <= {"wgmma_fence", "wgmma_commit", "wgmma_wait"}, (name, mma)
    for word in ("bf16", "bfloat16", "half", "cublas", "cudnn", "cutlass", "cute", "asm",
                 "atomic", "reduce"):
        assert not re.search(word, code, flags=re.I), (name, word)
    assert re.findall(r"#include [<\"]([^>\"]+)[>\"]", code) == SOURCES[name]
