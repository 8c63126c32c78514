"""The fp32 head kernels' Python side, and the fp32 slice, on the CPU.

The kernels (csrc/fused_encoder_f32x3.cu, csrc/fused_ffn_f32x3.cu) run only on
the card (tests/test_torch_cuda.py, and phases 3, 6 and 20 of
chip_smoke.py); their plain twins are held against the Pallas kernels in
interpret mode by tests/test_torch_encoder.py and tests/test_torch_ffn.py.
Here: ``build_model`` at ``--dtype float32`` takes the kernel route, the
pipeline's route/dtype rule, each wrapper's dtype rule, the library,
counter and arguments of each dtype (the C entry points replaced by
recorders), the fp32 weight streams and their cache, the fp32 sources' own
constraints, and a small fp32 SliceNet head through the port's build_model
against the JAX ``SliceNetModel`` at fp32 whose head reaches the Pallas
kernels in interpret mode, on the fused and the split routes.
"""

import contextlib
import ctypes
import functools
import os
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slice3d_tpu import config as jax_config
from slice3d_tpu.convert import torch_import
from slice3d_tpu.models import build as jax_build
from slice3d_tpu.models.slicenet import SliceNetModel as JaxSliceNet
from slice3d_tpu.ops import pallas_encoder, pallas_ffn
from slice3d_tpu_torch import config, convert
from slice3d_tpu_torch.models import layers
from slice3d_tpu_torch.models.build import build_model
from slice3d_tpu_torch.models.gtslice import GTSliceModel
from slice3d_tpu_torch.models.slicenet import SliceNetModel, init_slicenet
from slice3d_tpu_torch.ops import fused_encoder as fe
from slice3d_tpu_torch.ops import fused_ffn as ff
from slice3d_tpu_torch.ops import prepared
from slice3d_tpu_torch.pipeline import check_head_routes

D, F = 128, 2048
KERNEL_ROUTES = ("fused", "split")
# the fp32 head (point net, 3 layers, fc_out) against the JAX head at fp32
# with its Pallas kernels in interpret mode: both fp32, apart by summation
# order (readings: 3.8e-7 fused, 4.2e-7 split, on outputs up to 0.85)
HEAD_TOL = dict(atol=5e-6, rtol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,cls", [("slicenet", SliceNetModel), ("gtslice", GTSliceModel)])
def test_build_model_fp32_takes_the_fused_route(name, cls):
    """As the JAX ``build_model``: compute dtype None, the kernel route."""
    model = build_model(config.Options(name_model=name, dtype="float32"))
    assert isinstance(model, cls) and model.dtype is None
    assert [layer.route for layer in model.att_decoder.layers] == ["fused"] * 3


@pytest.mark.parametrize("route", KERNEL_ROUTES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, None],
                         ids=["bf16", "fp32", "none"])
def test_head_rule_takes_bf16_and_fp32_on_the_card(route, dtype):
    check_head_routes(torch.device("cuda"), [route, "plain", route], dtype)


@pytest.mark.parametrize("route", KERNEL_ROUTES)
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64], ids=["fp16", "fp64"])
def test_head_rule_refuses_other_dtypes_on_the_card(route, dtype):
    with pytest.raises(ValueError, match="bf16 or fp32 on the card"):
        check_head_routes(torch.device("cuda", 0), [route] * 3, dtype)
    # the plain route, and the CPU, take any dtype
    check_head_routes(torch.device("cuda"), ["plain"] * 3, dtype)
    check_head_routes(torch.device("cpu"), [route] * 3, dtype)


WRAPPERS = {"encoder": fe, "ffn": ff}


@pytest.mark.parametrize("which", list(WRAPPERS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_dtype_takes_fp32_and_bf16(which, dtype):
    x = torch.zeros((2, D), dtype=dtype)
    assert WRAPPERS[which].kernel_dtype(("x", x)) == dtype
    assert WRAPPERS[which].KERNEL_DTYPES == (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("which", list(WRAPPERS))
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64], ids=["fp16", "fp64"])
def test_kernel_dtype_refuses_other_dtypes(which, dtype):
    mod = WRAPPERS[which]
    with pytest.raises(TypeError, match="bf16 or fp32"):
        mod.kernel_dtype(("x", torch.zeros((2, D), dtype=dtype)))
    with pytest.raises(TypeError, match="y torch"):  # where only a later tensor has it
        mod.kernel_dtype(("x", torch.zeros((2, D))), ("y", torch.zeros((2, D), dtype=dtype)))


@pytest.mark.parametrize("which", list(WRAPPERS))
@pytest.mark.parametrize("pair", [(torch.float32, torch.bfloat16),
                                  (torch.bfloat16, torch.float32)],
                         ids=["fp32-bf16", "bf16-fp32"])
def test_kernel_dtype_refuses_mixed_dtypes(which, pair):
    a, b = (torch.zeros((2, D), dtype=d) for d in pair)
    with pytest.raises(TypeError, match="one dtype a call"):
        WRAPPERS[which].kernel_dtype(("x", a), ("out", b))


_MAPS = ctypes.create_string_buffer(64)  # a bf16 weight set's maps, in the recorders' tests


class _Recorder:
    """A stand-in for a C entry point: keeps each call's arguments, returns
    ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def recorders(monkeypatch):
    """Both wrappers' C entry points replaced by recorders, the bf16 weight
    maps by a buffer, and the CUDA device and stream calls made harmless on
    the CPU."""
    rec = {(name, dt): _Recorder() for name in WRAPPERS
           for dt in (torch.bfloat16, torch.float32)}
    for name, mod in WRAPPERS.items():
        monkeypatch.setattr(mod, "kernel",
                            lambda dtype=torch.bfloat16, name=name: rec[(name, dtype)])
        monkeypatch.setattr(mod, "_maps", lambda prep: _MAPS)
        monkeypatch.setattr(mod, "launches", 0)
        monkeypatch.setattr(mod, "launches_f32", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=7))
    return rec


def _layer_params(seed, f=F):
    rng = np.random.default_rng(seed)

    def g(*shape, s=0.05):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * s)

    return {"self_attn.in_proj_weight": g(3 * D, D), "self_attn.in_proj_bias": g(3 * D),
            "self_attn.out_proj.weight": g(D, D), "self_attn.out_proj.bias": g(D),
            "linear1.weight": g(f, D), "linear1.bias": g(f), "linear2.weight": g(D, f),
            "linear2.bias": g(D), "norm1.weight": 1 + g(D), "norm1.bias": g(D),
            "norm2.weight": 1 + g(D), "norm2.bias": g(D)}


def _counts():
    return fe.launches, fe.launches_f32, ff.launches, ff.launches_f32


@pytest.mark.parametrize("head_tokens", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_encoder_launch_picks_the_library_and_counter_of_the_dtype(recorders, dtype,
                                                                     head_tokens):
    """fp32: 13 pointers (x, the two weight streams, 8 vectors, the o scratch
    of (N * T_out, D), out), then n, t, f, head_tokens and the stream; bf16:
    11 (x, the maps, 8 vectors, out).  Each counts on its own counter."""
    params = _layer_params(1, f=256)
    x = torch.zeros((2, 5, 13, D), dtype=dtype)
    out = fe._launch_kernel(x, params, head_tokens, dtype)
    t_out = head_tokens or 13
    assert out.shape == (2, 5, t_out, D) and out.dtype == dtype
    (args,) = recorders[("encoder", dtype)].calls
    f32 = dtype == torch.float32
    prep = fe.prepared_params(params, dtype)
    weights = (tuple(w.data_ptr() for w in prep.weights) if f32
               else (ctypes.addressof(_MAPS),))
    vectors = tuple(v.data_ptr() for v in prep.vectors)
    n_ptrs = 1 + len(weights) + 8 + (2 if f32 else 1)
    assert n_ptrs == (13 if f32 else 11) and len(args) == n_ptrs + 5
    assert args[1:n_ptrs - 1] == weights + vectors + args[n_ptrs - 2:n_ptrs - 1] * f32
    assert args[n_ptrs - 1] == out.data_ptr()
    assert args[n_ptrs:] == (10, 13, 256, head_tokens, 7)
    assert _counts() == ((0, 1, 0, 0) if f32 else (1, 0, 0, 0))
    other = torch.bfloat16 if f32 else torch.float32
    assert not recorders[("encoder", other)].calls and not recorders[("ffn", dtype)].calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_ffn_launch_picks_the_library_and_counter_of_the_dtype(recorders, dtype):
    """Both take (x, weights, b1, b2, out, n, f, stream): fp32 the packed
    stream, bf16 the maps."""
    p = _layer_params(2, f=192)
    w = [p[k] for k in ("linear1.weight", "linear1.bias", "linear2.weight", "linear2.bias")]
    x = torch.zeros((3, 7, D), dtype=dtype)
    out = ff._launch_kernel(x, *w, dtype)
    assert out.shape == x.shape and out.dtype == dtype
    (args,) = recorders[("ffn", dtype)].calls
    prep = ff.prepared_weights(*w, dtype)
    f32 = dtype == torch.float32
    weights = (prep.weights[0].data_ptr() if f32
               else ctypes.addressof(_MAPS))
    assert args == (args[0], weights, prep.vectors[0].data_ptr(), prep.vectors[1].data_ptr(),
                    out.data_ptr(), 21, 192, 7)
    assert _counts() == ((0, 0, 0, 1) if f32 else (0, 0, 1, 0))
    other = torch.bfloat16 if f32 else torch.float32
    assert not recorders[("ffn", other)].calls


@pytest.mark.parametrize("which", list(WRAPPERS))
def test_a_failed_fp32_launch_raises(recorders, monkeypatch, which):
    mod = WRAPPERS[which]
    monkeypatch.setattr(mod, "kernel", lambda dtype=torch.bfloat16: _Recorder(rc=98))
    p = _layer_params(3, f=64)
    with pytest.raises(RuntimeError, match="float32 kernel launch failed: CUDA error 98"):
        if which == "encoder":
            fe._launch_kernel(torch.zeros((1, 2, 13, D)), p, 0, torch.float32)
        else:
            ff._launch_kernel(torch.zeros((4, D)), p["linear1.weight"], p["linear1.bias"],
                              p["linear2.weight"], p["linear2.bias"], torch.float32)
    assert _counts() == (0, 0, 0, 0)


def test_the_wrappers_take_the_plain_version_on_the_cpu():
    """A CPU fp32 tensor takes the plain version, counting nothing."""
    p = _layer_params(4, f=64)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 3, 13, D))
                         .astype(np.float32))
    before = _counts()
    got = fe.fused_encoder_layer(x, p, head_tokens=1)
    assert torch.equal(got, fe.fused_encoder_layer_ref(x, p, head_tokens=1))
    w = [p[k] for k in ("linear1.weight", "linear1.bias", "linear2.weight", "linear2.bias")]
    assert torch.equal(ff.fused_ffn(x, *w), ff.fused_ffn_ref(x, *w))
    assert _counts() == before


def _unplane(p: torch.Tensor, r: int, k: int) -> torch.Tensor:
    """An (r, k) matrix from its K-major plane (``ff.planes``)."""
    return p.reshape(k // 4, r, 4).transpose(0, 1).reshape(r, k)


def test_ffn_stream_is_the_f_tiles_k_major():
    """Per F-tile of FT = 32: W1's tile (its FT rows over D) then W2's (its D
    rows over the tile's units, each 8 permuted by ``kperm``), each as a hi
    and a lo K-major plane whose sum is the weight (exactly, for integers
    below 2^22)."""
    ft = ff.KERNEL_TILES["ffn_tile_f32x3.cuh"]["FT"]
    w1 = torch.arange(192 * D, dtype=torch.float32).reshape(192, D)
    w2 = -torch.arange(D * 192, dtype=torch.float32).reshape(D, 192)
    s = ff.ffn_stream_f32x3(w1, w2).reshape(192 // ft, 4, D * ft)
    perm = [8 * (i // 8) + ff.kperm(i % 8) for i in range(ft)]
    for t in range(192 // ft):
        assert torch.equal(_unplane(s[t, 0], ft, D) + _unplane(s[t, 1], ft, D),
                           w1[ft * t:ft * t + ft])
        assert torch.equal(_unplane(s[t, 2], D, ft) + _unplane(s[t, 3], D, ft),
                           w2[:, [ft * t + p for p in perm]])


def test_encoder_streams_are_the_heads_and_the_rest():
    """The attention stream: per head its q, k, v rows (96) in items of KC
    K-columns, each a hi and a lo TF32 plane; the rest's: Wo's rows in
    items of FT K-columns, then the FFN's stream.  Each pair of planes
    rebuilds its weights to within 2^-22 of them."""
    p = _layer_params(5, f=128)
    prep = fe.prepared_params(p, torch.float32)
    qkv, post = prep.weights
    assert qkv.dtype == post.dtype == torch.float32
    assert not (qkv.view(torch.int32) & 0x1FFF).any()
    assert not (post.view(torch.int32) & 0x1FFF).any()
    kc = fe.KERNEL_TILES["fused_encoder_f32x3.cu"]["KC"]
    ft = fe.KERNEL_TILES["ffn_tile_f32x3.cuh"]["FT"]

    def near(got, want):
        return bool(((got.double() - want.double()).abs() <= want.double().abs() * 2.0 ** -22)
                    .all())

    w = p["self_attn.in_proj_weight"]
    items = qkv.reshape(4, D // kc, 2, 96 * kc)
    for h in range(4):
        rows = torch.cat([w[which * D + 32 * h:which * D + 32 * h + 32] for which in range(3)])
        for i in range(D // kc):
            got = _unplane(items[h, i, 0], 96, kc) + _unplane(items[h, i, 1], 96, kc)
            assert near(got, rows[:, kc * i:kc * i + kc])
    wo = post[:2 * D * D].reshape(D // ft, 2, D * ft)
    for i in range(D // ft):
        got = _unplane(wo[i, 0], D, ft) + _unplane(wo[i, 1], D, ft)
        assert near(got, p["self_attn.out_proj.weight"][:, ft * i:ft * i + ft])
    assert torch.equal(post[2 * D * D:], ff.ffn_stream_f32x3(p["linear1.weight"],
                                                             p["linear2.weight"]))
    assert [v.dtype for v in prep.vectors] == [torch.float32] * 8


def test_prepare_keeps_bf16_and_fp32_sets_apart():
    """One parameter set gives a bf16 set (with a slot for TMA maps) and an
    fp32 set (packed streams, no maps), each cached on its own."""
    p = _layer_params(6, f=64)
    before = prepared.prepares
    a16, a32 = fe.prepared_params(p, torch.bfloat16), fe.prepared_params(p, torch.float32)
    assert a16 is not a32 and prepared.prepares == before + 2
    assert fe.prepared_params(p, torch.bfloat16) is a16
    assert fe.prepared_params(p, torch.float32) is a32
    assert prepared.prepares == before + 2
    assert [w.dtype for w in a16.weights] == [torch.bfloat16] * 4
    assert len(a32.weights) == 2 and a32.maps is None
    w = [p[k] for k in ("linear1.weight", "linear1.bias", "linear2.weight", "linear2.bias")]
    b16, b32 = ff.prepared_weights(*w), ff.prepared_weights(*w, dtype=torch.float32)
    assert b16 is not b32 and ff.prepared_weights(*w, dtype=torch.float32) is b32
    assert [t.dtype for t in b32.weights] == [torch.float32] and b32.weights[0].numel() == 4 * D * 64


@pytest.mark.parametrize("name", ["fused_encoder_f32x3.cu", "ffn_tile_f32x3.cuh"])
def test_fp32_sources_use_fp32_alone(name):
    """The fp32 head kernels take fp32 and give fp32: no bf16 or half type,
    no library kernel, no inline assembly of their own, and the tensor
    cores only through the 3xTF32 helpers of csrc/attention_sm90.cuh (no
    single TF32 product, no conversion of their own)."""
    with open(os.path.join(fe._CSRC, name)) as f:
        code = "\n".join(line.split("//")[0] for line in f)  # comments aside
    for word in ("bf16", "bfloat16", "half", "wmma", "cublas", "cudnn", "cutlass", "cute",
                 "asm"):
        assert not re.search(word, code, flags=re.I), (name, word)
    assert set(re.findall(r"\w*tf32\w*", code, flags=re.I)) <= {
        "tf32_split", "tf32_split_store4", "tf32x3_ss", "tf32x3_rs", "tf32x3_from_acc"}
    includes = re.findall(r"#include [<\"]([^>\"]+)[>\"]", code)
    assert includes == (["attention_sm90.cuh"] if name.endswith(".cuh") else
                        ["cuda_runtime.h", "math.h", "stdint.h", "ffn_tile_f32x3.cuh"])


@pytest.mark.parametrize("mod,name", [(fe, "fused_encoder_f32x3.cu"), (fe, "ffn_tile_f32x3.cuh"),
                                      (ff, "ffn_tile_f32x3.cuh")])
def test_kernel_tiles_are_the_fp32_sources(mod, name):
    """``KERNEL_TILES`` states the fp32 sources' constants (the F check, the
    weight streams' tiles, chip_smoke.py's weight bytes read them); the
    wrapper's F check takes whole fp32 F-tiles."""
    with open(os.path.join(mod._CSRC, name)) as f:
        src = f.read()
    for const, size in mod.KERNEL_TILES[name].items():
        found = re.findall(rf"^constexpr int {const} = (\d+);", src, flags=re.M)
        assert found == [str(size)], (name, const, found)
    assert mod.F_MULTIPLE % mod.KERNEL_TILES["ffn_tile_f32x3.cuh"]["FT"] == 0


@pytest.mark.parametrize("n,t,head_tokens,tiles", [
    (33_800, 13, 0, (3756, 3433)), (33_800, 13, 1, (3756, 265)), (1, 16, 0, (1, 1)),
    (300, 1, 1, (3, 3))])
def test_fp32_encoder_weight_bytes_follow_its_tiles(n, t, head_tokens, tiles):
    """The attention kernel reads Wqkv once a tile of 128 // T points, the
    rest Wo, W1 and W2 once a tile of 128 output rows, each weight as a hi
    and a lo TF32 plane."""
    want = 8 * (tiles[0] * 3 * D * D + tiles[1] * (D * D + 2 * D * F))
    assert fe.weight_bytes_per_call(n, t, head_tokens, dtype=torch.float32) == want
    assert ff.weight_bytes_per_call(439_400, dtype=torch.float32) == 3433 * 8 * 2 * D * F


@pytest.fixture(scope="module")
def head_case():
    """A SliceNet of the port's seeded init, its variables taken into the
    JAX package's tree (the JAX importer) and back into a port model built
    by ``build_model`` at fp32 (``convert``); 300 query points and their
    sampled features."""
    variables = torch_import.slicenet_model(init_slicenet(3).state_dict())
    opts = config.Options(dtype="float32")
    model = build_model(opts)
    model.load_state_dict(convert.slicenet_state_dict(variables))
    rng = np.random.default_rng(7)
    qry = rng.uniform(-0.5, 0.5, (1, 300, 3)).astype(np.float32)
    sampled = rng.normal(size=(1, 300, 12, D)).astype(np.float32)
    return variables, model, qry, sampled


def _jax_head(variables, qry, sampled, calls):
    """The JAX SliceNet of ``build_model(dtype="float32")`` (compute dtype
    None, ``fused_ffn`` on) on the sampled features, eagerly."""
    jmodel = jax_build.build_model(jax_config.Options(dtype="float32"))
    assert isinstance(jmodel, JaxSliceNet) and jmodel.dtype is None and jmodel.fused_ffn
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(qry),
                        jnp.asarray(sampled), method=JaxSliceNet.query_presampled)
    assert len(calls) == 3, calls  # one Pallas kernel a layer
    return np.asarray(want)


def _counting(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("route", KERNEL_ROUTES)
def test_fp32_head_matches_jax(head_case, monkeypatch, route):
    """The fp32 slice end to end on the CPU: the port's fp32 SliceNet head
    on the fused route (every layer through ``fused_encoder_layer``) or the
    split route (every FFN through ``fused_ffn``) against the JAX head at
    fp32 reaching ``pallas_encoder.fused_encoder_layer``, or with the
    whole-layer kernel off ``pallas_ffn.fused_ffn``'s kernel, in interpret
    mode, within ``HEAD_TOL``."""
    variables, model, qry, sampled = head_case
    jax_calls, port_calls = [], []
    monkeypatch.setattr(pallas_ffn, "pallas_available", lambda: True)
    if route == "fused":
        monkeypatch.setenv("SLICE3D_PALLAS_INTERPRET", "1")
        _counting(monkeypatch, pallas_encoder, "fused_encoder_layer", jax_calls)
    else:
        monkeypatch.setenv("SLICE3D_DISABLE_FUSED_ENCODER", "1")
        monkeypatch.setattr(pallas_ffn.pl, "pallas_call",
                            functools.partial(pallas_ffn.pl.pallas_call, interpret=True))
        _counting(monkeypatch, pallas_ffn, "_fused_ffn_tpu", jax_calls)
    want = _jax_head(variables, qry, sampled, jax_calls)

    for layer in model.att_decoder.layers:
        layer.route = route
    if route == "fused":
        monkeypatch.setitem(layers._ROUTE_FNS, "fused", _spy(fe.fused_encoder_layer, port_calls))
    else:
        monkeypatch.setattr(layers, "fused_ffn", _spy(ff.fused_ffn, port_calls))
    monkeypatch.setitem(layers._ROUTE_FNS, "plain", lambda *a, **k: pytest.fail("plain head"))
    try:
        with torch.no_grad():
            got = model.query_presampled(torch.from_numpy(qry), torch.from_numpy(sampled))
    finally:
        for layer in model.att_decoder.layers:
            layer.route = "fused"
    assert len(port_calls) == 3 and all(dt == torch.float32 for dt in port_calls)
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, 300)
    np.testing.assert_allclose(got.numpy(), want, **HEAD_TOL)


def _spy(fn, calls):
    def spy(x, *args, **kwargs):
        calls.append(x.dtype)
        return fn(x, *args, **kwargs)

    return spy
