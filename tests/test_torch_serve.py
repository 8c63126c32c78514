"""The port's service, options, image IO and OBJ text against the JAX package
(CPU).

The service runs over HTTP in-process on the CPU (``device="cpu"``, img 32,
res0 8, up 0), as tests/test_serve.py drives the JAX one: /healthz counts,
400 on a bad image, 404, and micro-batching (2 concurrent requests in one
``reconstruct_batch`` call at ``mc_batch_size`` 2), and DISN against the root
service on one checkpoint.  The port's PNG codec,
bilinear resize and preprocessing are byte-equal to Pillow's and to the JAX
package's ``preprocess_image``; its OBJ text is byte-identical to the JAX
package's; its ``Options`` has the same fields and defaults, and every option
it does not port raises.
"""

import dataclasses
import functools
import http.client
import io
import json
import os
import sys
import threading
import types
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from slice3d_tpu import config as jax_config
from slice3d_tpu import mesh as jax_mesh
from slice3d_tpu import pipeline as jax_pipeline
from slice3d_tpu.data.dataset import preprocess_image as jax_preprocess_image
from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.disn import DISNModel as JaxDISN
from slice3d_tpu_torch import config, serve
from slice3d_tpu_torch.data import image
from slice3d_tpu_torch.convert import disn_state_dict
from slice3d_tpu_torch.data.dataset import preprocess_image
from slice3d_tpu_torch.mesh import Mesh, export_obj, isosurface, obj_string, obj_string_py
from slice3d_tpu_torch.models.build import build_model, load_model
from slice3d_tpu_torch.models.slicenet import init_slicenet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(name_model="slicenet", img_size=32, random_init=True, mc_res0=8, mc_up_steps=0,
             mc_chunk_size=1024)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rgba(size=48, seed=0):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, size=(size, size, 4), dtype=np.uint8)
    arr[..., 3] = 0
    arr[8:40, 5:33, 3] = rng.integers(1, 256, (32, 28))  # an off-centre object
    return arr


def _jax_serve():
    sys.path.insert(0, ROOT)
    try:
        import serve as jax_serve
    finally:
        sys.path.remove(ROOT)
    return jax_serve


def test_service_over_http():
    service = serve.build_service(config.Options(**SMALL), device="cpu")
    service.warmup()
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        assert resp.status == 200 and health["ok"] and health["mc_res0"] == 8
        assert health["device"] == "cpu" and health["served"] == 0

        body = image.encode_png(_rgba())
        conn.request("POST", "/reconstruct", body=body)
        resp = conn.getresponse()
        obj = resp.read().decode()
        assert resp.status == 200
        stats = json.loads(resp.getheader("X-Slice3D-Stats"))
        assert stats["n_points_evaluated"] == 9 ** 3
        assert all(line.startswith(("v ", "f ")) for line in obj.splitlines())

        conn.request("POST", "/reconstruct?format=json&center=0", body=body)
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        assert resp.status == 200 and isinstance(payload["obj"], str)
        assert payload["stats"]["n_points_evaluated"] == 9 ** 3

        conn.request("POST", "/reconstruct", body=b"not an image")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 400

        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["served"] == 2 and health["errors"] == 1 and health["p50_ms"] > 0
        conn.request("GET", "/nope")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_service_microbatches_concurrent_requests():
    service = serve.build_service(config.Options(**SMALL, mc_batch_size=2),
                                  batch_window_ms=1000.0, device="cpu")
    assert service.batch_size == 2
    calls = []
    orig = service.recon.reconstruct_batch

    def counted(feeds):
        calls.append(len(feeds))
        return orig(feeds)

    service.recon.reconstruct_batch = counted
    try:
        service.warmup()
        assert calls == [2]  # one padded batch
        body = image.encode_png(_rgba())
        results = [None, None]

        def run(i):
            results[i] = service.reconstruct(body)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert calls == [2, 2]  # both requests rode one batched call
        assert all(r is not None and r[1]["n_points_evaluated"] == 9 ** 3 for r in results)
        assert results[0][0] == results[1][0]  # the same image, the same mesh
    finally:
        service.close()
    assert service.serving_stats()["served"] == 2


def _obj_arrays(text):
    rows = [line.split() for line in text.splitlines()]
    verts = np.array([r[1:] for r in rows if r[0] == "v"], np.float32).reshape(-1, 3)
    faces = np.array([r[1:] for r in rows if r[0] == "f"], np.int64).reshape(-1, 3)
    return verts, faces


def test_disn_service_matches_root_service(tmp_path, monkeypatch):
    """DISN (img 128: the JAX importer reads its global Linear over a 4x4
    map only; res0 8, up 1, fp32) with marching tetrahedra, one reference
    checkpoint: the port's service and the root one (its values shipped in
    fp32, as the port's are) answer the same PNG with the same points
    evaluated and the same mesh, vertices within 1e-3."""
    variables = init_variables(JaxDISN(), types.SimpleNamespace(img_size=128), seed=0)
    os.makedirs(tmp_path / "exp" / "e" / "ckpt")
    torch.save({"model": disn_state_dict(variables)}, tmp_path / "exp" / "e" / "ckpt" / "d.ckpt")
    kw = dict(name_model="disn", img_size=128, mc_res0=8, mc_up_steps=1, mc_chunk_size=2048,
              dtype="float32", mc_extract="tetrahedra", dir_experiments=str(tmp_path / "exp"),
              name_exp="e", name_ckpt="d.ckpt")
    body = image.encode_png(_rgba())
    service = serve.build_service(config.Options(**kw), device="cpu")
    try:
        probe, _ = service.recon.build_grid(service._feed_of(service.preprocess(body)))
    finally:
        service.close()
    mid = np.sort(probe.reshape(-1))[probe.size // 2:probe.size // 2 + 2].mean()
    kw["mc_threshold"] = float(1.0 / (1.0 + np.exp(-mid)))
    service = serve.build_service(config.Options(**kw), device="cpu")
    try:
        obj, stats = service.reconstruct(body)
    finally:
        service.close()
    jax_serve = _jax_serve()
    monkeypatch.setattr(jax_pipeline, "Reconstructor",
                        functools.partial(jax_pipeline.Reconstructor, transport_dtype="float32"))
    j_obj, j_stats = jax_serve.build_service(jax_config.Options(**kw)).reconstruct(body)
    assert stats["n_points_evaluated"] == j_stats["n_points_evaluated"] > 9 ** 3
    (verts, faces), (j_verts, j_faces) = _obj_arrays(obj), _obj_arrays(j_obj)
    assert len(faces) > 0
    np.testing.assert_array_equal(faces, j_faces)
    np.testing.assert_allclose(verts, j_verts, atol=1e-3, rtol=0)


def test_service_raises_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_service(config.Options(**SMALL))
    with pytest.raises(SystemExit):
        serve.build_service(config.Options(**dict(SMALL, name_model="gtslice")), device="cpu")


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_codec_matches_pillow(mode):
    channels = len(mode)
    rng = np.random.default_rng(channels)
    yy, xx = np.mgrid[:37, :53]
    smooth = np.stack([(xx * 3 + yy * (k + 1)) % 256 for k in range(channels)], -1)
    for arr in (rng.integers(0, 256, (37, 53, channels)), smooth):
        arr = arr.astype(np.uint8)[..., 0] if channels == 1 else arr.astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "PNG", optimize=True)  # Pillow's row filters
        got = image.decode_png(buf.getvalue())
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(Image.open(buf)))
        written = Image.open(io.BytesIO(image.encode_png(arr)))
        assert written.mode == mode
        np.testing.assert_array_equal(np.asarray(written), arr)
    with pytest.raises(ValueError):
        image.decode_png(buf.getvalue()[:-20])  # truncated


@pytest.mark.parametrize("shape,size", [((48, 48), (32, 32)), ((128, 96), (40, 32)),
                                        ((20, 30), (50, 64)), ((300, 200), (128, 128))],
                         ids=["48to32", "down", "up", "down-wide"])
def test_resize_matches_pillow(shape, size):
    arr = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(arr).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(image.resize_bilinear(arr, size), want)


@pytest.mark.parametrize("kind", ["rgba", "rgba-white", "rgb", "grey"])
def test_preprocess_matches_jax(kind):
    arr = _rgba(seed=3)
    white = kind == "rgba-white"
    if kind == "rgb":
        arr = arr[..., :3]
    elif kind == "grey":
        arr = arr[..., 0]
    body = image.encode_png(arr)
    opts = config.Options(**dict(SMALL, use_white_bg=white))
    port = serve.Slice3DService(opts, types.SimpleNamespace(batch_size=1))
    for center in (True, False):
        got = port.preprocess(body, center=center)
        pil = Image.open(io.BytesIO(body))
        if pil.mode == "RGBA" and center:  # the JAX service's rule
            pil = _jax_serve()._center_rgba(pil)
        want = jax_preprocess_image(pil, 32, white)
        assert got.shape == (32, 32, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(preprocess_image(image.decode_png(body), 48, white),
                                  jax_preprocess_image(Image.open(io.BytesIO(body)), 48, white))


def test_grey_alpha_png_is_spread_to_rgb():
    """Grey + alpha: the JAX package's ``composite_rgba`` raises on it (a 400
    from its service); the port spreads the grey to RGB and composites."""
    arr = _rgba(seed=4)
    la = np.ascontiguousarray(arr[..., [0, 3]])
    rgba = np.ascontiguousarray(arr[..., [0, 0, 0, 3]])
    with pytest.raises(ValueError):
        jax_preprocess_image(Image.fromarray(la, "LA"), 32, False)
    for white in (False, True):
        got = preprocess_image(image.decode_png(image.encode_png(la)), 32, white)
        np.testing.assert_array_equal(got, preprocess_image(rgba, 32, white))
        np.testing.assert_array_equal(got, jax_preprocess_image(Image.fromarray(rgba, "RGBA"),
                                                                32, white))


def test_obj_string_matches_jax(tmp_path):
    n = 12
    g = np.linspace(-1, 1, n, dtype=np.float32)
    grid = 0.7 - np.sqrt(g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None] ** 2)
    mesh = isosurface(grid * np.float32(1.0 / 3.0), 0.0)
    mesh.vertices = mesh.vertices * np.float32(-0.37)  # signs and more digits
    assert not mesh.is_empty
    text = obj_string(mesh)
    assert text == jax_mesh.obj_string(jax_mesh.Mesh(mesh.vertices, mesh.faces))
    assert text == obj_string_py(mesh)
    export_obj(mesh, str(tmp_path / "m.obj"))
    assert (tmp_path / "m.obj").read_text() == text
    assert obj_string(Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))) == ""


def test_options_match_jax():
    port = {f.name: f.default for f in dataclasses.fields(config.Options)}
    want = {f.name: f.default for f in dataclasses.fields(jax_config.Options)}
    assert port == want
    argv = ["--mc_res0", "16", "--no-use_white_bg", "--dtype", "float32", "--name_exp", "x"]
    assert (dataclasses.asdict(config.options_from_args(argv))
            == dataclasses.asdict(jax_config.options_from_args(argv)))
    o = config.options_from_args(["--dir_data", "d", "--name_dataset", "shapenet",
                                  "--categories_test", "a,b,", "--mode", "test"])
    assert (o.dataset_root, o.exp_dir, o.categories) == (
        os.path.join("d", "shapenet"), os.path.join("experiments", "default_exp"), ["a", "b"])


@pytest.mark.parametrize("name,value", [
    ("name_model", "disn"), ("est_campose", True), ("mc_refine_steps", 3),
    ("simplify_nfaces", 5000), ("mc_extract", "tetrahedra"), ("device_preprocess", True),
    ("mc_shard_axis", "points"), ("multi_gpu", True)])
def test_ported_options_are_accepted(name, value):
    """The options this port once refused reach the service's Reconstructor
    (on the CPU's one device no mesh is made, as on one card)."""
    opts = config.Options(**dict(SMALL, **{name: value}))
    service = serve.build_service(opts, device="cpu")
    try:
        rec = service.recon
        assert (rec.is_disn, rec.refine_steps, rec.simplify_nfaces, rec.generator.method,
                rec.shard_axis, rec.mesh) == (
            opts.name_model == "disn", opts.mc_refine_steps, opts.simplify_nfaces,
            opts.mc_extract, opts.mc_shard_axis, None)
    finally:
        service.close()


def test_load_model(tmp_path):
    opts = config.Options(**dict(SMALL, random_init=False))
    seeded = load_model(opts)
    assert [layer.route for layer in seeded.att_decoder.layers] == ["fused"] * 3
    assert seeded.dtype == torch.bfloat16
    fp32 = build_model(config.Options(**dict(SMALL, dtype="float32")))
    assert fp32.dtype is None and fp32.att_decoder.layers[0].route == "fused"
    sd = init_slicenet(7).state_dict()
    torch.save({"model": sd, "n_epoch": 3}, tmp_path / "ref.ckpt")
    loaded = load_model(opts, str(tmp_path / "ref.ckpt"))
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in sd.items())
    ignored = load_model(config.Options(**SMALL), str(tmp_path / "ref.ckpt")).state_dict()
    assert all(torch.equal(ignored[k], v) for k, v in seeded.state_dict().items())  # --random_init
    # JAX msgpack files and orbax directories are read
    # (tests/test_torch_checkpoint_import.py, test_torch_checkpoint_orbax_import.py);
    # a cut file (a map of 2 entries that holds 1) and a directory that is no
    # checkpoint raise
    (tmp_path / "jax.msgpack").write_bytes(b"\x82\xa6params\x80")
    with pytest.raises(ValueError, match="truncated msgpack"):
        load_model(opts, str(tmp_path / "jax.msgpack"))
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="directory but not a checkpoint.*manifest.ocdbt"):
        load_model(opts, str(tmp_path / "orbax"))
