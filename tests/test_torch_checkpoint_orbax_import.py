"""The JAX package's orbax checkpoint directories read by the port (CPU).

The JAX package writes each state with its own ``save_checkpoint`` three
times: ``backend="orbax"``, ``"orbax_async"`` and ``"msgpack"``.  The port's
``read_flax_checkpoint`` of either directory must equal its read of the
msgpack file bit for bit (keys, types, dtypes, shapes and bytes; the msgpack
reader is held against flax in tests/test_torch_checkpoint_import.py), and a
port trainer's ``restore`` from the directory must leave the state that its
``restore`` from the msgpack file leaves, bit for bit.  The OCDBT store is
also held against tensorstore's own listing and reads; zarr arrays that
tensorstore writes with edge chunks, another byte order and no compressor
read as written; and what the reader does not know raises a ``ValueError``
that names it.  No JAX step runs: states come from ``jax.eval_shape`` with
redrawn values (tests/jax_weights.py).
"""

import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import tensorstore as ts
import torch
import yaml

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax_weights import redraw
from orbax_fixture import FIXTURE, describe, write_fixture
from test_torch_checkpoint_dir import _copy, _same
from test_torch_main_train import CPU, ldm_cfg
from test_torch_train_ldm import B as LDM_B, IMG as LDM_IMG, T as LDM_T, TINY as LDM_TINY
from test_torch_train_reg import _opts as reg_opts
from test_torch_train_vae import WIDTHS as VAE_WIDTHS
from slice3d_tpu.config import Options as JaxOptions
from slice3d_tpu.data.builders import create_synthetic_dataset
from slice3d_tpu.diffusion.latent import LatentDiffusion as JaxLatentDiffusion
from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.gtslice import GTSliceModel as JaxGTSlice
from slice3d_tpu.train import train_vae as jax_train_vae
from slice3d_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from slice3d_tpu.train.checkpoint import wait_pending as jax_wait_pending
from slice3d_tpu.train.train_ldm import LDMTrainer as JaxLDMTrainer
from slice3d_tpu.train.train_reg import RegressionTrainer as JaxRegTrainer
from slice3d_tpu_torch import main as port_main
from slice3d_tpu_torch.config import Options
from slice3d_tpu_torch.diffusion.latent import LatentDiffusion
from slice3d_tpu_torch.models.build import load_model
from slice3d_tpu_torch.train import checkpoint as ckpt
from slice3d_tpu_torch.train.flax_msgpack import read_flax_checkpoint, read_flax_msgpack
from slice3d_tpu_torch.train.flax_orbax import read_flax_orbax
from slice3d_tpu_torch.train.ocdbt import OcdbtReader
from slice3d_tpu_torch.train.train_ldm import LDMTrainer
from slice3d_tpu_torch.train.train_reg import RegressionTrainer
from slice3d_tpu_torch.train.train_vae import VAEFinetuneTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ("orbax", "orbax_async", "msgpack")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_tree(got, want, where=""):
    """Two read trees equal bit for bit: dict keys, types, dtypes, shapes, bytes."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, np.ndarray):
        assert (got.dtype, got.shape) == (want.dtype, want.shape), where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


def write_all(save, path):
    """``save(path, backend)`` for each backend; the written paths by backend."""
    out = {b: save(f"{path}.{b}", b) for b in BACKENDS}
    jax_wait_pending()
    assert os.path.isdir(out["orbax"]) and os.path.isfile(out["msgpack"])
    return out


def tensorstore_items(path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}"}).result()
    return {k: kv.read(k).result().value for k in sorted(kv.list().result())}


# -- (a) synthetic trees -----------------------------------------------------------------


def _synthetic(kind):
    rng = np.random.default_rng(5)
    normal = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    devices = np.array(jax.devices()[:8])
    if kind == "sharded":
        row = NamedSharding(Mesh(devices, ("d",)), P("d"))
        grid = NamedSharding(Mesh(devices.reshape(4, 2), ("a", "b")), P("a", "b"))
        return {"rows": jax.device_put(jnp.asarray(normal(64, 48)), row),
                "grid": jax.device_put(jnp.asarray(normal(16, 6, 3)), grid),
                "cols": jax.device_put(jnp.asarray(normal(5, 40)),
                                       NamedSharding(Mesh(devices, ("d",)), P(None, "d"))),
                "whole": jnp.asarray(normal(7, 3))}
    if kind == "dtypes":
        return {"bf16": jnp.asarray(normal(33, 5) * 100).astype(jnp.bfloat16),
                "f16": jnp.asarray(normal(9)).astype(jnp.float16),
                "f64": np.linspace(-1, 1, 11), "i8": np.arange(-60, 60, 7, dtype=np.int8),
                "u8": np.arange(200, dtype=np.uint8), "i64": np.arange(9, dtype=np.int64) << 40,
                "bool": np.array([True, False, True]),
                "c64": (normal(4) + 1j).astype(np.complex64)}  # (orbax refuses size 0)
    # the entries that orbax stores otherwise than msgpack: None and empty
    # dicts as tree metadata only, Python and numpy scalars as 0-d zarr arrays
    return {"none": None, "empty": {}, "nested": {"empty": {}, "none": None,
                                                  "leaf": jnp.float32(2.5)},
            "py_int": 7, "py_float": -1.25, "py_bool": True, "np_i32": np.int32(-3),
            "np_i64": np.int64(1 << 40), "np_f32": np.float32(0.5), "zero_d": np.asarray(4.0)}


SCALAR_ENTRIES = {"none": None, "empty": {}, "py_int": np.asarray(7), "py_float":
                  np.asarray(-1.25), "py_bool": np.asarray(True), "np_i32": np.asarray(-3, np.int32),
                  "np_i64": np.asarray(1 << 40), "np_f32": np.asarray(0.5, np.float32),
                  "zero_d": np.asarray(4.0)}


@pytest.mark.parametrize("kind", ["sharded", "dtypes", "scalars"])
def test_synthetic_trees_read_like_msgpack(kind, tmp_path):
    tree = _synthetic(kind)
    paths = write_all(lambda p, b: jax_save_checkpoint(p, tree, backend=b), str(tmp_path / kind))
    want = read_flax_msgpack(paths["msgpack"])
    for backend in ("orbax", "orbax_async"):
        same_tree(read_flax_checkpoint(paths[backend]), want, backend)
    if kind == "scalars":  # each entry that orbax stores otherwise, by name
        got = read_flax_orbax(paths["orbax"])
        for name, value in SCALAR_ENTRIES.items():
            same_tree(got[name], value, name)
        same_tree(got["nested"], {"empty": {}, "none": None,
                                  "leaf": np.asarray(2.5, np.float32)})
    if kind == "sharded":  # one chunk a shard
        keys = list(OcdbtReader(paths["orbax"]).entries())
        assert sum(k.startswith(b"rows/") for k in keys) == 8 + 1
        assert sum(k.startswith(b"grid/") for k in keys) == 8 + 1
    # the OCDBT store: tensorstore's keys and values
    reader = OcdbtReader(paths["orbax"])
    mine = {k: reader.read(v) for k, v in reader.entries().items()}
    assert mine == tensorstore_items(paths["orbax"])


def test_zarr_arrays_written_by_tensorstore(tmp_path):
    """Edge chunks cropped, a big-endian dtype, no compressor, a 3-D chunk
    grid, several data files and interior B-tree nodes (small nodes) read as
    tensorstore wrote them."""
    base = str(tmp_path / "store")
    rng = np.random.default_rng(3)
    arrays = {"edge": (rng.standard_normal((10, 7, 3)).astype(np.float32), [4, 3, 2],
                       {"id": "zstd", "level": 3}, "<f4"),
              "big_endian": (np.arange(30, dtype=np.int32).reshape(6, 5), [4, 4], None, ">i4"),
              "many": (rng.integers(0, 9, (40, 4)).astype(np.int64), [1, 4],
                       {"id": "zstd", "level": 19}, "<i8")}
    kv = {"driver": "ocdbt", "base": f"file://{base}",
          "config": {"max_decoded_node_bytes": 256, "max_inline_value_bytes": 16}}
    for name, (value, chunks, compressor, dtype) in arrays.items():
        arr = ts.open({"driver": "zarr", "kvstore": {**kv, "path": f"{name}/"},
                       "metadata": {"shape": list(value.shape), "chunks": chunks,
                                    "dtype": dtype, "compressor": compressor},
                       "create": True}).result()
        arr.write(value).result()
    meta = {"tree_metadata": {f"('{n}',)": {"key_metadata": [{"key": n, "key_type": 2}],
                                            "value_metadata": {"value_type": "np.ndarray"}}
                              for n in arrays},
            "use_ocdbt": True, "use_zarr3": False}
    with open(os.path.join(base, "_METADATA"), "w") as f:
        json.dump(meta, f)
    got = read_flax_orbax(base)
    for name, (value, *_) in arrays.items():
        assert got[name].dtype == value.dtype.newbyteorder("=")
        np.testing.assert_array_equal(got[name], value)
    reader = OcdbtReader(base)
    assert {k: reader.read(v) for k, v in reader.entries().items()} == tensorstore_items(base)
    assert reader.generation > 1  # one version a write


# -- (b) each JAX trainer's state ----------------------------------------------------------


def _tree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _ldm(use_ema):
    trainer = JaxLDMTrainer(img_size=LDM_IMG, batch_size=LDM_B, timesteps=LDM_T,
                            module=JaxLatentDiffusion(**LDM_TINY), use_ema=use_ema)
    shapes = jax.eval_shape(trainer.init_state, 0)
    variables = redraw({"params": shapes.params, "batch_stats": shapes.batch_stats}, 80)
    params = _tree(variables["params"])
    logvar = jnp.linspace(-1, 1, LDM_T, dtype=jnp.float32)
    ema = _tree(redraw({"params": {k: v for k, v in shapes.params.items()
                                   if k != "first_stage"}}, 86)["params"]) if use_ema else \
        shapes.ema_params
    state = shapes.replace(step=jnp.int32(9), params=params, ema_params=ema, logvar=logvar,
                           batch_stats=_tree(variables["batch_stats"]),
                           scale_factor=jnp.float32(0.8),
                           opt_state=trainer.tx.init({"net": params, "logvar": logvar}))
    port = LDMTrainer(img_size=LDM_IMG, batch_size=LDM_B, timesteps=LDM_T,
                      module=LatentDiffusion(**LDM_TINY).eval(), device="cpu",
                      use_ema=use_ema)
    return (trainer, state, lambda tr, s, p: tr.save(s, p), port,
            lambda tr, p: tr.restore(tr.init_state(), p), lambda tr, s: tr.shard_payload(s))


def _vae():
    trainer = jax_train_vae.VAEFinetuneTrainer(**VAE_WIDTHS)
    shapes = jax.eval_shape(trainer.init_state, 0)
    disc = redraw({"params": shapes.disc_params, "batch_stats": shapes.disc_stats}, 81)
    params = redraw({"params": shapes.params}, 82)["params"]
    state = _tree(shapes.replace(step=jnp.int32(5), params=params, disc_params=disc["params"],
                                 disc_stats=disc["batch_stats"],
                                 opt_state=trainer.tx.init(params),
                                 disc_opt_state=trainer.tx_d.init(disc["params"])))
    port = VAEFinetuneTrainer(device="cpu", **VAE_WIDTHS)
    return (trainer, state, lambda tr, s, p: tr.save(s, p), port,
            lambda tr, p: tr.restore(tr.init_state(seed=3), p),
            lambda tr, s: tr.shard_payload(s))


def _reg(name):
    trainer = JaxRegTrainer(reg_opts(JaxOptions, name), steps_per_epoch=4)
    shapes = jax.eval_shape(trainer.init_state)
    variables = redraw({"params": shapes.params, "batch_stats": shapes.batch_stats}, 83)
    params = _tree(variables["params"])
    state = shapes.replace(step=jnp.int32(12), params=params, opt_state=trainer.tx.init(params),
                           batch_stats=_tree(variables["batch_stats"]))

    def save(tr, s, p):
        os.makedirs(p, exist_ok=True)
        return tr.save(s, p, 2, {"acc": 0.5})

    port = RegressionTrainer(reg_opts(Options, name), steps_per_epoch=4, device="cpu")
    return (trainer, state, save, port, lambda tr, p: tr.restore(tr.init_state(seed=4), p)[0],
            lambda tr, s: tr.shard_payload(s, 0))


@pytest.mark.parametrize("kind", ["ldm_ema", "ldm_no_ema", "vae", "slicenet", "gtslice"])
def test_trainer_restores_a_directory_like_its_msgpack_twin(kind, tmp_path):
    make = {"ldm_ema": lambda: _ldm(True), "ldm_no_ema": lambda: _ldm(False), "vae": _vae,
            "slicenet": lambda: _reg("slicenet"), "gtslice": lambda: _reg("gtslice")}[kind]
    jtrainer, state, save, port, restore, payload = make()

    def write(path, backend):
        jtrainer.ckpt_backend = backend
        if hasattr(jtrainer, "opts"):  # the regression trainer reads its options'
            jtrainer.opts.ckpt_backend = backend
        return save(jtrainer, state, path)

    paths = write_all(write, str(tmp_path / kind))
    want_tree = read_flax_msgpack(paths["msgpack"])
    want = _copy(payload(port, restore(port, paths["msgpack"])))
    for backend in ("orbax", "orbax_async"):
        same_tree(read_flax_checkpoint(paths[backend]), want_tree, backend)
        _same(_copy(payload(port, restore(port, paths[backend]))), want, backend)
    for path in paths.values():  # up to ~100 MB each
        shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)


# -- (c) load_model ------------------------------------------------------------------------------


def test_load_model_reads_full_width_gtslice_variables(tmp_path):
    opts = JaxOptions(name_model="gtslice", img_size=128)
    shapes = jax.eval_shape(lambda: init_variables(JaxGTSlice(n_slices=opts.n_slices), opts))
    variables = _tree(redraw(shapes, 84))
    paths = write_all(lambda p, b: jax_save_checkpoint(p, {"variables": variables}, backend=b),
                      str(tmp_path / "gtslice"))
    port_opts = Options(name_model="gtslice", img_size=128, dtype="float32")
    want = load_model(port_opts, paths["msgpack"]).state_dict()
    for backend in ("orbax", "orbax_async"):
        _same(load_model(port_opts, paths[backend]).state_dict(), want, backend)


# -- (d) a write by two processes --------------------------------------------------------------

WORKER = r"""
import os, sys
pid, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {root!r})
import jax
jax.config.update("jax_platforms", "cpu")
from slice3d_tpu.parallel import init_distributed
init_distributed(coordinator=f"127.0.0.1:{{port}}", num_processes=2, process_id=pid)
sys.path.insert(0, os.path.join({root!r}, "tests"))
from test_torch_checkpoint_orbax_import import two_process_state
from slice3d_tpu.train.checkpoint import save_checkpoint
save_checkpoint(path, two_process_state(), backend="orbax")
print("saved", pid, flush=True)
"""


def two_process_state():
    """Sharded over every device of the run (8: 2 processes of 4, or one of 8)."""
    rng = np.random.default_rng(9)
    devices = np.array(jax.devices()[:8])
    rows = NamedSharding(Mesh(devices, ("d",)), P("d"))
    grid = NamedSharding(Mesh(devices.reshape(2, 4), ("a", "b")), P("a", "b"))
    put = lambda v, s: jax.make_array_from_callback(v.shape, s, lambda i: v[i])  # noqa: E731
    return {"rows": put(rng.standard_normal((64, 24)).astype(np.float32), rows),
            "grid": put(rng.standard_normal((8, 16)).astype(np.float32), grid),
            "step": 3}


def test_a_two_process_write_reads_like_a_one_process_write(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(root=ROOT))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    two = str(tmp_path / "two")
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid), str(port), two], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for pid in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()[-3000:]
    assert sorted(n for n in os.listdir(two) if n.startswith("ocdbt.process_")) == [
        "ocdbt.process_0", "ocdbt.process_1"]
    one = jax_save_checkpoint(str(tmp_path / "one"), two_process_state(), backend="orbax")
    same_tree(read_flax_checkpoint(two), read_flax_checkpoint(one))
    reader = OcdbtReader(two)
    assert {k: reader.read(v) for k, v in reader.entries().items()} == tensorstore_items(two)


# -- (e) main -t -r ------------------------------------------------------------------------------


def test_main_resumes_a_jax_orbax_checkpoint(tmp_path, monkeypatch):
    """``-t -r <run>/checkpoints/last.ckpt`` and ``-t -r <run>`` on the JAX
    trainer's orbax ``last.ckpt`` (saved at step 3, as the root ``main.py
    -t --ckpt_backend orbax`` writes it): the port continues at step 4 in
    that run's logdir."""
    import main as root_main

    root = create_synthetic_dataset(str(tmp_path / "ds"), n_shapes=2, n_views=6, img_size=16,
                                    n_sdf=64)
    cfg = ldm_cfg(root)
    cfg_path = str(tmp_path / "ldm.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    _, jtrainer, _, _ = root_main.build_module_and_trainer(cfg, True)
    shapes = jax.eval_shape(jtrainer.init_state, 0)
    variables = redraw({"params": shapes.params, "batch_stats": shapes.batch_stats}, 85)
    params = _tree(variables["params"])
    state = shapes.replace(params=params, batch_stats=_tree(variables["batch_stats"]),
                           ema_params={k: v for k, v in params.items() if k != "first_stage"},
                           scale_factor=jnp.float32(0.9), step=jnp.int32(3),
                           logvar=jnp.zeros((20,), jnp.float32),
                           opt_state=jtrainer.tx.init({"net": params,
                                                       "logvar": jnp.zeros((20,))}))
    steps = []
    real = LDMTrainer.train_step

    def spy(self, st, *a, **k):
        st, logs = real(self, st, *a, **k)
        steps.append(st.step)
        return st, logs

    monkeypatch.setattr(LDMTrainer, "train_step", spy)
    monkeypatch.setattr(port_main, "scalar_writer", lambda log_dir: type(
        "W", (), {"add_scalar": lambda *a: None, "close": lambda self: None})())
    flags = ["--max_steps", "4", "--val_every", "0", "--log_images_every", "0"] + CPU
    for how, backend in (("file", "orbax"), ("logdir", "orbax_async")):
        run = str(tmp_path / how)
        last = os.path.join(run, "checkpoints", "last.ckpt")
        jtrainer.ckpt_backend = backend
        jtrainer.save(state, last)
        jax_wait_pending()
        target = last if how == "file" else run
        assert port_main.main(["-b", cfg_path, "-t", "-r", target] + flags) == run
        assert ckpt.restore_checkpoint(last, keys=("step",))["step"] == 4
    assert steps == [4, 4]


# -- (f) the committed fixture ---------------------------------------------------------------


def test_the_committed_fixture_regenerates(tmp_path):
    """The JAX package writes the fixture again (new file names, the same
    arrays): both read to the leaves that the committed ``expected.json``
    gives, and its level-19 frame to the bytes it names."""
    with open(os.path.join(FIXTURE, "expected.json")) as f:
        committed = json.load(f)
    fresh = write_fixture(str(tmp_path / "fixture"))
    assert fresh == committed
    for d in (FIXTURE, str(tmp_path / "fixture")):
        tree = read_flax_checkpoint(os.path.join(d, "state"))
        assert describe(tree) == committed["leaves"]
        assert tree["none"] is None and tree["params"]["empty"] == {}
    from slice3d_tpu_torch.train.zstd import decompress

    with open(os.path.join(FIXTURE, "level19.zst"), "rb") as f:
        head = decompress(f.read())
    assert len(head) == committed["level19"]["size"]
    assert hashlib.sha256(head).hexdigest() == committed["level19"]["sha256"]
    assert sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(FIXTURE)
               for n in ns) <= 512 * 1024


# -- (g) what the reader refuses --------------------------------------------------------------


def _fixture_copy(tmp_path):
    return shutil.copytree(os.path.join(FIXTURE, "state"), str(tmp_path / "state"))


def _edit_metadata(path, **changes):
    meta_path = os.path.join(path, "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    for k, v in changes.items():
        if k == "value_type":
            next(iter(meta["tree_metadata"].values()))["value_metadata"]["value_type"] = v
        else:
            meta[k] = v
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def _zarr_store(tmp_path, compressor=None, zarray=None):
    """An 8 x 4 array in 4 x 4 chunks of which only the first is written, its
    ``.zarray`` updated by ``zarray`` after the write."""
    base = str(tmp_path / "store")
    kv = {"driver": "ocdbt", "base": f"file://{base}"}
    arr = ts.open({"driver": "zarr", "kvstore": {**kv, "path": "x/"},
                   "metadata": {"shape": [8, 4], "chunks": [4, 4], "dtype": "<f4",
                                "compressor": compressor}, "create": True}).result()
    arr[:4].write(np.ones((4, 4), np.float32)).result()
    if zarray:
        store = ts.KvStore.open(kv).result()
        meta = json.loads(store.read(b"x/.zarray").result().value)
        store.write(b"x/.zarray", json.dumps({**meta, **zarray}).encode()).result()
    with open(os.path.join(base, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": {"('x',)": {"key_metadata": [{"key": "x", "key_type": 2}],
                                               "value_metadata": {"value_type": "jax.Array"}}},
                   "use_ocdbt": True, "use_zarr3": False}, f)
    return base


@pytest.mark.parametrize("case", ["crc", "zarr3", "no_ocdbt", "value_type", "compressor",
                                  "filters", "missing_chunk", "empty_dir", "msgpack_reader"])
def test_what_the_reader_refuses(case, tmp_path):
    if case == "crc":
        path = _fixture_copy(tmp_path)
        manifest = os.path.join(path, "manifest.ocdbt")
        data = bytearray(open(manifest, "rb").read())
        data[20] ^= 0x10
        open(manifest, "wb").write(bytes(data))
        match = "CRC-32C mismatch"
    elif case in ("zarr3", "no_ocdbt", "value_type"):
        path = _fixture_copy(tmp_path)
        _edit_metadata(path, **{"zarr3": {"use_zarr3": True}, "no_ocdbt": {"use_ocdbt": False},
                                "value_type": {"value_type": "string"}}[case])
        match = {"zarr3": "use_zarr3", "no_ocdbt": "use_ocdbt",
                 "value_type": "value_type 'string'"}[case]
    elif case == "compressor":
        path = _zarr_store(tmp_path, compressor={"id": "zlib", "level": 1})
        match = "compressor 'zlib'"
    elif case == "filters":
        path = _zarr_store(tmp_path, zarray={"filters": [{"id": "delta", "dtype": "<f4"}]})
        match = "filters"
    elif case == "missing_chunk":
        path = _zarr_store(tmp_path)
        match = "chunk x/1.0 is missing"
    else:
        path = str(tmp_path / "empty")
        os.makedirs(path)
        match = ("not a checkpoint" if case == "empty_dir"
                 else "is a directory, not a msgpack file: read_flax_checkpoint")
    read = read_flax_msgpack if case == "msgpack_reader" else read_flax_checkpoint
    with pytest.raises(ValueError, match=match):
        read(path)
