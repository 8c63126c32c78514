"""The JAX package's checkpoints read by the port (CPU, fp32).

Checkpoints are written by the JAX package's own ``save_checkpoint(...,
backend="msgpack")`` in the shapes its trainers give them: ``train_reg``'s
payload (variables, an optax Adam state, epoch and step) for SliceNet,
GTSlice and DISN, ``train_cam``'s (variables only) for CameraNet, and
``LDMTrainer.save``'s for the latent-diffusion model.  The port's
``load_model`` / ``load_camnet`` / ``LDMTrainer.restore`` read them with its
own msgpack reader (no flax, no msgpack) and must give the JAX models'
outputs on the same inputs: atol 5e-4 / rtol 1e-3 (fp32, another summation
order).  Chunked large arrays, bf16 leaves and an orbax directory (read like
its msgpack twin; tests/test_torch_checkpoint_orbax_import.py holds the
rest) are covered on their own.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from jax_weights import redraw
from slice3d_tpu import camera as jax_camera
from slice3d_tpu.diffusion.latent import LatentDiffusion as JaxLatentDiffusion
from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.camnet import CameraNet as JaxCameraNet
from slice3d_tpu.models.disn import DISNModel as JaxDISN
from slice3d_tpu.models.gtslice import GTSliceModel as JaxGTSlice
from slice3d_tpu.models.slicenet import SliceNetModel as JaxSliceNet
from slice3d_tpu.train.checkpoint import save_checkpoint
from slice3d_tpu.train.train_ldm import LDMTrainer as JaxLDMTrainer
from slice3d_tpu_torch import camera
from slice3d_tpu_torch.config import Options
from slice3d_tpu_torch.diffusion.latent import LatentDiffusion
from slice3d_tpu_torch.models.build import load_camnet, load_model
from slice3d_tpu_torch.train.flax_msgpack import (decode_msgpack, read_flax_checkpoint,
                                                  read_flax_msgpack)
from slice3d_tpu_torch.train.train_ldm import LDMTrainer

TOL = dict(atol=5e-4, rtol=1e-3)
IMG, M = 32, 61


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy() if hasattr(got, "detach") else got,
                               np.asarray(want), **TOL)


def _reg_payload(variables):
    """``train_reg.py``'s checkpoint payload (train_reg.py:226-233)."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return {"variables": variables, "opt_state": optax.adam(3e-4).init(params),
            "n_epoch": 3, "n_iter": 1234}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    rot, proj = camera.camera_matrices(0.5, 0.1, 1.2)
    qry = (rng.uniform(-0.5, 0.5, (1, M, 3)) @ rot).astype(np.float32)
    return rng, qry, proj[None].astype(np.float32)


def _opts(tmp_path, name):
    return Options(name_model=name, img_size=IMG, dtype="float32",
                   dir_experiments=str(tmp_path), name_exp="exp")


@pytest.mark.parametrize("chunk", [None, 4096], ids=["whole", "chunked"])
def test_slicenet_msgpack_loads_like_jax(tmp_path, monkeypatch, chunk):
    """A SliceNet ``train_reg`` checkpoint; "chunked" writes it with flax's
    ``MAX_CHUNK_SIZE`` at 4 KiB, so every larger leaf is split into chunks."""
    if chunk:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    jmodel = JaxSliceNet(n_slices=12)
    variables = redraw(init_variables(jmodel, _opts(tmp_path, "slicenet"), seed=0), 50)
    path = save_checkpoint(str(tmp_path / "exp" / "ckpt" / "reg.ckpt"), _reg_payload(variables))
    if chunk:
        raw = decode_msgpack(open(path, "rb").read())
        assert raw["variables"]["params"]["head"]["fc_s"]["kernel"][
            "__msgpack_chunked_array__"]
    model = load_model(_opts(tmp_path, "slicenet"), path)
    rng, qry, trans = _inputs(51)
    img = rng.uniform(-1, 1, (1, IMG, IMG, 3)).astype(np.float32)
    j_packed, j_slices = jmodel.apply(variables, jnp.asarray(img),
                                      method=JaxSliceNet.encode_folded)
    want = jmodel.apply(variables, j_packed, jnp.asarray(qry), jnp.asarray(trans),
                        method=JaxSliceNet.query_folded)
    with torch.no_grad():
        packed, slices = model.encode_folded(torch.from_numpy(img))
        got = model.query_folded(packed, torch.from_numpy(qry), torch.from_numpy(trans))
    _close(slices, j_slices)
    _close(got, want)


def test_gtslice_msgpack_loads_like_jax(tmp_path):
    jmodel = JaxGTSlice(n_slices=12)
    variables = redraw(init_variables(jmodel, _opts(tmp_path, "gtslice"), seed=0), 52)
    path = save_checkpoint(str(tmp_path / "gt.ckpt"), _reg_payload(variables))
    model = load_model(_opts(tmp_path, "gtslice"), path)
    rng, qry, trans = _inputs(53)
    slices = rng.uniform(-1, 1, (1, 12, IMG, IMG, 3)).astype(np.float32)
    j_packed = jmodel.apply(variables, jnp.asarray(slices), method=JaxGTSlice.encode_folded)
    want = jmodel.apply(variables, j_packed, jnp.asarray(qry), jnp.asarray(trans),
                        method=JaxGTSlice.query_folded)
    with torch.no_grad():
        got = model.query_folded(model.encode_folded(torch.from_numpy(slices)),
                                 torch.from_numpy(qry), torch.from_numpy(trans))
    _close(got, want)


def test_disn_msgpack_loads_like_jax(tmp_path):
    rng = np.random.default_rng(54)
    x = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    qry = rng.uniform(-0.5, 0.5, (2, M, 3)).astype(np.float32)
    views = [(0.3, 0.1, 1.2), (-1.0, -0.2, 1.1)]
    full = np.stack([jax_camera.full_projection_matrix(*v) for v in views]).astype(np.float32)
    rot = np.stack([jax_camera.camera_matrices(*v)[0] for v in views]).astype(np.float32)
    jmodel = JaxDISN()
    variables = redraw(jmodel.init(jax.random.PRNGKey(0), x, qry, full, rot), 55)
    path = save_checkpoint(str(tmp_path / "disn.ckpt"), _reg_payload(variables))
    model = load_model(_opts(tmp_path, "disn"), path)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (x, qry, full, rot)))
    _close(got, jmodel.apply(variables, x, qry, full, rot))


def test_camnet_msgpack_loads_like_jax(tmp_path):
    """``train_cam.py``'s payload (variables only, train_cam.py:137), read by
    ``load_camnet`` from ``<dir_experiments>/<name_exp_cam>/ckpt``."""
    x = np.random.default_rng(56).uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    jmodel = JaxCameraNet()
    variables = redraw(jmodel.init(jax.random.PRNGKey(0), x), 57)
    save_checkpoint(str(tmp_path / "cam_exp" / "ckpt" / "0_10_0.5.ckpt"),
                    {"variables": variables})
    opts = Options(img_size=IMG, dir_experiments=str(tmp_path), name_exp_cam="cam_exp",
                   name_ckpt_cam="0_10_0.5.ckpt")
    model = load_camnet(opts)
    want = jmodel.apply(variables, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def test_bare_variables_and_torch_files_still_load(tmp_path):
    """A msgpack of the bare variables (no payload around them) reads as the
    JAX package's ``load_model_variables`` reads it, and a torch file of the
    same weights gives the same model."""
    jmodel = JaxGTSlice(n_slices=12)
    variables = redraw(init_variables(jmodel, _opts(tmp_path, "gtslice"), seed=0), 58)
    bare = load_model(_opts(tmp_path, "gtslice"),
                      save_checkpoint(str(tmp_path / "bare.ckpt"), variables))
    torch.save(bare.state_dict(), tmp_path / "ref.ckpt")
    again = load_model(_opts(tmp_path, "gtslice"), str(tmp_path / "ref.ckpt"))
    for k, v in bare.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


def test_reader_equals_flax_on_every_leaf_kind(tmp_path):
    """ints of every width, floats, None, bools, strings, numpy scalars, a
    complex, empty and 0-d arrays, bf16 (widened exactly to fp32) and
    lists, against ``flax.serialization.msgpack_restore``."""
    tree = {"i": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 62, -1, -32, -33, -128,
                  -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 62],
            "f": [1.5, -0.0, 1e300], "n": None, "b": [True, False], "s": ["", "x" * 40,
                                                                        "y" * 300, "z" * 70000],
            "np": {"f32": np.float32(2.5), "i64": np.int64(-7)}, "c": complex(1, -2),
            "a": {"e": np.zeros((0, 3), np.int32), "s": np.asarray(3.0, np.float32),
                  "u8": np.arange(300).astype(np.uint8), "f64": np.linspace(0, 1, 7),
                  "bf16": np.asarray(jnp.asarray([1.5, -3.25, 1e-3, 7e30], jnp.bfloat16))}}
    data = serialization.msgpack_serialize(tree)
    got, want = decode_msgpack(data), serialization.msgpack_restore(data)
    bf = got["a"].pop("bf16")
    assert bf.dtype == np.float32
    np.testing.assert_array_equal(bf, np.asarray(want["a"].pop("bf16"), np.float32))

    def same(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b, (a, b)

    same(got, want)


def test_orbax_directory_is_refused_with_the_conversion(tmp_path):
    """An orbax directory of the JAX package is no longer refused: it loads
    like its msgpack twin (the same variables written with
    ``backend="msgpack"``), through ``load_model`` and
    ``read_flax_checkpoint``; ``read_flax_msgpack`` alone reads files and
    names ``read_flax_checkpoint`` for a directory."""
    jmodel = JaxGTSlice(n_slices=12)
    variables = init_variables(jmodel, _opts(tmp_path, "gtslice"), seed=0)
    path = save_checkpoint(str(tmp_path / "orbax.ckpt"), {"variables": variables},
                           backend="orbax")
    twin = save_checkpoint(str(tmp_path / "msgpack.ckpt"), {"variables": variables})
    assert os.path.isdir(path) and os.path.isfile(twin)
    got = load_model(_opts(tmp_path, "gtslice"), path).state_dict()
    want = load_model(_opts(tmp_path, "gtslice"), twin).state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    tree, twin_tree = read_flax_checkpoint(path), read_flax_msgpack(twin)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert [k for k, _ in flat] == [k for k, _ in jax.tree_util.tree_leaves_with_path(twin_tree)]
    for (_, a), b in zip(flat, jax.tree_util.tree_leaves(twin_tree)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="is a directory, not a msgpack file: "
                                         "read_flax_checkpoint"):
        read_flax_msgpack(path)


# -- the latent-diffusion trainer's checkpoint ----------------------------------------

LDM_IMG, B = 16, 2
TINY = dict(timesteps=20, vae_ch=32, vae_mult=(1, 2), vae_nres=1, unet_channels=32,
            unet_mult=(1, 2), unet_nres=1, unet_attention_ds=(1, 2),
            unet_inject_blocks=(0, 3), cond_widths=(32, 64), latent_size=LDM_IMG // 2)


def test_ldm_trainer_checkpoint_samples_like_jax_under_ema(tmp_path):
    """A JAX ``LDMTrainer.save`` (params, an EMA that differs from them,
    scale_factor, logvar, step, Adam state) restored by the port's
    ``LDMTrainer.restore``: the same step and logvar, and the same slices
    from DDIM under the EMA weights with JAX's draws; atol 5e-4."""
    jtrainer = JaxLDMTrainer(img_size=LDM_IMG, batch_size=B, timesteps=20,
                             module=JaxLatentDiffusion(**TINY))
    state = jtrainer.init_state(seed=0)
    variables = redraw({"params": state.params, "batch_stats": state.batch_stats}, 60)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    ema = redraw({"params": {k: v for k, v in variables["params"].items()
                             if k != "first_stage"}}, 61)["params"]
    state = state.replace(params=params,
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]),
                          ema_params=jax.tree_util.tree_map(jnp.asarray, ema),
                          scale_factor=jnp.float32(0.7),
                          logvar=jnp.linspace(-0.5, 0.5, 20, dtype=jnp.float32),
                          step=jnp.asarray(77, jnp.int32))
    path = jtrainer.save(state, str(tmp_path / "checkpoints" / "last.ckpt"))

    trainer = LDMTrainer(img_size=LDM_IMG, batch_size=B, timesteps=20,
                         module=LatentDiffusion(**TINY), device="cpu")
    port = trainer.restore(trainer.init_state(), path)
    assert port.step == 77 and float(port.ldm.scale_factor) == pytest.approx(0.7)
    np.testing.assert_array_equal(port.logvar.numpy(), np.asarray(state.logvar))

    views = np.random.default_rng(62).uniform(-1, 1, (B, 13, LDM_IMG, LDM_IMG, 3))
    batch = {"image": views.astype(np.float32), "img_ipt_view": views[:, 12].astype(np.float32)}
    key = jax.random.PRNGKey(63)
    want = jtrainer.sample_slices(state, batch, ddim_steps=2, eta=1.0, rng=key, use_ema=True)
    rest, enc_key = jax.random.split(key)
    h = LDM_IMG // 2
    post = np.array(jax.random.normal(enc_key, (B * 13, h, h, 4), jnp.float32))
    rest, init_key = jax.random.split(rest)
    shape = (B, 4 * h, 4 * h, 4)
    draws = dict(posterior_noise=torch.from_numpy(post.reshape(B, 13, h, h, 4)[:, 12]),
                 x_T=torch.from_numpy(np.array(jax.random.normal(init_key, shape))),
                 step_noises=[torch.from_numpy(np.array(jax.random.normal(k, shape)))
                              for k in jax.random.split(rest, 2)])
    got = trainer.sample_slices(port, batch["img_ipt_view"], ddim_steps=2, eta=1.0, **draws)
    _close(got, want)
    # the EMA is what made it: the raw weights sample something else
    raw = trainer.sample_slices(port, batch["img_ipt_view"], ddim_steps=2, eta=1.0,
                                use_ema=False, **draws)
    assert float((raw - got).abs().max()) > 1e-2
