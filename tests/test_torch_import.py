"""The port stands alone: no JAX and no slice3d_tpu import, and the weight
bridge inverts the JAX package's torch importer."""

import ast
import os
import subprocess
import sys

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_weights import redraw
from torch_refs import TorchSliceNetRef, randomize_bn_stats
from slice3d_tpu.convert import torch_import
from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.cond_encoder import CondImageEncoder as JaxCond
from slice3d_tpu.models.gtslice import GTSliceModel as JaxGTSlice
from slice3d_tpu.models.ldm_unet import LDMUNet as JaxUNet
from slice3d_tpu.models.vae import AutoencoderKL as JaxVAE
import slice3d_tpu_torch
from slice3d_tpu_torch import convert
from slice3d_tpu_torch.convert import slicenet_state_dict
from slice3d_tpu_torch.diffusion.latent import LatentDiffusion
from slice3d_tpu_torch.models.gtslice import GTSliceModel
from slice3d_tpu_torch.models.slicenet import init_slicenet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "slice3d_tpu_torch")


def test_import_leaves_jax_out():
    code = ("import sys, slice3d_tpu_torch, slice3d_tpu_torch.pipeline, "
            "slice3d_tpu_torch.convert, slice3d_tpu_torch.diffusion.sampler, "
            "slice3d_tpu_torch.models.gtslice, slice3d_tpu_torch.train.train_ldm, "
            "slice3d_tpu_torch.profile_training, slice3d_tpu_torch.serve, "
            "slice3d_tpu_torch.reconstruct, slice3d_tpu_torch.config, "
            "slice3d_tpu_torch.data.dataset, slice3d_tpu_torch.data.image, "
            "slice3d_tpu_torch.models.build, slice3d_tpu_torch.ops.fused_ffn, "
            "slice3d_tpu_torch.models.disn, slice3d_tpu_torch.models.camnet, "
            "slice3d_tpu_torch.mesh.refine, slice3d_tpu_torch.mesh.io, "
            "slice3d_tpu_torch.mesh.voxels, slice3d_tpu_torch.eval.cli, "
            "slice3d_tpu_torch.eval.__main__, slice3d_tpu_torch.main, "
            "slice3d_tpu_torch.re_org_slices, slice3d_tpu_torch.reconstruct_slices, "
            "slice3d_tpu_torch.create_dataset_sin_img, slice3d_tpu_torch.diffusion.plms, "
            "slice3d_tpu_torch.diffusion.dpm, slice3d_tpu_torch.diffusion.ancestral, "
            "slice3d_tpu_torch.train.flax_msgpack, slice3d_tpu_torch.utils.yaml_config, "
            "slice3d_tpu_torch.train.train_reg, slice3d_tpu_torch.train.train_cam, "
            "slice3d_tpu_torch.train.__main__, slice3d_tpu_torch.train_gt, "
            "slice3d_tpu_torch.train_cam, slice3d_tpu_torch.models.perceptual, "
            "slice3d_tpu_torch.data.device_transforms, slice3d_tpu_torch.train.train_vae, "
            "slice3d_tpu_torch.models.lpips, slice3d_tpu_torch.models.discriminator, "
            "slice3d_tpu_torch.dryrun, slice3d_tpu_torch.parallel.sharding, "
            "slice3d_tpu_torch.train.zstd, slice3d_tpu_torch.train.ocdbt, "
            "slice3d_tpu_torch.train.flax_orbax; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'slice3d_tpu' or m.startswith('slice3d_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", ["package", "chip_smoke"])
def test_no_jax_or_reference_imports(where):
    if where == "package":
        files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
                 if f.endswith(".py")]
        rel = {os.path.relpath(f, PKG) for f in files}
        assert {"serve.py", "reconstruct.py", "config.py", os.path.join("data", "image.py"),
                os.path.join("data", "dataset.py"), os.path.join("ops", "fused_ffn.py"),
                os.path.join("models", "build.py"), os.path.join("models", "disn.py"),
                os.path.join("models", "camnet.py"), os.path.join("mesh", "refine.py"),
                os.path.join("eval", "metrics.py"), os.path.join("eval", "cli.py"),
                "main.py", "re_org_slices.py", "reconstruct_slices.py",
                "create_dataset_sin_img.py", os.path.join("train", "flax_msgpack.py"),
                os.path.join("utils", "yaml_config.py"), os.path.join("utils", "montage.py"),
                os.path.join("data", "ldm_data.py"), os.path.join("data", "pipeline.py"),
                os.path.join("data", "builders.py"), os.path.join("diffusion", "plms.py"),
                os.path.join("diffusion", "dpm.py"),
                os.path.join("diffusion", "ancestral.py"), os.path.join("train", "train_reg.py"),
                os.path.join("train", "train_cam.py"), os.path.join("train", "__main__.py"),
                "train_gt.py", "train_cam.py", os.path.join("models", "perceptual.py"),
                os.path.join("data", "device_transforms.py"),
                os.path.join("train", "train_vae.py"), os.path.join("models", "lpips.py"),
                os.path.join("models", "discriminator.py"), os.path.join("train", "zstd.py"),
                os.path.join("train", "ocdbt.py"), os.path.join("train", "flax_orbax.py")} <= rel
    else:
        files = [os.path.join(ROOT, "chip_smoke.py")]
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "slice3d_tpu"), (path, name)


def test_no_third_party_import_but_torch_and_numpy():
    """The card's machine has torch and numpy, and neither msgpack, PyYAML,
    Pillow, zstandard, tensorstore nor orbax: the port imports nothing else
    outside the standard library, save Pillow as ``data/image.py``'s fallback
    for images that are no PNG."""
    found = set()
    for d, _, fs in os.walk(PKG):
        for f in fs:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                found.update((name.split(".")[0], os.path.relpath(path, PKG))
                             for name in _imports(path))
    other = {(top, rel) for top, rel in found
             if top not in sys.stdlib_module_names and top not in ("__future__", "torch",
                                                                  "numpy")}
    assert not {top for top, _ in other} & {"zstandard", "tensorstore", "orbax"}, other
    assert other == {("PIL", os.path.join("data", "image.py"))}


def test_orbax_fixture_reads_with_jax_orbax_tensorstore_and_zstandard_blocked():
    """The committed JAX orbax fixture read in a process where ``jax``,
    ``orbax``, ``tensorstore`` and ``zstandard`` cannot be imported: every
    leaf's shape, dtype and SHA-256 as ``expected.json`` gives them."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'orbax', 'tensorstore', 'zstandard'):\n"
            "    sys.modules[name] = None\n"
            "import hashlib, json, os\n"
            "from slice3d_tpu_torch.train.flax_msgpack import read_flax_checkpoint\n"
            "d = os.path.join('slice3d_tpu_torch', 'train', 'testdata', 'jax_orbax')\n"
            "want = json.load(open(os.path.join(d, 'expected.json')))\n"
            "tree = read_flax_checkpoint(os.path.join(d, 'state'))\n"
            "def leaf(t, keys):\n"
            "    for k in keys:\n"
            "        t = t[k]\n"
            "    return t\n"
            "for name, w in want['leaves'].items():\n"
            "    a = leaf(tree, name.split('/'))\n"
            "    got = [list(a.shape), str(a.dtype), hashlib.sha256(a.tobytes()).hexdigest()]\n"
            "    assert got == [w['shape'], w['dtype'], w['sha256']], (name, got, w)\n"
            "print(len(want['leaves']))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 5


def test_weight_bridge_round_trip():
    """reference torch state_dict -> flax (torch_import) -> port is the identity,
    and the port's model has exactly the reference's keys and shapes."""
    ref = randomize_bn_stats(TorchSliceNetRef(12), seed=3)
    sd = ref.state_dict()
    back = slicenet_state_dict(torch_import.slicenet_model(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k].to(v.dtype), v), k
    port = init_slicenet(0).state_dict()
    assert {k: v.shape for k, v in port.items()} == {k: v.shape for k, v in sd.items()}
    init_slicenet(0).load_state_dict(back)  # strict


def test_resolve_device_defaults_to_cuda():
    assert slice3d_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert slice3d_tpu_torch.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            slice3d_tpu_torch.resolve_device()


def _flat(tree, prefix=()):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))


# tiny LatentDiffusion parts: VAE, UNet (its ds-1 attention at T 1024 when the
# atlas is 32 px), conditioner (the reference's five maps; the UNet injects
# the first two, at blocks 0 and 3)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attention_ds=(1, 2))
COND = dict(widths=(32, 64, 64, 128, 128), latent_size=8)


def _ldm_variables():
    vae = redraw(JaxVAE(**VAE).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                    None, False), 20)
    unet = redraw(JaxUNet(**UNET, n_heads=4, fmap_inject_blocks=(0, 3)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 8)), jnp.zeros((1,), jnp.int32),
        {"f1": jnp.zeros((1, 32, 32, 32)), "f2": jnp.zeros((1, 16, 16, 64))}), 21)
    cond = redraw(JaxCond(**COND).init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 3))),
                  22)
    return {"params": {"first_stage": vae["params"], "model": unet["params"],
                       "cond_stage": cond["params"]},
            "batch_stats": {"cond_stage": cond["batch_stats"]}}


@pytest.mark.parametrize("part", ["gtslice", "vae", "unet", "cond"])
def test_weight_bridge_round_trip_generation(part):
    """port state_dict -> the JAX package's torch importer is the identity on
    the variables, and the port's model takes the state_dict strictly."""
    if part == "gtslice":
        variables = redraw(init_variables(JaxGTSlice(), types.SimpleNamespace(
            img_size=32, n_slices=12), seed=0), 23)
        sd = convert.gtslice_state_dict(variables)
        _assert_same_tree(torch_import.gtslice_model(sd), variables)
        GTSliceModel().load_state_dict(sd)  # strict
        return
    variables = _ldm_variables()
    sd = convert.latent_diffusion_state_dict(variables, scale_factor=0.5)
    params, stats = variables["params"], variables["batch_stats"]
    if part == "vae":
        back = torch_import.autoencoder_kl(sd, prefix="first_stage_model", **VAE)
        _assert_same_tree(back, {"params": params["first_stage"]})
    elif part == "unet":
        back = torch_import.ldm_unet(sd, "model.diffusion_model", **UNET)
        _assert_same_tree(back, {"params": params["model"]})
    else:
        back = torch_import.cond_image_encoder(sd, "cond_stage_model")
        _assert_same_tree(back, {"params": params["cond_stage"],
                                 "batch_stats": stats["cond_stage"]})
    ldm = LatentDiffusion(vae_ch=32, vae_mult=(1, 2), vae_nres=1, unet_channels=32,
                          unet_mult=(1, 2), unet_nres=1, unet_attention_ds=(1, 2),
                          unet_inject_blocks=(0, 3), cond_widths=COND["widths"],
                          latent_size=8)
    ldm.load_state_dict(sd)  # strict
    assert float(ldm.scale_factor) == 0.5


@pytest.mark.parametrize("module,entry,library,args", [
    ("fused_encoder", "kernel", "s3d_fused_encoder", ()),
    ("fused_ffn", "kernel", "s3d_fused_ffn", ()),
    ("spatial_attention", "kernel", "s3d_spatial_attention", ()),
    ("spatial_attention", "kernel_bwd", "s3d_spatial_attention_bwd", ()),
    ("spatial_attention", "kernel", "s3d_spatial_attention_f32", (torch.float32,)),
    ("spatial_attention", "kernel_bwd", "s3d_spatial_attention_bwd_f32", (torch.float32,)),
    ("fused_encoder", "kernel", "s3d_fused_encoder_f32", (torch.float32,)),
    ("fused_ffn", "kernel", "s3d_fused_ffn_f32", (torch.float32,))],
    ids=["fused_encoder", "fused_ffn", "spatial_attention", "spatial_attention_bwd",
         "spatial_attention_f32", "spatial_attention_bwd_f32", "fused_encoder_f32",
         "fused_ffn_f32"])
def test_kernel_entry_point_is_bound_once(module, entry, library, args, monkeypatch):
    """A kernel wrapper resolves its library on the first launch only: later
    launches never reach ``native`` (no compiler search, no locks)."""
    import importlib

    from slice3d_tpu_torch import native

    ops = importlib.import_module(f"slice3d_tpu_torch.ops.{module}")
    builds = []

    def fake_build(name, sources, command, headers=()):
        builds.append(name)
        return types.SimpleNamespace(s3d_fused_encoder_layer=lambda *args: 0,
                                     s3d_fused_ffn=lambda *args: 0,
                                     s3d_spatial_attention=lambda *args: 0,
                                     s3d_spatial_attention_bwd=lambda *args: 0,
                                     s3d_spatial_attention_f32=lambda *args: 0,
                                     s3d_spatial_attention_bwd_f32=lambda *args: 0,
                                     s3d_fused_encoder_f32=lambda *args: 0,
                                     s3d_fused_ffn_f32=lambda *args: 0)

    monkeypatch.setattr(native, "build_library", fake_build)
    monkeypatch.setattr(native, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(ops, "_KERNEL", None)
    for name in ("_KERNEL_BWD", "_KERNEL_F32", "_KERNEL_BWD_F32"):
        monkeypatch.setattr(ops, name, None, raising=False)
    first = getattr(ops, entry)(*args)
    assert getattr(ops, entry)(*args) is first and builds == [library]
