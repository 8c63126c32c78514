"""The port's placement rule (``parallel.fsdp_placements`` /
``shard_params_fsdp``) against the JAX package's ``shard_params_fsdp``, in
one process with no group.

For SliceNet, GTSlice and the dry run's tiny LDM, at a model axis of 2 and
4 (JAX's meshes (4, 2) and (2, 4) on the 8 virtual CPU devices of
``tests/conftest.py``) and ``min_size`` 2^10 and 2^12:

* every parameter goes through the converter (``slice3d_tpu_torch.convert``)
  as a tensor of its JAX shard ids (the index along JAX's sharded axis
  divided by the shard's length; -1 where JAX replicates), and must come out
  as the port's placement's shard ids: the port's sharded axis is JAX's
  through the converter's transposition, and it replicates where JAX does;
* the converter maps every JAX parameter to one port parameter and back
  (each leaf's id lands in exactly one tensor, alone), with the same
  element count, and the leaves whose layout it reshapes are exactly the
  ones named in ``RESHAPED``, with the port's rule for each;
* the per-rank element count of the parameters and Adam's moments equals
  the sum of JAX's ``addressable_shards`` of its state's parameters and
  moments (``mu`` / ``nu``; the step counts are no moments) on one device,
  after the dry run's ``shard_params_fsdp`` of both.

JAX's trainer states are shaped with ``jax.eval_shape`` and filled with
zeros: the rule reads shapes only.
"""

import numpy as np
import pytest

import jax
import torch
from torch.distributed.tensor import Replicate, Shard

from slice3d_tpu.config import Options as JaxOptions
from slice3d_tpu.diffusion.latent import LatentDiffusion as JaxLatentDiffusion
from slice3d_tpu.parallel import create_mesh as jax_create_mesh
from slice3d_tpu.parallel import shard_params_fsdp as jax_shard_params_fsdp
from slice3d_tpu.train.train_ldm import LDMTrainer as JaxLDMTrainer
from slice3d_tpu.train.train_reg import RegressionTrainer as JaxRegTrainer
from slice3d_tpu_torch import convert
from slice3d_tpu_torch.diffusion.latent import LatentDiffusion
from slice3d_tpu_torch.dryrun import LDM_TINY
from slice3d_tpu_torch.models.gtslice import init_gtslice
from slice3d_tpu_torch.models.slicenet import init_slicenet
from slice3d_tpu_torch.parallel import flax_axes, fsdp_placements, fsdp_spec
from slice3d_tpu_torch.train.train_ldm import TRAINABLE_PREFIXES

MODELS = ("slicenet", "gtslice", "ldm")
MODEL_AXES = {2: (4, 2), 4: (2, 4)}  # model axis -> JAX's (data, model) mesh
MIN_SIZES = (2 ** 10, 2 ** 12)
# the parameters whose layout the converter reshapes, and the port's rule
# for them (none is fused or split: each JAX leaf is one port tensor)
RESHAPED = {
    "qkv.weight": "a Dense (in, 3 in) as a 1x1 Conv1d (3 in, in, 1): the axis of "
                  "flax's choice, out -> 0 or in -> 1; the unit axis 2 never",
    "proj_out.weight": "a Dense (in, in) as a 1x1 Conv1d (in, in, 1): as qkv.weight",
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zeros(tree):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """(name, the JAX state's shapes, the port module, the converter of a
    JAX variables tree, the port's names under Adam)."""
    name = request.param
    if name == "ldm":
        trainer = JaxLDMTrainer(img_size=16, batch_size=2, timesteps=20,
                                module=JaxLatentDiffusion(**LDM_TINY), scale_by_std=False)
        port = LatentDiffusion(**LDM_TINY)
        to_sd = convert.latent_diffusion_state_dict
        optimized = lambda n: n.startswith(TRAINABLE_PREFIXES)  # noqa: E731
    else:
        trainer = JaxRegTrainer(JaxOptions(name_model=name, img_size=32, n_qry=32, n_bs=2,
                                           dtype="float32"), steps_per_epoch=10)
        port = (init_slicenet if name == "slicenet" else init_gtslice)(0, route="plain")
        to_sd = convert.slicenet_state_dict if name == "slicenet" else convert.gtslice_state_dict
        optimized = lambda n: True  # noqa: E731
    shapes = jax.eval_shape(trainer.init_state)
    return name, shapes, port, to_sd, optimized


def _convert(shapes, to_sd, fill):
    """The port's tensors of the JAX params tree whose leaf at each path is
    ``fill(path, shape)`` (the statistics zero)."""
    params = jax.tree_util.tree_map_with_path(lambda p, s: fill(p, s.shape), shapes.params)
    return to_sd({"params": params, "batch_stats": _zeros(shapes.batch_stats)})


def _port_ids(t, placement, n):
    if not isinstance(placement, Shard):
        return torch.full(t.shape, -1.0)
    d, size = placement.dim, t.shape[placement.dim]
    view = [1] * t.dim()
    view[d] = size
    return (torch.arange(size) // (size // n)).to(torch.float32).reshape(view).expand(t.shape)


def test_each_jax_leaf_is_one_port_tensor(model):
    name, shapes, port, to_sd, _ = model
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(shapes.params)[0]]
    ids = {jax.tree_util.keystr(p): i + 1 for i, p in enumerate(paths)}
    sizes = {jax.tree_util.keystr(p): int(np.prod(s.shape)) for p, s in
             jax.tree_util.tree_flatten_with_path(shapes.params)[0]}
    sd = _convert(shapes, to_sd,
                  lambda p, shape: np.full(shape, ids[jax.tree_util.keystr(p)], np.float32))
    params = dict(port.named_parameters())
    assert set(params) <= set(sd)
    seen, reshaped = {}, set()
    for pname, p in params.items():
        leaf = torch.unique(sd[pname])
        assert leaf.numel() == 1, f"{pname} fuses leaves {leaf.tolist()}"
        leaf = int(leaf)
        assert leaf not in seen, f"leaf {leaf} split into {seen[leaf]} and {pname}"
        seen[leaf] = pname
        assert sd[pname].shape == p.shape, pname
        path = next(k for k, v in ids.items() if v == leaf)
        assert p.numel() == sizes[path], pname
        jax_ndim = len(next(s.shape for q, s in jax.tree_util.tree_flatten_with_path(
            shapes.params)[0] if jax.tree_util.keystr(q) == path))
        if jax_ndim != p.dim():
            reshaped.add(pname)
    assert sorted(seen) == sorted(ids.values()), "a JAX parameter has no port tensor"
    named = {n for n in reshaped if any(n.endswith(k) for k in RESHAPED)}
    assert named == reshaped
    assert bool(reshaped) == (name == "ldm")


@pytest.mark.parametrize("min_size", MIN_SIZES)
@pytest.mark.parametrize("n_model", sorted(MODEL_AXES))
def test_placements_are_jax_specs(model, n_model, min_size):
    name, shapes, port, to_sd, optimized = model
    jmesh = jax_create_mesh(MODEL_AXES[n_model])
    sharded, specs = jax_shard_params_fsdp(_zeros(shapes.params), jmesh, min_size=min_size)

    def jax_ids(path, shape):
        spec = next(s for q, s in jax.tree_util.tree_flatten_with_path(specs)[0]
                    if q == path).spec
        if "model" not in spec:
            return np.full(shape, -1.0, np.float32)
        k = list(spec).index("model")
        view = [1] * len(shape)
        view[k] = shape[k]
        idx = np.arange(shape[k]) // (shape[k] // n_model)
        return np.broadcast_to(idx.reshape(view), shape).astype(np.float32)

    want = _convert(shapes, to_sd, jax_ids)
    placements = fsdp_placements(port, n_model, min_size)
    params = dict(port.named_parameters())
    assert set(placements) == set(params)
    n_sharded = 0
    for pname, p in params.items():
        got = _port_ids(p, placements[pname], n_model)
        assert torch.equal(got, want[pname]), (pname, placements[pname])
        n_sharded += isinstance(placements[pname], Shard)
    assert n_sharded > 0

    # per-rank elements: the parameters and Adam's moments
    local = {n: p.numel() // (n_model if isinstance(placements[n], Shard) else 1)
             for n, p in params.items()}
    port_count = sum(local.values()) + 2 * sum(v for n, v in local.items() if optimized(n))
    opt, _ = jax_shard_params_fsdp(_zeros(shapes.opt_state), jmesh, min_size=min_size)
    moments = [x for p, x in jax.tree_util.tree_flatten_with_path(opt)[0]
               if any(getattr(k, "name", None) in ("mu", "nu") for k in p)]
    jax_count = sum(x.addressable_shards[0].data.size
                    for x in jax.tree_util.tree_leaves(sharded) + moments)
    assert port_count == jax_count


def test_rule_on_shapes():
    """The rule's three parts on bare shapes (tests/test_parallel.py's cases)
    and the flax axis orders."""
    assert fsdp_spec((128, 512), 4, 1024) == Shard(1)
    assert fsdp_spec((4,), 4, 1024) == Replicate()
    assert fsdp_spec((333, 7), 4, 1024) == Replicate()
    assert fsdp_spec((128, 512), 1, 1024) == Replicate()
    assert fsdp_spec((512, 128), 4, 1024, axes=(1, 0)) == Shard(0)
    lin, conv = torch.nn.Linear(3, 5), torch.nn.Conv2d(3, 5, 3)
    assert flax_axes(lin, "weight", lin.weight) == (1, 0)
    assert flax_axes(conv, "weight", conv.weight) == (2, 3, 1, 0)
    with pytest.raises(ValueError):
        flax_axes(torch.nn.Bilinear(2, 2, 2), "weight", torch.zeros(2, 2, 2))
