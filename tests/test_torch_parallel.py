"""The port's ``parallel`` package against the JAX package's
(``slice3d_tpu/parallel/``) on the 8 virtual CPU devices of
``tests/conftest.py``, the collectives in a gloo group of one, and the
loader's rank shards."""

import datetime
import socket

import numpy as np
import pytest
import torch

import torch.distributed as dist

import slice3d_tpu_torch.parallel.mesh as port_mesh
from slice3d_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from slice3d_tpu.parallel import create_mesh as jax_create_mesh
from slice3d_tpu.parallel import reconstruction_mesh as jax_reconstruction_mesh
from slice3d_tpu_torch.data.pipeline import BatchLoader
from slice3d_tpu_torch.models.slicenet import SliceNetModel
from slice3d_tpu_torch.ops import prepared
from slice3d_tpu_torch.ops.fused_encoder import prepared_params
from slice3d_tpu_torch.ops.fused_ffn import prepared_weights
from slice3d_tpu_torch.models.layers import BatchNorm2d
from slice3d_tpu_torch.parallel import (all_reduce_gradients, all_reduce_mean, create_mesh,
                                        in_group, init_distributed, put_batch, rank_part,
                                        reconstruction_mesh, shard_batch)
from slice3d_tpu_torch.pipeline import Reconstructor

CPUS = ["cpu"] * 8


@pytest.mark.parametrize("shape", [None, (8, 1), (2, 4), (4, 2), (1, 8)])
def test_create_mesh_matches_jax(shape):
    mesh = create_mesh(shape, devices=CPUS)
    assert mesh.shape == dict(jax_create_mesh(shape).shape)
    assert mesh.devices.shape == (mesh.shape["data"], mesh.shape["model"])
    assert mesh.data_devices == [torch.device("cpu")] * mesh.shape["data"]


def test_create_mesh_error_matches_jax():
    with pytest.raises(ValueError) as jax_err:
        jax_create_mesh((3, 1))
    with pytest.raises(ValueError) as err:
        create_mesh((3, 1), devices=CPUS)
    assert str(err.value) == str(jax_err.value) == "mesh shape (3, 1) != 8 devices"


# every case of tests/test_parallel.py::test_reconstruction_mesh_policy
@pytest.mark.parametrize("args", [("points", 1, 32768, 1), ("points", 1, 32768, 8),
                                  ("points", 1, 32769, 8), ("batch", 8, 32768, 8),
                                  ("batch", 1, 32768, 8), ("batch", 6, 32768, 8)])
def test_reconstruction_mesh_policy_matches_jax(args, capsys):
    want = jax_reconstruction_mesh(*args)
    want_out = capsys.readouterr().out
    got = reconstruction_mesh(*args, devices=["cpu"] * args[3])
    assert capsys.readouterr().out == want_out
    assert (got is None) == (want is None)
    if want is not None:
        assert got.shape == dict(want.shape)
    if args[2] == 32769:
        assert "points ignored" in want_out


def test_put_batch_splits_what_divides_and_replicates_the_rest():
    mesh = create_mesh((2, 1), devices=["cpu", "cpu"])
    batch = {"x": np.arange(8.0).reshape(4, 2), "odd": np.arange(3.0), "scalar": np.float32(5)}
    parts = put_batch(batch, mesh)
    assert len(parts) == 2
    np.testing.assert_array_equal(parts[0]["x"].numpy(), batch["x"][:2])
    np.testing.assert_array_equal(parts[1]["x"].numpy(), batch["x"][2:])
    for p in parts:  # JAX's rule: a leaf whose batch axis does not divide is replicated
        np.testing.assert_array_equal(p["odd"].numpy(), batch["odd"])
        assert float(p["scalar"]) == 5.0


@pytest.mark.parametrize("rows,sizes", [(4, [2, 2]), (3, [2, 1]), (1, [1, 0])])
def test_shard_batch_gives_contiguous_parts(rows, sizes):
    """The Reconstructor's batch split: parts of ceil(rows / devices), the
    last shorter or empty where the axis does not divide."""
    x = torch.arange(rows * 2.0).reshape(rows, 2)
    parts = shard_batch(x, create_mesh((2, 1), devices=["cpu", "cpu"]))
    assert [len(p) for p in parts] == sizes
    torch.testing.assert_close(torch.cat(parts), x, rtol=0, atol=0)


def _bn_step():
    """One BatchNorm in training mode, forward and backward on a seeded
    input: (its output, the input's and the affine gradients averaged by
    ``all_reduce_gradients``, the logs' ``all_reduce_mean``, the running
    mean)."""
    torch.manual_seed(0)
    bn = BatchNorm2d(3)
    x = torch.randn(4, 3, 5, 5, requires_grad=True)
    y = bn(x)
    (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    all_reduce_gradients(bn.parameters())
    logs = all_reduce_mean({"mean": y.mean()})
    return y.detach(), x.grad, [p.grad for p in bn.parameters()], logs["mean"], \
        bn.running_mean.clone()


def test_a_group_of_one_runs_the_collectives_and_changes_nothing(monkeypatch):
    """Within a gloo group of one process every collective runs (the
    gradients', the logs' and BatchNorm's statistics under autograd) and
    gives, bit for bit, what the same step gives without a group."""
    want = _bn_step()
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: calls.append(1) or real(*a, **k))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=30))
    try:
        assert in_group()
        got = _bn_step()
    finally:
        dist.destroy_process_group()
    assert not in_group()
    assert len(calls) == 4  # BatchNorm forward and backward, the gradients, the logs
    for g, w in zip(got, want):
        for a, b in zip(g if isinstance(g, list) else [g], w if isinstance(w, list) else [w]):
            assert torch.equal(a, b)


def test_init_distributed_without_the_variables_is_a_no_op(monkeypatch):
    for k in ("SLICE3D_COORDINATOR", "SLICE3D_NUM_PROCESSES", "SLICE3D_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(port_mesh.dist, "init_process_group",
                        lambda *a, **k: pytest.fail("joined a group"))
    assert init_distributed(device="cpu") == 1
    assert init_distributed("127.0.0.1:1234", 1, 0, device="cpu") == 1
    assert rank_part(torch.arange(4), 4).tolist() == [0, 1, 2, 3]


def test_init_distributed_reads_the_variables(monkeypatch):
    monkeypatch.setenv("SLICE3D_COORDINATOR", "10.0.0.1:4321")
    monkeypatch.setenv("SLICE3D_NUM_PROCESSES", "4")
    monkeypatch.setenv("SLICE3D_PROCESS_ID", "3")
    calls = []
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(port_mesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    assert init_distributed(device="cpu") == 4
    (backend, kw), = calls
    assert backend == "gloo"
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("tcp://10.0.0.1:4321", 4, 3)
    # the card's group is NCCL's; without a card it refuses, as every entry point
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_distributed()


class _Indices:
    def __len__(self):
        return 23

    def __getitem__(self, i):
        return {"i": np.int64(i)}


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_rank_shards_make_the_global_batch(shuffle):
    whole = [b["i"].tolist() for b in BatchLoader(_Indices(), 6, shuffle=shuffle,
                                                  num_workers=1)]
    shards = [[b["i"].tolist() for b in BatchLoader(_Indices(), 3, shuffle=shuffle,
                                                    num_workers=1, num_shards=2, shard=r)]
              for r in range(2)]
    assert len(whole) == 3 and all(len(s) == 3 for s in shards)
    assert len(BatchLoader(_Indices(), 3, num_shards=2, shard=1)) == 3
    for k, batch in enumerate(whole):
        assert not set(shards[0][k]) & set(shards[1][k])  # disjoint
        assert shards[0][k] + shards[1][k] == batch


def test_jax_loader_gives_every_process_the_same_batches():
    """The JAX fault the port does not copy (ROADMAP Queue 3): each process
    of a JAX multi-host run builds the same loader (``seed=0``, the whole
    split), so every process feeds the same samples, where ``put_batch``
    expects each to pass its own shard."""
    procs = [[b["i"].tolist() for b in JaxBatchLoader(_Indices(), 3, num_workers=1)]
             for _ in range(2)]
    assert procs[0] == procs[1]
    port = [[b["i"].tolist() for b in BatchLoader(_Indices(), 3, num_workers=1,
                                                  num_shards=2, shard=r)] for r in range(2)]
    assert port[0] != port[1]


@pytest.mark.parametrize("devices,replicas", [(["cpu", "cpu"], 1), (["cpu", "meta"], 2)])
def test_a_served_mesh_prepares_each_replica_once(devices, replicas):
    """The head kernels' weight sets (``ops/prepared.py``, 64 kept) under a
    mesh: one replica a distinct device, each of its layers prepared once
    (its fused_encoder_layer and its fused_ffn set), none again on later
    calls."""
    rec = Reconstructor(SliceNetModel(12), device="cpu", shard_axis="points",
                        mesh=create_mesh((2, 1), devices=devices))
    models = list({id(m): m for m, _ in rec._replicas}.values())
    layers = [layer for m in models for layer in m.att_decoder.layers]
    assert len(models) == replicas and len(layers) == 3 * replicas
    before = prepared.prepares
    for call in range(3):
        for layer in layers:
            params = dict(layer.named_parameters())
            prepared_params(params)
            prepared_weights(params["linear1.weight"], params["linear1.bias"],
                             params["linear2.weight"], params["linear2.bias"])
        assert prepared.prepares - before == 2 * len(layers), call
