"""The port's multi-process dry run (``python -m slice3d_tpu_torch.dryrun``,
the JAX package's ``__graft_entry__.py::dryrun_multichip``) in four gloo
processes on the CPU.

The four processes form the process mesh (2, 2) and run the five legs:
the sharded SliceNet and LDM steps, GTSlice reconstruction by batch and by
points, and sharded DDIM; rank 0 prints each leg's ``ok`` line and no
other rank does.  GTSlice's weights are JAX's seed-0 init of the dry run
(carried across by ``convert.gtslice_state_dict``), and the reconstruction
legs' vertex counts and ``n_points_evaluated`` must equal the JAX dry run's
reconstruction legs on the same inputs: its own code replayed here (the
same draws of ``numpy.random.default_rng(0)``, the same meshes of 4
devices), without its two training legs, whose CPU compiles take minutes.
"""

import ast
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from slice3d_tpu import camera as jax_camera
from slice3d_tpu.models.gtslice import GTSliceModel as JaxGTSlice
from slice3d_tpu.parallel import create_mesh as jax_create_mesh
from slice3d_tpu.pipeline import Reconstructor as JaxReconstructor
from slice3d_tpu_torch.convert import gtslice_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
LEGS = ("ok", "ldm ok", "recon ok", "recon-points ok", "ddim ok")
WORKER = """
import sys
sys.path.insert(0, {root!r})
sys.modules["torch.utils.tensorboard"] = None
import torch
torch.set_num_threads(1)
from slice3d_tpu_torch import dryrun
code = dryrun.main(["--device", "cpu"], gtslice_state=torch.load({weights!r}))
print("jax imported:", any(m == "jax" or m.startswith(("jax.", "slice3d_tpu."))
                           for m in sys.modules))
sys.exit(code)
"""


def _jax_recon_legs():
    """The JAX dry run's GTSlice weights and its two reconstruction legs'
    (vertices, n_points_evaluated), from its own draws (data axis 2 at 4
    devices: the regression and LDM batches come first)."""
    rng = np.random.default_rng(0)
    data_n = 2
    rng.normal(size=(data_n, 32, 32, 3))
    rng.normal(size=(data_n, 12, 32, 32, 3))
    rng.uniform(-0.5, 0.5, (data_n, 32, 3))
    rng.normal(size=(data_n, 32))
    rng.random((data_n, 32))
    rng.normal(size=(data_n, 13, 16, 16, 3))
    rng.normal(size=(data_n, 16, 16, 3))
    imesh = jax_create_mesh((N, 1), devices=jax.devices()[:N])
    gmodel = JaxGTSlice(n_slices=2)
    rot, proj = jax_camera.camera_matrices(0.2, 0.1, 1.2)
    gvars = gmodel.init(jax.random.PRNGKey(0),
                        jnp.asarray(rng.normal(size=(1, 2, 16, 16, 3)).astype(np.float32)),
                        jnp.zeros((1, 8, 3), jnp.float32),
                        jnp.asarray(proj[None].astype(np.float32)),
                        jnp.asarray(rot[None].astype(np.float32)))
    feeds = [{"img_slices": rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
              "trans_mat_wo_rot_tp": proj.astype(np.float32)} for _ in range(N)]
    gvars = jax.tree_util.tree_map(np.asarray, gvars)
    return gvars, feeds, imesh, gmodel


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    gvars, feeds, imesh, gmodel = _jax_recon_legs()
    torch.save(gtslice_state_dict(gvars), out / "gtslice.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = WORKER.format(root=ROOT, weights=str(out / "gtslice.pt"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code],
        env=dict(os.environ, SLICE3D_COORDINATOR=f"127.0.0.1:{port}",
                 SLICE3D_NUM_PROCESSES=str(N), SLICE3D_PROCESS_ID=str(r), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(N)]
    try:
        recon = JaxReconstructor(gmodel, gvars, resolution0=8, upsampling_steps=1,
                                 chunk_size=256, batch_size=N, mesh=imesh)
        jax_batch = [(len(m.vertices), int(st["n_points_evaluated"]))
                     for m, st in recon.reconstruct_batch(feeds)[:2]]
        recon_pts = JaxReconstructor(gmodel, gvars, resolution0=8, upsampling_steps=1,
                                     chunk_size=256, batch_size=1, mesh=imesh,
                                     shard_axis="points")
        m1, st1 = recon_pts.reconstruct(feeds[0])
        jax_points = (len(m1.vertices), int(st1["n_points_evaluated"]))
        texts = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], texts, {"recon ok": jax_batch,
                                                 "recon-points ok": jax_points}


def _legs(text):
    """{leg: the value its ``ok`` line printed}."""
    found = {}
    for line in text.splitlines():
        m = re.match(r"dryrun_multichip (.*?ok): (.*) \[[\d.]+s\]$", line)
        if m:
            assert m.group(1) not in found, line
            found[m.group(1)] = ast.literal_eval(m.group(2))
    return found


def test_every_rank_ends_without_jax(runs):
    codes, texts, _ = runs
    assert codes == [0] * N, texts[0][-3000:]
    for text in texts:
        assert "jax imported: False" in text


def test_rank_zero_prints_every_leg(runs):
    _, texts, _ = runs
    legs = _legs(texts[0])
    assert tuple(legs) == LEGS
    for name in ("ok", "ldm ok"):
        assert all(np.isfinite(v) for v in legs[name].values()), legs[name]
    assert legs["ddim ok"] == (N, 12, 16, 16, 3)
    for text in texts[1:]:
        assert _legs(text) == {}


@pytest.mark.parametrize("leg", ["recon ok", "recon-points ok"])
def test_reconstruction_legs_match_jax(runs, leg):
    _, texts, jax_legs = runs
    got = _legs(texts[0])[leg]
    print(f"{leg}: port {got}, JAX {jax_legs[leg]}")
    assert got == jax_legs[leg]
