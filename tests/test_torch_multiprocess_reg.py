"""Data-parallel regression training in two gloo processes (``parallel``,
``train/train_reg.py``, ``train/train_cam.py``, the training CLI).

Each process takes its half of a global batch of 4 (``tests/torch_dp_cases
.py``) for 2 steps; the group's steps must be the one-process steps on the
global batches (``torch_dp_cases.compare``): the logs of the first
step at rtol 2e-5 / atol 2e-6 (``tests/test_parallel.py:108-110``) and of
the second, which depends on the first update, at rtol 1e-3; the first
step's gradients, its update (after - before, where the gradient is
settled) and the BatchNorm running statistics after it (at 1e-6); and both
processes' parameters equal.  SliceNet's steps are also held to the JAX
trainer's ``_train_step`` on the global batches, from the same weights, at
the same log tolerances.  The CLI's checkpoints are written by rank 0
alone.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_dp_cases as cases
from jax_weights import redraw
from slice3d_tpu.config import Options as JaxOptions
from slice3d_tpu.train.train_reg import RegressionTrainer as JaxTrainer
from slice3d_tpu_torch import convert
from slice3d_tpu_torch.data.builders import create_synthetic_dataset


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_slicenet():
    """The JAX trainer's state with redrawn weights and statistics, and its
    steps' logs on the global batches."""
    o = cases.reg_opts("slicenet")
    trainer = JaxTrainer(JaxOptions(name_model="slicenet", img_size=o.img_size, n_qry=o.n_qry,
                                    n_bs=o.n_bs, lr=o.lr, freq_decay=1, weight_decay=0.5),
                         steps_per_epoch=4)
    state = trainer.init_state()
    variables = redraw({"params": state.params, "batch_stats": state.batch_stats}, 60)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = state.replace(params=params, opt_state=trainer.tx.init(params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]))
    logs = []
    for i in range(cases.STEPS):
        state, step_logs = trainer._train_step(state, cases.reg_batch(70 + i))
        logs.append({k: float(v) for k, v in step_logs.items()})
    return convert.slicenet_state_dict(variables), logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_slicenet):
    out = tmp_path_factory.mktemp("dp_reg")
    torch.save(jax_slicenet[0], out / "slicenet_init.pt")
    create_synthetic_dataset(str(out / "data" / "synth"), n_shapes=4, n_views=6, img_size=32,
                             n_sdf=256)
    jobs = {"slicenet": ("run_reg", ("slicenet", str(out / "slicenet_init.pt"))),
            "gtslice": ("run_reg", ("gtslice",)), "cam": ("run_cam", ()),
            "cli": ("run_reg_cli", (str(out / "data"), str(out / "exp"),
                                    str(out / "writes.txt")))}
    return cases.run_workers(jobs, out), out


def test_workers_import_no_jax(runs):
    assert [r["jax_imported"] for r in runs[0]] == [False] * cases.PROCS


def test_slicenet_step_matches_jax_on_the_global_batch(runs, jax_slicenet):
    for r in runs[0]:
        for i, (got, want) in enumerate(zip(r["slicenet"]["logs"], jax_slicenet[1],
                                            strict=True)):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(
                    got[k], want[k], **(cases.LOG_TOL if i == 0 else cases.LATER_LOG_TOL),
                    err_msg=f"step {i} {k}")


@pytest.mark.parametrize("name", ["slicenet", "gtslice", "cam"])
def test_two_processes_equal_one(runs, name):
    cases.assert_like_one(runs[0], name)


def test_cli_writes_on_rank_zero_only(runs):
    ranks, out = runs
    writes = (out / "writes.txt").read_text().split()
    assert writes[0::2] == ["0"]  # one epoch, one checkpoint, from rank 0
    assert (out / "exp" / "dp" / "ckpt" / writes[1]).exists()
    assert (out / "exp" / "dp" / "opts.txt").exists()
    assert ranks[0]["cli"]["digests"] == ranks[1]["cli"]["digests"]
