"""Parameters sharded over the ``model`` axis in four gloo processes
(``parallel.shard_params_fsdp``, ``parallel.init_process_mesh``, the sharded
``RegressionTrainer`` and ``LDMTrainer``, the sharded checkpoints).

Two runs of four processes, at the process meshes (2, 2) and (1, 4), each
sharding every parameter of at least 2^10 elements (the floor of
``tests/test_parallel.py``'s sharded step).  In each, SliceNet (the
queries split over ``model``) and the tiny LDM take 2 steps on global
batches of 4 and 2 from JAX-drawn weights, and must be the port's
one-process steps on the global batches (``torch_dp_cases.compare``: the
first step's logs at rtol 2e-5, the second's at 1e-3, the first step's
gradients, update and BatchNorm statistics) and the JAX trainers' own steps
on them (the logs at the same tolerances; the LDM replays JAX's draws).  The
processes of one model group take the same batch rows, loader rows and
draws.  Unsharded checkpoints of both trainers load into the sharded states,
rank 0 alone writes the gathered payloads without a hang, and the files hold
the loaded tensors bit for bit; the steps from the loaded state are the
one-process ones.  ``main -t`` on the tiny LDM, sharded at (1, 4), ends on
every process in one state, rank 0 alone writing the files of the
one-process run.  Each process saves the sharded SliceNet and LDM states
as checkpoint directories (``--ckpt_backend orbax``, then ``orbax_async``
and ``wait_pending``) with no gather of a shard, writing no more than the
tensors it holds (each tensor of the state once over the group), and each
directory restores bit for bit into a fresh sharded state and, in the test
process, into an unsharded one.  With the model group's gradient
reduction swapped for what DTensor's default ``full_tensor()`` backward
gives (each process keeps its own slice of its own gradient) the same
SliceNet case must fail ``compare``.
"""

import glob
import os
import re
import shutil

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

import torch_dp_cases as cases
from jax_weights import redraw
from slice3d_tpu.config import Options as JaxOptions
from slice3d_tpu.diffusion.latent import LatentDiffusion as JaxLatentDiffusion
from slice3d_tpu.train.train_ldm import LDMTrainer as JaxLDMTrainer
from slice3d_tpu.train.train_reg import RegressionTrainer as JaxRegTrainer
from slice3d_tpu_torch import convert
from slice3d_tpu_torch import main as port_main
from slice3d_tpu_torch.data.builders import create_synthetic_dataset
from slice3d_tpu_torch.train.checkpoint import restore_checkpoint
from slice3d_tpu_torch.train.train_reg import RegressionTrainer

BACKENDS = ("orbax", "orbax_async")
ITEM_BYTES = 2048  # what DCP adds to a tensor in a .distcp file (its torch.save header)

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
H = cases.LDM_IMG // 2  # the latent tile


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax_slicenet():
    """The JAX regression trainer and its state with redrawn weights and
    statistics (tests/test_torch_multiprocess_reg.py's)."""
    o = cases.reg_opts("slicenet")
    trainer = JaxRegTrainer(JaxOptions(name_model="slicenet", img_size=o.img_size,
                                       n_qry=o.n_qry, n_bs=o.n_bs, lr=o.lr, freq_decay=1,
                                       weight_decay=0.5), steps_per_epoch=4)
    state = trainer.init_state()
    variables = redraw({"params": state.params, "batch_stats": state.batch_stats}, 60)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = state.replace(params=params, opt_state=trainer.tx.init(params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]))
    return trainer, state, convert.slicenet_state_dict(variables)


def _jax_ldm():
    """The JAX LDM trainer (the tiny configuration, a fixed LR, logvar
    learned as the port's is) and its state with redrawn weights."""
    trainer = JaxLDMTrainer(img_size=cases.LDM_IMG, batch_size=cases.LDM_GLOBAL,
                            timesteps=cases.LDM_T, base_lr=1e-4, scale_lr=False,
                            learn_logvar=True, module=JaxLatentDiffusion(**cases.LDM_TINY))
    state = trainer.init_state(seed=0)
    variables = redraw({"params": state.params, "batch_stats": state.batch_stats}, 45)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = state.replace(
        params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        ema_params={k: jax.tree_util.tree_map(jnp.array, v) for k, v in params.items()
                    if k != "first_stage"})
    state = state.replace(opt_state=trainer.tx.init({"net": state.params,
                                                     "logvar": state.logvar}))
    payload = convert.ldm_train_payload(_np(state.params), _np(state.batch_stats),
                                        _np(state.ema_params), np.array(state.logvar),
                                        float(state.scale_factor))
    return trainer, state, payload


def _ldm_draws(key):
    """The JAX step's draws from its key (train_ldm.py _step_impl, latent.py
    p_losses, vae.py DiagonalGaussian.sample), as tests/test_torch_train_ldm.py
    replays them."""
    n = cases.LDM_GLOBAL
    key_enc, key_loss = jax.random.split(key)
    key_t, key_n = jax.random.split(key_loss)
    post = jax.random.normal(key_enc, (n * 13, H, H, 4), jnp.float32)
    return {"posterior_noise": np.array(post).reshape(n, 13, H, H, 4),
            "t": np.array(jax.random.randint(key_t, (n,), 0, cases.LDM_T)).astype(np.int64),
            "noise": np.array(jax.random.normal(key_n, (n, 4 * H, 4 * H, 4), jnp.float32))}


def _unsharded_checkpoints(out):
    """One-process states after one step each, written by the trainers'
    payloads: SliceNet at ``reg.ckpt`` and the tiny LDM at ``ldm.ckpt``."""
    reg = RegressionTrainer(cases.reg_opts("slicenet"), steps_per_epoch=4, device="cpu")
    state = reg.init_state(seed=9)
    reg.train_step(state, cases.reg_batch(74))
    reg.save(state, str(out), 0, {}, reg.state_payload(state, 0))
    next(out.glob("0_1_*.ckpt")).rename(out / "reg.ckpt")
    ldm = cases.ldm_fsdp_trainer(base_lr=1e-4)
    lstate = ldm.init_state()
    batch, draws = cases.ldm_inputs(95)
    ldm.train_step(lstate, batch, draws=draws)
    ldm.save(lstate, str(out / "ldm.ckpt"))


def _main_cfg(out):
    """The tiny LDM config (tests/test_torch_main_train.py's, batch 1) over a
    synthetic dataset of 2 objects, 6 views, 16 px."""
    root = create_synthetic_dataset(str(out / "ds"), n_shapes=2, n_views=6, img_size=16,
                                    n_sdf=64)
    split = lambda: {"params": {"size": 16, "root": root, "n_views": 6}}  # noqa: E731
    cfg = {"model": {"base_learning_rate": 5e-5,
                     "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
                     "params": {"timesteps": 20,
                                "unet_config": {"params": {"model_channels": 32,
                                                           "channel_mult": [1, 2],
                                                           "num_res_blocks": 1,
                                                           "attention_resolutions": [1, 2]}},
                                "first_stage_config": {"params": {"ddconfig": {
                                    "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1}}}}},
           "data": {"params": {"batch_size": 1, "train": split(), "validation": split()}}}
    with open(out / "ldm.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return str(out / "ldm.yaml")


class _NoScalars:
    def add_scalar(self, *_):
        pass

    def close(self):
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs of four processes, side by side, and the JAX steps' logs,
    computed while they work."""
    out = tmp_path_factory.mktemp("fsdp")
    jreg, jreg_state, sn_init = _jax_slicenet()
    torch.save(sn_init, out / "slicenet_init.pt")
    jldm, jldm_state, payload = _jax_ldm()
    torch.save(payload, out / "ldm_init.pt")
    keys = [jax.random.PRNGKey(46 + i) for i in range(cases.STEPS)]
    inputs = {}
    for i, key in enumerate(keys):
        rng = np.random.default_rng(47 + i)
        views = rng.uniform(-1, 1, (cases.LDM_GLOBAL, 13, cases.LDM_IMG, cases.LDM_IMG, 3))
        inputs.update({f"batch{i}_image": views.astype(np.float32),
                       f"batch{i}_img_ipt_view": views[:, 12].astype(np.float32)})
        inputs.update({f"draws{i}_{k}": v for k, v in _ldm_draws(key).items()})
    np.savez(out / "ldm_inputs.npz", **inputs)
    _unsharded_checkpoints(out)
    cfg_path = _main_cfg(out)

    started = {}
    for tag, mesh in MESHES.items():
        where = out / tag
        where.mkdir()
        jobs = {"slicenet": ("run_reg_fsdp", (str(out / "slicenet_init.pt"),)),
                "ldm": ("run_ldm_fsdp", (str(out / "ldm_init.pt"), str(out / "ldm_inputs.npz"))),
                "ckpt": ("run_ckpt_fsdp", (str(out / "reg.ckpt"), str(out / "ldm.ckpt"),
                                           str(where))),
                "dirckpt": ("run_dir_ckpt_fsdp", (str(out / "reg.ckpt"), str(out / "ldm.ckpt"),
                                                  str(where)))}
        if tag == "2x2":
            jobs["default_backward"] = ("run_reg_fsdp", (str(out / "slicenet_init.pt"), True))
        else:
            jobs["main"] = ("run_main_ldm_fsdp", (cfg_path, str(where / "logs")))
        started[tag] = cases.start_workers(jobs, where, procs=4, mesh=mesh, timeout_s=120)

    jax_logs = {"slicenet": [], "ldm": []}
    for i in range(cases.STEPS):
        jreg_state, logs = jreg._train_step(jreg_state, cases.reg_batch(70 + i))
        jax_logs["slicenet"].append({k: float(v) for k, v in logs.items()})
    for i, key in enumerate(keys):
        batch = {k: inputs[f"batch{i}_{k}"] for k in ("image", "img_ipt_view")}
        jldm_state, logs = jldm.train_step(jldm_state, batch, key)
        jax_logs["ldm"].append({k: float(v) for k, v in logs.items()})
    with pytest.MonkeyPatch.context() as mp:  # no TensorBoard in this process either
        mp.setattr(port_main, "scalar_writer", lambda log_dir: _NoScalars())
        one = port_main.main(cases.main_ldm_argv(cfg_path, str(out / "one")))
    runs = {tag: cases.finish_workers(handle, timeout=600) for tag, handle in started.items()}
    return runs, jax_logs, out, one, _directory_checks(out)


def _directory_checks(out):
    """Of each checkpoint directory the runs wrote: its files, each rank's
    ``.distcp`` size, and where its restore into an unsharded one-process
    state differs from the gathered ``{name}_4.ckpt`` of the same state (by
    ``_equal``'s message; None where equal).  The directories are removed
    after: ~250 MB each."""
    checks = {}
    for tag in MESHES:
        for name in ("reg", "ldm"):
            want = torch.load(out / tag / f"{name}_4.ckpt", weights_only=True)
            for backend in BACKENDS:
                path = out / tag / f"{name}_{backend}.ckpt"
                files = sorted(os.listdir(path))
                sizes = [os.path.getsize(path / f"__{r}_0.distcp") for r in range(4)]
                if name == "reg":
                    trainer = RegressionTrainer(cases.reg_opts("slicenet"), steps_per_epoch=4,
                                                device="cpu")
                    state, epoch = trainer.restore(trainer.init_state(seed=9), str(path))
                    got = trainer.state_payload(state, epoch - 1)
                else:
                    trainer = cases.ldm_fsdp_trainer(base_lr=1e-4)
                    got = trainer.state_payload(trainer.restore(trainer.init_state(), str(path)))
                try:
                    _equal(got, want)
                    differs = None
                except AssertionError as err:
                    differs = repr(err) or "differs"
                checks[tag, name, backend] = {"files": files, "sizes": sizes, "differs": differs}
                del got, trainer
                shutil.rmtree(path)
    return checks


@pytest.mark.parametrize("tag", MESHES)
def test_workers_import_no_jax(runs, tag):
    assert [r["jax_imported"] for r in runs[0][tag]] == [False] * 4


@pytest.mark.parametrize("name", ["slicenet", "ldm", "ckpt"])
@pytest.mark.parametrize("tag", MESHES)
def test_sharded_equals_one_process(runs, tag, name):
    ranks = runs[0][tag]
    cases.assert_like_one(ranks, name)
    assert ranks[0][name]["n_sharded"] > 0


@pytest.mark.parametrize("name", ["slicenet", "ldm"])
@pytest.mark.parametrize("tag", MESHES)
def test_sharded_step_matches_jax(runs, tag, name):
    for r in runs[0][tag]:
        for i, (got, want) in enumerate(zip(r[name]["logs"], runs[1][name], strict=True)):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(
                    got[k], want[k], **(cases.LOG_TOL if i == 0 else cases.LATER_LOG_TOL),
                    err_msg=f"step {i} {k}")


@pytest.mark.parametrize("tag", MESHES)
def test_model_group_takes_one_batch_and_draws(runs, tag):
    ranks = [r["ldm"] for r in runs[0][tag]]
    data, model = MESHES[tag]
    assert sorted(r["where"] for r in ranks) == [(d, m) for d in range(data)
                                                 for m in range(model)]
    for r in ranks:
        for q in ranks:
            same_rows = r["where"][0] == q["where"][0]
            assert (r["taken"] == q["taken"]) == same_rows, (r["where"], q["where"])
    # the LR scales with the batch shards: data x (global / data) x base = global x base
    assert {r["scaled_lr"] for r in ranks} == {cases.LDM_GLOBAL * 1e-4}


def _equal(a, b, where=""):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("name", ["reg", "ldm"])
@pytest.mark.parametrize("tag", MESHES)
def test_sharded_checkpoint_is_the_unsharded_one(runs, tag, name):
    """Rank 0's write of the gathered payload (no hang: the run ended) holds
    the unsharded file's tensors, which the sharded state loaded."""
    out = runs[2]
    got = torch.load(out / tag / f"{name}_4.ckpt", weights_only=True)
    want = torch.load(out / f"{name}.ckpt", weights_only=True)
    _equal(got, want)


def test_default_full_tensor_backward_fails(runs):
    r0 = runs[0]["2x2"][0]["default_backward"]
    print(f"default backward: {r0['readings']}")
    assert any(f.startswith("gradient ") for f in r0["failures"]), r0["failures"]


def _files(logdir):
    """The files under ``logdir`` by relative name, the top-k file's
    monitored value taken out of its name."""
    return {re.sub(r"=[\d.]+\.ckpt$", ".ckpt", os.path.relpath(p, logdir)): p
            for p in glob.glob(os.path.join(logdir, "**", "*"), recursive=True)
            if os.path.isfile(p) and "tensorboard" not in p}


def test_sharded_main_writes_on_rank_zero(runs):
    """``main -t`` with the LDM sharded over (1, 4): every process ran it to
    its end (gathering each checkpoint, sampling each image log) with one
    batch a step (the model group's first process loads it: the dataset's
    random view is its own), ending in one state, and rank 0 alone wrote
    the one-process run's files, ``last.ckpt`` holding that state."""
    ranks = [r["main"] for r in runs[0]["1x4"]]
    assert [r["sharded"] for r in ranks] == [[True]] * 4
    logdir = ranks[0]["logdir"]
    assert {r["logdir"] for r in ranks} == {logdir}
    assert all(r["digests"] == ranks[0]["digests"] for r in ranks)
    files = _files(logdir)
    assert sorted(files) == sorted(_files(runs[3]))
    last = restore_checkpoint(files["checkpoints/last.ckpt"])
    assert last["step"] == 2
    assert cases._digest({"state": last["model"]}) == ranks[0]["digests"]["last"]


@pytest.mark.parametrize("tag", MESHES)
def test_directory_checkpoint_gathers_nothing(runs, tag):
    """Every process saved both sharded states as directories with no gather
    of a shard (``DTensor.full_tensor`` counted over each save and its
    ``wait_pending``), and read each back into a fresh sharded state bit for
    bit."""
    for r in runs[0][tag]:
        job = r["dirckpt"]
        assert job["gathers"] == {f"{n}_{b}": 0 for n in ("reg", "ldm") for b in BACKENDS}
        assert not job["dir_failures"], job["dir_failures"]
        assert job["n_sharded"] > 0


@pytest.mark.parametrize("name", ["reg", "ldm"])
@pytest.mark.parametrize("tag", MESHES)
def test_directory_checkpoint_holds_each_rank_shards(runs, tag, name):
    """Rank r's ``__r_0.distcp`` holds no more than the tensors rank r holds
    (its shards, and the replicated tensors DCP gives it), and the files
    together hold each tensor of the state once."""
    ranks = [r["dirckpt"]["local"][name] for r in runs[0][tag]]
    whole, count = ranks[0][1], ranks[0][2]
    for backend in BACKENDS:
        check = runs[4][tag, name, backend]
        sizes = check["sizes"]
        assert check["files"] == [".metadata"] + [f"__{r}_0.distcp" for r in range(4)]
        for size, (local, _, n) in zip(sizes, ranks):
            assert size <= local + ITEM_BYTES * n, (backend, sizes, ranks)
        assert whole <= sum(sizes) <= whole + ITEM_BYTES * 4 * count, (backend, sizes, whole)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["reg", "ldm"])
@pytest.mark.parametrize("tag", MESHES)
def test_directory_checkpoint_loads_unsharded(runs, tag, name, backend):
    """The directory of four processes' shards restored into an unsharded
    one-process state: its payload is the gathered ``{name}_4.ckpt`` of the
    same state, bit for bit (``_directory_checks``)."""
    assert runs[4][tag, name, backend]["differs"] is None, runs[4][tag, name, backend]
