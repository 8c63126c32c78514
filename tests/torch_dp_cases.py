"""Data-parallel and sharded cases for the port's multi-process tests, and
the launcher that runs them in gloo processes.

The workers import the port and this module only (no JAX).  Each case makes
the global batches from numpy seeds, takes this process's rows (its data
index's on the process mesh; all of them without a group: the one-process
reference), takes STEPS steps and records every step's logs and the first
step's gradients and update (``_record``; sharded tensors gathered whole).
``run_workers`` starts ``procs`` Python processes (default PROCS) joined by
``SLICE3D_COORDINATOR`` / ``SLICE3D_NUM_PROCESSES`` / ``SLICE3D_PROCESS_ID``
into one gloo group on a free local port, each in one torch thread, lays
them out as the (data, model) process mesh ``mesh`` when one is given, and
fails within its timeout if the group hangs.  After the group, rank 0 runs
each case again without one and holds the group's run to it (``compare``);
the ranks return digests of their gradients and states, so that only the
readings and the failures reach the tests.
"""

import dataclasses
import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from slice3d_tpu_torch import camera
from slice3d_tpu_torch.config import Options
from slice3d_tpu_torch.data.pipeline import BatchLoader
from slice3d_tpu_torch.diffusion.latent import LatentDiffusion
from slice3d_tpu_torch.models.random_init import random_init_
from slice3d_tpu_torch.parallel import (all_reduce_mean, data_index, data_size, full_state_dict,
                                        full_tensor, load_state_dict_sharded, model_index, rank)
from slice3d_tpu_torch.train.checkpoint import save_checkpoint
from slice3d_tpu_torch.train.train_cam import CamTrainer
from slice3d_tpu_torch.train.train_ldm import LDMTrainer, trainable_parameters
from slice3d_tpu_torch.train.train_reg import RegressionTrainer
from slice3d_tpu_torch.train.train_vae import VAEFinetuneTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCS = 2  # processes of a data-parallel group; the global batch is PROCS x the local one
STEPS = 2  # steps a case takes; the second step's logs depend on the first update

REG_B, REG_IMG, REG_Q, REG_LR = 2, 32, 16, 3e-4  # local batch; the Options default LR
LDM_B, LDM_IMG, LDM_T = 1, 16, 20
LDM_TINY = dict(timesteps=LDM_T, vae_ch=32, vae_mult=(1, 2), vae_nres=1, unet_channels=32,
                unet_mult=(1, 2), unet_nres=1, unet_attention_ds=(1,),
                unet_inject_blocks=(0, 3), cond_widths=(32, 64), latent_size=LDM_IMG // 2)
VAE_N, VAE_IMG = 2, 32


def _mine(batch):
    """This process's rows of a global numpy batch dict: its data index's
    part (the same for the processes of one model group)."""
    per = len(next(iter(batch.values()))) // data_size()
    return {k: v[data_index() * per:(data_index() + 1) * per] for k, v in batch.items()}


def _floats(logs):
    return {k: float(v) for k, v in logs.items()}


def _record(parts, params, step):
    """Run ``step(i) -> logs`` for i < STEPS.  ``parts()``: {part: the
    tensors compared, by name}; ``params()``: {part: the trained
    parameters by name, whose ``.grad`` holds the gradient a step applied}
    (a part that is not trained, an EMA, is compared at its parameters'
    names).  Returns every step's logs; of the first step the gradients by
    part, the update of each compared tensor (after - before, fp64) and the
    BatchNorm running statistics after it; and ``parts`` after the last
    step."""
    snap = lambda: {part: {k: full_tensor(v).detach().clone() for k, v in d.items()}  # noqa
                    for part, d in parts().items()}
    before, out = snap(), {"logs": []}
    for i in range(STEPS):
        out["logs"].append(_floats(step(i)))
        if i == 0:
            after = snap()
            out["grads"] = {part: {k: full_tensor(p.grad).detach().clone()
                                   for k, p in named.items()}
                            for part, named in params().items()}
            names = {part: out["grads"].get(part, out["grads"].get("state"))
                     for part in after}
            out["delta"] = {part: {k: after[part][k].double() - before[part][k].double()
                                   for k in names[part]} for part in after}
            out["stats"] = {part: {k: v for k, v in d.items() if k.endswith(_STATS)}
                            for part, d in after.items()}
            del before, after
    out["last"] = snap()
    return out


# How the group's run is held to the one-process run (``compare``).  The
# first step's logs at the log tolerance of tests/test_parallel.py.  The
# later steps' at LATER_LOG_TOL: Adam's first step is lr * sign(g), so the
# few gradients that reduction-order noise alone sets apart from zero (a
# bias before a normalisation is one) move by lr with a sign either run may
# pick, and that moves the later logs of the regression models by up to
# 1.1e-4 relative (measured over three steps; ``later_logs`` in the
# readings), where an LR 1 % off moves their ``loss_pred`` by 3e-3 to 5e-3.  The first step's gradients per tensor at GRAD_RTOL of
# its norm plus GRAD_FLOOR of the model's largest gradient: the noise of a
# batch split reaches 7.5e-3 of the norm in the early convolutions of
# GTSlice's BatchNorm encoder (measured); a summed or an unreduced gradient
# is 1 off.  The first step's update, which Adam's scale-invariance would
# hide a gradient scale from, is held to the one-process update at
# UPDATE_RTOL on every element whose reference update is over half the
# largest (lr / 2 for Adam's first step) and whose gradient is settled,
# over SETTLED times the two runs' difference: there -lr * g / (|g| + eps)
# moves by at most 1 / SETTLED relative.  At least SETTLED_SHARE of those
# elements are compared (0.879 in GTSlice, the least, measured).  A step
# left out or an LR k times off is 1 or |k - 1| off.
LOG_TOL = dict(rtol=2e-5, atol=2e-6)
LATER_LOG_TOL = dict(rtol=1e-3, atol=2e-6)
GRAD_RTOL, GRAD_FLOOR = 2e-2, 1e-5
UPDATE_RTOL, SETTLED, SETTLED_SHARE = 1e-2, 100.0, 0.75
STATS_ATOL = 1e-6  # the BatchNorm running statistics after the first step
_STATS = ("running_mean", "running_var")


def _close(got, want, tol):
    return abs(got - want) <= tol["atol"] + tol["rtol"] * abs(want)


def compare(got, want):
    """Hold a rank's recorded run (``_record``) to the one-process run
    ``want``: (the failures, as text; the readings)."""
    fails, read = [], {"later_logs": 0.0, "grad": 0.0, "update": 0.0, "settled_share": 1.0}
    if len(got["logs"]) != len(want["logs"]):
        fails.append(f"{len(got['logs'])} steps, expected {len(want['logs'])}")
    for i, (g, w) in enumerate(zip(got["logs"], want["logs"])):
        if set(g) != set(w):
            fails.append(f"step {i}: logs {sorted(g)}, expected {sorted(w)}")
        for k in set(g) & set(w):
            if i:
                read["later_logs"] = max(read["later_logs"],
                                         abs(g[k] - w[k]) / max(abs(w[k]), 1e-30))
            if not _close(g[k], w[k], LOG_TOL if i == 0 else LATER_LOG_TOL):
                fails.append(f"step {i} {k}: {g[k]!r}, expected {w[k]!r}")
    if "scale" in want and not _close(got["scale"], want["scale"], dict(rtol=2e-5, atol=0.0)):
        fails.append(f"scale {got['scale']!r}, expected {want['scale']!r}")
    if got.get("lr") != want.get("lr"):
        fails.append(f"lr {got.get('lr')!r}, expected {want.get('lr')!r}")
    for k, w in want.get("eval", {}).items():  # after the last step, as the later logs
        if not _close(got["eval"][k], w, LATER_LOG_TOL):
            fails.append(f"eval {k}: {got['eval'][k]!r}, expected {w!r}")
    for part, grads in want["grads"].items():
        floor = GRAD_FLOOR * max(float(v.abs().max()) for v in grads.values())
        for k, v in grads.items():
            diff = float((got["grads"][part][k].double() - v.double()).norm())
            limit = GRAD_RTOL * float(v.double().norm()) + floor
            read["grad"] = max(read["grad"], diff / limit)
            if diff > limit:
                fails.append(f"gradient {part} {k}: off by {diff:.3g} (limit {limit:.3g})")
    for part, delta in want["delta"].items():
        grads = want["grads"].get(part, want["grads"].get("state"))
        got_grads = got["grads"].get(part, got["grads"].get("state"))
        big = max(float(d.abs().max()) for d in delta.values()) / 2
        n_big = n_settled = 0
        for k, d1 in delta.items():
            d2, g1 = got["delta"][part][k], grads[k].double()
            m = d1.abs() > big
            settled = m & (g1.abs() > SETTLED * (got_grads[k].double() - g1).abs())
            n_big, n_settled = n_big + int(m.sum()), n_settled + int(settled.sum())
            if settled.any():
                rel = float(((d2 - d1).abs()[settled] / d1.abs()[settled]).max())
                read["update"] = max(read["update"], rel)
                if rel > UPDATE_RTOL:
                    fails.append(f"update {part} {k}: off by {rel:.3g} relative")
        share = n_settled / max(n_big, 1)
        read["settled_share"] = min(read["settled_share"], share)
        if not n_big or share < SETTLED_SHARE:
            fails.append(f"update {part}: {n_settled} of {n_big} elements settled")
        for k, v in want["stats"][part].items():
            diff = float((got["stats"][part][k] - v).abs().max())
            if diff > STATS_ATOL:
                fails.append(f"statistics {part} {k}: off by {diff:.3g}")
    return fails, read


def assert_like_one(ranks, name):
    """Rank 0's run of job ``name`` was the one-process run (``compare``),
    and every rank ended with rank 0's logs, gradients and state."""
    r0 = ranks[0][name]
    print(f"{name}: {r0['readings']}")
    assert not r0["failures"], "\n".join(r0["failures"])
    for r in ranks[1:]:
        assert r[name]["logs"] == r0["logs"]
        assert r[name]["digests"] == r0["digests"]  # one averaged gradient, one update


def _digest(tensors):
    """{part: {name: tensor}} -> {part: {name: sha1 of its bytes}}."""
    return {part: {k: hashlib.sha1(v.detach().contiguous().reshape(-1).view(torch.uint8)
                                   .numpy().tobytes()).hexdigest() for k, v in d.items()}
            for part, d in tensors.items()}


def summarize(jobs, results, group_rank):
    """After the group: each job's logs, scalars and the digests of its
    gradients and last state; on rank 0 also ``compare`` against the job run
    again in this process without a group, the one-process reference."""
    out = {}
    for name, (fn, args) in jobs.items():
        got = results[name]
        out[name] = {k: got[k] for k in ("logs", "scale", "lr", "scaled_lr", "n_sharded",
                                         "taken", "where", "eval", "sharded", "logdir",
                                         "gathers", "local", "dir_failures")
                     if k in got}
        out[name]["digests"] = {k: _digest(got[k]) for k in ("grads", "last") if k in got}
        if group_rank == 0 and "delta" in got:
            out[name]["failures"], out[name]["readings"] = compare(
                got, getattr(sys.modules[__name__], fn)(*args))
        del got, results[name]
    return out


def reg_batch(seed):
    """The global regression batch (PROCS x REG_B objects)."""
    n = PROCS * REG_B
    rng = np.random.default_rng(seed)
    rots, trans = zip(*(camera.camera_matrices(az, el, 1.2) for az, el in
                        rng.uniform((0.0, -0.2), (2 * np.pi, 0.6), (n, 2))))
    sdf = rng.normal(size=(n, REG_Q)).astype(np.float32) * 0.1
    return {"img_input": rng.uniform(-1, 1, (n, REG_IMG, REG_IMG, 3)).astype(np.float32),
            "img_slices": rng.uniform(-1, 1, (n, 12, REG_IMG, REG_IMG, 3)).astype(np.float32),
            "qry_norot": rng.uniform(-0.5, 0.5, (n, REG_Q, 3)).astype(np.float32),
            "sdf": sdf, "occ": (sdf <= 0).astype(np.float32),
            "obj_rot_mat": np.stack(rots).astype(np.float32),
            "trans_mat_wo_rot_tp": np.stack(trans).astype(np.float32)}


def reg_opts(name):
    return Options(name_model=name, img_size=REG_IMG, n_qry=REG_Q, n_bs=REG_B, lr=REG_LR,
                   freq_decay=1, weight_decay=0.5)


def run_reg(name, init_path=None):
    """STEPS regression steps of ``name`` on the batches ``reg_batch(70 +
    i)`` from the port's seed-3 init (or the state_dict saved at
    ``init_path``), recorded (``_record``)."""
    trainer = RegressionTrainer(reg_opts(name), steps_per_epoch=4, device="cpu")
    state = trainer.init_state(seed=3)
    if init_path is not None:
        state.model.load_state_dict(torch.load(init_path))
    return _record(lambda: {"state": state.model.state_dict()},
                   lambda: {"state": dict(state.model.named_parameters())},
                   lambda i: trainer.train_step(state, _mine(reg_batch(70 + i)))[1])


def cam_batch(seed):
    n = PROCS * REG_B
    rng = np.random.default_rng(seed)
    return {"img_input": rng.uniform(-1, 1, (n, REG_IMG, REG_IMG, 3)).astype(np.float32),
            "pcd": rng.uniform(-0.5, 0.5, (n, 64, 3)).astype(np.float32),
            "regress_mat": rng.normal(size=(n, 4, 3)).astype(np.float32),
            "norm_mat": np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy(),
            "K": np.broadcast_to(camera.intrinsics(1.0, 1.0).astype(np.float32),
                                 (n, 3, 3)).copy()}


def run_cam():
    """STEPS CameraNet steps on ``cam_batch(80 + i)`` from the seed-4 init,
    recorded."""
    trainer = CamTrainer(lr=REG_LR, img_size=REG_IMG, device="cpu")
    state = trainer.init_state(seed=4)
    return _record(lambda: {"state": state.model.state_dict()},
                   lambda: {"state": dict(state.model.named_parameters())},
                   lambda i: {"loss": trainer.train_step(state, _mine(cam_batch(80 + i)))[1]})


def ldm_inputs(seed):
    """(the global batch, the global draws of one step)."""
    n, h = PROCS * LDM_B, LDM_IMG // 2
    rng = np.random.default_rng(seed)
    batch = {"image": rng.uniform(-1, 1, (n, 13, LDM_IMG, LDM_IMG, 3)).astype(np.float32),
             "img_ipt_view": rng.uniform(-1, 1, (n, LDM_IMG, LDM_IMG, 3)).astype(np.float32)}
    draws = {"posterior_noise": rng.normal(size=(n, 13, h, h, 4)).astype(np.float32),
             "t": rng.integers(0, LDM_T, (n,)),
             "noise": rng.normal(size=(n, 4 * h, 4 * h, 4)).astype(np.float32)}
    return batch, draws


def run_ldm(handed):
    """``maybe_set_scale`` and STEPS LDM steps on ``ldm_inputs(90 + i)`` from
    the seed-0 model, with handed global draws (``handed``) or drawn from a
    generator seeded alike on every process, recorded (the trainable
    parameters and the EMA), with the scale and the LR."""
    module = random_init_(LatentDiffusion(**LDM_TINY), torch.Generator().manual_seed(0))
    trainer = LDMTrainer(img_size=LDM_IMG, batch_size=LDM_B * PROCS // data_size(),
                         timesteps=LDM_T, base_lr=1e-4, module=module.eval(),
                         scale_by_std=True, device="cpu")
    state = trainer.init_state()
    batch, draws = ldm_inputs(90)
    g = torch.Generator().manual_seed(91)
    trainer.maybe_set_scale(state, _mine(batch), g,
                            noise=draws["posterior_noise"] if handed else None)

    def step(i):
        batch, draws = ldm_inputs(90 + i)
        return trainer.train_step(state, _mine(batch), g,
                                  draws=draws if handed else None)[1]

    out = _record(lambda: {"state": trainable_parameters(state.ldm), "ema": state.ema},
                  lambda: {"state": trainable_parameters(state.ldm)}, step)
    return dict(out, scale=float(state.ldm.scale_factor), lr=trainer.lr)


def run_vae(handed):
    """STEPS finetune steps with the GAN on from the seed-5 init, the
    posterior noise handed (global) or drawn from a generator seeded alike,
    recorded (both networks)."""
    trainer = VAEFinetuneTrainer(img_size=VAE_IMG, vae_ch=32, vae_mult=(1, 2), vae_nres=1,
                                 lr=1e-4, disc_start=0, device="cpu")
    state = trainer.init_state(seed=5)
    rng = np.random.default_rng(100)
    n = PROCS * VAE_N
    g = torch.Generator().manual_seed(6)

    def step(i):
        batch = {"image": rng.uniform(-1, 1, (n, VAE_IMG, VAE_IMG, 3)).astype(np.float32)}
        noise = rng.normal(size=(n, VAE_IMG // 2, VAE_IMG // 2, 4)).astype(np.float32)
        return trainer.train_step(state, _mine(batch), g,
                                  draws={"posterior_noise": noise} if handed else None)[1]

    return _record(lambda: {"state": state.vae.state_dict(), "disc": state.disc.state_dict()},
                   lambda: {"state": dict(state.vae.named_parameters()),
                            "disc": dict(state.disc.named_parameters())}, step)


def run_reg_cli(data_root, exp_root, writes_path):
    """The SliceNet CLI for one epoch, each checkpoint write recorded with the
    writing process's rank; returns the final state_dict."""
    from slice3d_tpu_torch.train import __main__ as cli
    from slice3d_tpu_torch.train import train_reg

    save = train_reg.save_checkpoint

    def recorded(path, payload, *args, **kwargs):
        with open(writes_path, "a") as f:
            f.write(f"{rank()} {os.path.basename(path)}\n")
        return save(path, payload, *args, **kwargs)

    train_reg.save_checkpoint = recorded
    state = cli.main(["--dir_data", data_root, "--name_dataset", "synth", "--device", "cpu",
                      "--img_size", "32", "--n_qry", "16", "--n_bs", "1", "--n_views", "6",
                      "--n_epochs", "1", "--n_wk", "1", "--freq_ckpt", "1", "--multi_gpu",
                      "--dir_experiments", exp_root, "--name_exp", "dp"])
    return {"last": {"state": state.model.state_dict()}}


# -- parameters sharded over the model axis (tests/test_torch_multiprocess_fsdp.py) --------

FSDP_MIN = 2 ** 10  # the sharding floor: tests/test_parallel.py's sharded step
LDM_GLOBAL = PROCS * LDM_B  # the LDM's global batch on every process mesh


class _OwnSlice:
    """A reduce-scatter that keeps this process's slice of its own gradient
    and reduces nothing over the model group: what DTensor's default
    ``full_tensor()`` backward gives a gathered parameter."""

    def allocate(self, size, *, dtype, device):
        return torch.empty(*size, dtype=dtype, device=device)

    def __call__(self, output_tensor, input_tensor, group, op, async_op=False):
        output_tensor.copy_(input_tensor.view(group.size(), -1)[group.rank()])


def _default_backward(module):
    """``module``'s sharded gradients left unreduced over the model group
    (``_OwnSlice``) in each of its ``fully_shard`` units."""
    from torch.distributed.fsdp import FSDPModule

    for m in module.modules():
        if isinstance(m, FSDPModule):
            m.set_custom_reduce_scatter(_OwnSlice())


def _sharded_count(module):
    return sum(isinstance(p, DTensor) for p in module.parameters())


def run_reg_fsdp(init_path, default_backward=False):
    """STEPS SliceNet steps on ``reg_batch(70 + i)`` from the state_dict saved
    at ``init_path``, the parameters of at least FSDP_MIN elements sharded
    over the model axis and the queries split over it, recorded, with the
    count of sharded parameters and ``eval_epoch``'s logs after the steps on
    ``reg_batch(79)``; with ``default_backward``, the model group's
    gradient reduction swapped for ``_OwnSlice``."""
    trainer = RegressionTrainer(reg_opts("slicenet"), steps_per_epoch=4, device="cpu",
                                fsdp_min_size=FSDP_MIN)
    state = trainer.init_state(seed=3)
    if default_backward:
        _default_backward(state.model)
    load_state_dict_sharded(state.model, torch.load(init_path))
    out = _record(lambda: {"state": full_state_dict(state.model)},
                  lambda: {"state": dict(state.model.named_parameters())},
                  lambda i: trainer.train_step(state, _mine(reg_batch(70 + i)))[1])
    return dict(out, n_sharded=_sharded_count(state.model),
                eval=trainer.eval_epoch(state, [_mine(reg_batch(79))]))


def ldm_fsdp_trainer(**kw):
    """The tiny LDM's trainer at the process's share of LDM_GLOBAL (fixed LR,
    as the JAX trainer it is held to), sharding at FSDP_MIN."""
    return LDMTrainer(img_size=LDM_IMG, batch_size=LDM_GLOBAL // data_size(),
                      timesteps=LDM_T, module=LatentDiffusion(**LDM_TINY).eval(),
                      device="cpu", fsdp_min_size=FSDP_MIN, **kw)


class _Indices:
    """A dataset of 8 rows, each its index."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return {"i": np.array(i)}


def run_ldm_fsdp(payload_path, inputs_path):
    """``maybe_set_scale`` (recorded, then set back to the 1.0 of the JAX
    state the steps are held to) and STEPS LDM steps on the global batches
    and draws saved at ``inputs_path`` (``batch{i}_*``, ``draws{i}_*``, the
    JAX steps' own), from the payload at ``payload_path``, sharded, recorded
    (the trainable parameters and the EMA) with the scale, the LR, the LR
    the same trainer scales by the data axis, digests of the batch rows,
    loader rows and draws this process took, and the EMA's eval losses
    after the steps (the group's mean: each process evaluates its rows)."""
    inputs = np.load(inputs_path)
    trainer = ldm_fsdp_trainer(base_lr=1e-4, scale_lr=False, scale_by_std=True)
    state = trainer.init_state()
    trainer.load_payload(state, torch.load(payload_path))
    batch = lambda i: _mine({k: inputs[f"batch{i}_{k}"]  # noqa: E731
                             for k in ("image", "img_ipt_view")})
    draws = lambda i: {k: inputs[f"draws{i}_{k}"]  # noqa: E731
                       for k in ("posterior_noise", "t", "noise")}
    trainer.maybe_set_scale(state, batch(0), noise=draws(0)["posterior_noise"])
    scale = float(state.ldm.scale_factor)
    state.ldm.scale_factor.fill_(1.0)
    loader = BatchLoader(_Indices(), 1, num_workers=1)
    taken = _digest({"rows": {"batch": torch.as_tensor(batch(0)["image"]),
                              "loader": torch.as_tensor(np.concatenate([b["i"] for b in loader]))},
                     "draws": trainer._step_draws(state.ldm, torch.as_tensor(batch(0)["image"]),
                                                  torch.Generator().manual_seed(7), None)})
    out = _record(lambda: {"state": trainable_parameters(state.ldm), "ema": state.ema},
                  lambda: {"state": trainable_parameters(state.ldm)},
                  lambda i: trainer.train_step(state, batch(i), draws=draws(i))[1])
    scaled = ldm_fsdp_trainer(base_lr=1e-4).lr
    return dict(out, scale=scale, lr=trainer.lr, scaled_lr=scaled, taken=taken,
                where=(data_index(), model_index()), n_sharded=_sharded_count(state.ldm),
                eval=_floats(all_reduce_mean({k: torch.tensor(v) for k, v in trainer.eval_loss(
                    state, batch(0), draws=draws(0)).items()})))


def run_ckpt_fsdp(reg_path, ldm_path, out_dir):
    """The unsharded checkpoints at ``reg_path`` (SliceNet) and ``ldm_path``
    (the tiny LDM) restored into sharded states; every process gathers the
    payloads and rank 0 alone writes them under ``out_dir``
    (``reg_{world}.ckpt``, ``ldm_{world}.ckpt``, world the group's size or 1);
    then STEPS SliceNet steps on ``reg_batch(75 + i)`` from the restored
    state, recorded."""
    from slice3d_tpu_torch.parallel import world_size

    reg = RegressionTrainer(reg_opts("slicenet"), steps_per_epoch=4, device="cpu",
                            fsdp_min_size=FSDP_MIN)
    state, _ = reg.restore(reg.init_state(seed=9), reg_path)
    ldm = ldm_fsdp_trainer(base_lr=1e-4)
    lstate = ldm.restore(ldm.init_state(), ldm_path)
    # as the CLIs write: the regression payload gathered by every process and
    # written by rank 0; the LDM saved by rank 0 while the others gather
    payload = reg.state_payload(state, 0)
    if rank() == 0:
        save_checkpoint(os.path.join(out_dir, f"reg_{world_size()}.ckpt"), payload)
        ldm.save(lstate, os.path.join(out_dir, f"ldm_{world_size()}.ckpt"))
    else:
        ldm.state_payload(lstate)
    out = _record(lambda: {"state": full_state_dict(state.model)},
                  lambda: {"state": dict(state.model.named_parameters())},
                  lambda i: reg.train_step(state, _mine(reg_batch(75 + i)))[1])
    return dict(out, n_sharded=_sharded_count(state.model) + _sharded_count(lstate.ldm))


class _Gathers:
    """Counts the gathers of sharded tensors (``DTensor.full_tensor``, which
    ``parallel.full_tensor`` and ``full_state_dict`` run) within the block."""

    def __enter__(self):
        self.n, self.real = 0, DTensor.full_tensor

        def counted(t, *a, **k):
            self.n += 1
            return self.real(t, *a, **k)

        DTensor.full_tensor = counted
        return self

    def __exit__(self, *exc):
        DTensor.full_tensor = self.real


def _local_bytes(payload):
    """[the bytes of the tensors this process holds in a payload (a shard's
    local part, a plain tensor whole), the bytes of the whole tensors, the
    number of tensors]."""
    out = [0, 0, 0]
    for v in payload.values():
        if isinstance(v, dict):
            out = [a + b for a, b in zip(out, _local_bytes(v))]
        elif isinstance(v, torch.Tensor):
            t = v.to_local() if isinstance(v, DTensor) else v
            out = [out[0] + t.numel() * t.element_size(), out[1] + v.numel() * v.element_size(),
                   out[2] + 1]
    return out


def _gathered(payload):
    """A payload's tensors gathered whole and copied, its other values as
    they are (the comparison after a restore)."""
    if isinstance(payload, dict):
        return {k: _gathered(v) for k, v in payload.items()}
    return full_tensor(payload).detach().clone() if isinstance(payload, torch.Tensor) else payload


def _differences(got, want, where=""):
    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{where}: keys {sorted(set(got) ^ set(want))}"]
        return [d for k in want for d in _differences(got[k], want[k], f"{where}/{k}")]
    if isinstance(want, torch.Tensor):
        same = got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
        return [] if same else [f"{where}: not equal"]
    return [] if got == want else [f"{where}: {got!r}, expected {want!r}"]


def run_dir_ckpt_fsdp(reg_path, ldm_path, out_dir):
    """The unsharded checkpoints at ``reg_path`` (SliceNet) and ``ldm_path``
    (the tiny LDM) restored into sharded states, each saved by every process
    as a checkpoint directory under ``out_dir`` (``{name}_{backend}.ckpt``)
    with ``orbax``, then ``orbax_async`` and ``wait_pending``, the gathers
    within each save counted; each directory restored into a fresh sharded
    state, held bit for bit to the saved one (gathered after the saves).
    Returns the counts, per trainer ``_local_bytes`` of the saved payload,
    the failures and the count of sharded parameters."""
    from slice3d_tpu_torch.train.checkpoint import wait_pending

    makers = {  # (trainer, its directory payload, a state restored from a path)
        "reg": (lambda b: RegressionTrainer(dataclasses.replace(reg_opts("slicenet"),
                                                                ckpt_backend=b),
                                            steps_per_epoch=4, device="cpu",
                                            fsdp_min_size=FSDP_MIN),
                lambda tr, st: tr.checkpoint_payload(st, 0),
                lambda tr, path: tr.restore(tr.init_state(seed=9), path)[0], reg_path),
        "ldm": (lambda b: ldm_fsdp_trainer(base_lr=1e-4, ckpt_backend=b),
                lambda tr, st: tr.checkpoint_payload(st),
                lambda tr, path: tr.restore(tr.init_state(), path), ldm_path)}
    out = {"gathers": {}, "local": {}, "dir_failures": []}
    for name, (make, payload_of, restored, src) in makers.items():
        trainer = make("orbax")
        state = restored(trainer, src)
        out["local"][name] = _local_bytes(payload_of(trainer, state))
        want = _gathered(payload_of(trainer, state))
        for backend in ("orbax", "orbax_async"):
            path = os.path.join(out_dir, f"{name}_{backend}.ckpt")
            with _Gathers() as g:  # what the trainers' save writes
                save_checkpoint(path, payload_of(trainer, state), backend)
                wait_pending()
            out["gathers"][f"{name}_{backend}"] = g.n
            again = make(backend)
            got = _gathered(payload_of(again, restored(again, path)))
            out["dir_failures"] += [f"{name} {backend}{d}" for d in _differences(got, want)]
        out["n_sharded"] = out.get("n_sharded", 0) + _sharded_count(
            state.model if name == "reg" else state.ldm)
    return out


def main_ldm_argv(cfg_path, logs_root):
    """``main -t`` on the tiny LDM config at ``cfg_path`` for 2 steps with
    every interval at 2: a checkpoint, a validation and its top-k file, the
    image logs."""
    return ["-b", cfg_path, "-t", "-l", logs_root, "-n", "ldm", "--max_steps", "2",
            "--ckpt_every", "2", "--val_every", "2", "--log_images_every", "2",
            "--ddim_steps", "2", "--scale_lr", "False", "--device", "cpu", "--dtype", "float32"]


def run_main_ldm_fsdp(cfg_path, logs_root):
    """``main -t`` (``main_ldm_argv``) with the trainer sharding at FSDP_MIN
    (the CLI's own floor shards nothing at these widths); returns whether
    the state was sharded, the run's logdir, where rank 0 alone wrote, and
    the final state gathered (its digest reaches the test)."""
    import functools

    from slice3d_tpu_torch import main as cli
    from slice3d_tpu_torch.parallel import is_sharded

    states = []

    class Trainer(LDMTrainer):
        def init_state(self, seed=0):
            states.append(super().init_state(seed))
            return states[-1]

    cli.LDMTrainer = functools.partial(Trainer, fsdp_min_size=FSDP_MIN)
    try:
        logdir = cli.main(main_ldm_argv(cfg_path, logs_root))
    finally:
        cli.LDMTrainer = LDMTrainer
    return {"sharded": [is_sharded(st.ldm) for st in states], "logdir": logdir,
            "last": {"state": full_state_dict(states[-1].ldm)}}


WORKER = """
import sys
sys.path[:0] = [{root!r}, {tests!r}]
# the scalars go to the printer: TensorBoard may import TensorFlow, which may import JAX
sys.modules["torch.utils.tensorboard"] = None
import torch
torch.set_num_threads(1)
from slice3d_tpu_torch.parallel import init_distributed, init_process_mesh, rank
assert init_distributed(device="cpu", timeout_s={timeout_s}) == {procs}
if {mesh!r} is not None:
    init_process_mesh({mesh!r})
import torch_dp_cases as cases
jobs, r = {jobs!r}, rank()
results = {{name: getattr(cases, fn)(*args) for name, (fn, args) in jobs.items()}}
torch.distributed.destroy_process_group()
out = cases.summarize(jobs, results, r)
out["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "slice3d_tpu."))
                          for m in sys.modules)
torch.save(out, f"{out_dir}/rank{{r}}.pt")
"""


def start_workers(jobs, out_dir, procs=PROCS, mesh=None, timeout_s=30):
    """Start ``jobs`` ({name: (function of this module, args)}) in ``procs``
    gloo processes laid out as the process mesh ``mesh`` (default: all on
    ``data``), ``timeout_s`` the group's collective timeout; returns the
    handle ``finish_workers`` takes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = WORKER.format(root=ROOT, tests=os.path.dirname(os.path.abspath(__file__)),
                         procs=procs, mesh=None if mesh is None else tuple(mesh), jobs=jobs,
                         out_dir=str(out_dir), timeout_s=timeout_s)
    handles = []
    for r in range(procs):
        env = dict(os.environ, SLICE3D_COORDINATOR=f"127.0.0.1:{port}",
                   SLICE3D_NUM_PROCESSES=str(procs), SLICE3D_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="1")
        handles.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return handles, out_dir


def finish_workers(started, timeout=300):
    """Wait for ``start_workers``' processes (killing them at ``timeout``);
    returns each rank's {name: ``summarize``'s summary, "jax_imported":
    bool}."""
    procs, out_dir = started
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, text in zip(procs, outputs):
        if p.returncode != 0:
            raise AssertionError(f"a worker failed ({p.returncode}):\n{text[-4000:]}")
    return [torch.load(f"{out_dir}/rank{r}.pt", weights_only=False) for r in range(len(procs))]


def run_workers(jobs, out_dir, timeout=300, **kw):
    """``start_workers`` then ``finish_workers``."""
    return finish_workers(start_workers(jobs, out_dir, **kw), timeout)
