"""Data-parallel generation-route training in two gloo processes
(``train/train_ldm.py``, ``train/train_vae.py``).

Each process takes its half of a global batch (``tests/torch_dp_cases.py``)
and its rank's rows of the global batch's draws, handed to it or drawn from
a generator seeded alike on every process, for 2 steps.  The group's steps
must be the one-process steps on the global batches, from the same state
and draws (``torch_dp_cases.compare``): every log of the LDM
(``tests/test_torch_train_ldm.py`` holds that step to JAX), its
``scale_by_std`` scale and its LR, which scales with the process count, and
of the VAE finetune with the GAN on, ``d_weight`` included, the first step
at rtol 2e-5 (``tests/test_parallel.py``'s log tolerance) and the second at
rtol 1e-3; the first step's gradients and update, of the LDM's EMA too, and
the discriminator's BatchNorm statistics; both processes' parameters equal.
"""

import pytest
import torch

import torch_dp_cases as cases


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = {f"{name}_{how}": (f"run_{name}", (how == "handed",))
            for name in ("ldm", "vae") for how in ("handed", "drawn")}
    return cases.run_workers(jobs, tmp_path_factory.mktemp("dp_gen"))


def test_workers_import_no_jax(ranks):
    assert [r["jax_imported"] for r in ranks] == [False] * cases.PROCS


@pytest.mark.parametrize("how", ["handed", "drawn"])
def test_ldm_two_processes_equal_one(ranks, how):
    cases.assert_like_one(ranks, f"ldm_{how}")
    assert {r[f"ldm_{how}"]["lr"] for r in ranks} == {2e-4}  # 2 processes x 1 x base_lr
    assert len({r[f"ldm_{how}"]["scale"] for r in ranks}) == 1


@pytest.mark.parametrize("how", ["handed", "drawn"])
def test_vae_finetune_two_processes_equal_one(ranks, how):
    cases.assert_like_one(ranks, f"vae_{how}")
    logs = ranks[0][f"vae_{how}"]["logs"]
    assert set(logs[0]) == {"rec_loss", "kl", "g_loss", "d_weight", "ae_loss", "disc_loss"}
    assert logs[0]["d_weight"] < 1e4 * 0.5  # the adaptive weight, not its clip
