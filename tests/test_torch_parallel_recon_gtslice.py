"""The port's sharded Reconstructor on GTSlice against JAX's sharded one and
the port's unsharded one (the checks of ``tests/test_torch_parallel_recon.py``,
in a file of its own so that the test workers share the cost)."""

import pytest
import torch

from test_torch_parallel_recon import check_sharded, sharded_setup


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gtslice():
    return sharded_setup("gtslice")


@pytest.mark.parametrize("shard_axis", ["batch", "points"])
def test_sharded_gtslice(gtslice, shard_axis):
    check_sharded(gtslice, shard_axis)
