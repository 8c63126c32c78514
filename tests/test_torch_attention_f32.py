"""The fp32 attention kernels' Python side, on the CPU (no card, no JAX).

The kernels themselves run only on the card (tests/test_torch_cuda.py, and
phase 19 of chip_smoke.py); their plain twins are held against the Pallas
kernels in interpret mode by tests/test_torch_attention.py.  Here: the dtype
rule of the kernel wrappers, the choice of library, counter and arguments
for each dtype (with the C entry points replaced by recorders), the fp32
sources' own constraints, and that ``main`` builds the UNet with the kernel
route at every ``--dtype``, so an fp32 training step sends its long attention
blocks through ``spatial_attention`` with grad on.
"""

import contextlib
import os
import re
import types

import numpy as np
import pytest
import torch

from slice3d_tpu_torch import main as port_main
from slice3d_tpu_torch.models import ldm_unet
from slice3d_tpu_torch.ops import spatial_attention as sa

IMG, B = 16, 2  # latent 8, a 32 x 32 atlas: T = 1024 at ds 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores, and a thread pool per worker spends its time waiting for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return {"model": {"base_learning_rate": 5e-5,
                      "params": {"timesteps": 20,
                                 "unet_config": {"params": {"model_channels": 32,
                                                            "channel_mult": [1, 2],
                                                            "num_res_blocks": 1,
                                                            "attention_resolutions": [1]}},
                                 "first_stage_config": {"params": {"ddconfig": {
                                     "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1}}}}},
            "data": {"params": {"batch_size": B, "train": {"params": {"size": IMG}}}}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_main_builds_the_kernel_route_at_every_dtype(dtype):
    module, trainer, img_size, bs = port_main.build_module_and_trainer(_cfg(), "cpu", dtype)
    blocks = [m for m in module.modules() if isinstance(m, ldm_unet.AttentionBlock)]
    assert (img_size, bs) == (IMG, B) and len(blocks) == 4  # 3 at ds 1, the middle one
    assert all(b.fused for b in blocks)


def test_main_fp32_step_routes_attention_through_the_kernel_function(monkeypatch):
    """``main``'s fp32 trainer on the CPU: the ds-1 blocks (T = 1024) call
    ``spatial_attention`` (the kernels on the card) with grad on, one
    forward each, and the step's gradients pass through its backward."""
    calls = []
    real = ldm_unet.spatial_attention
    monkeypatch.setattr(ldm_unet, "spatial_attention",
                        lambda q, *a: calls.append((tuple(q.shape), q.dtype, q.requires_grad))
                        or real(q, *a))
    monkeypatch.setattr(ldm_unet, "spatial_attention_ref",
                        lambda *a: pytest.fail("the plain attention was called"))
    _, trainer, _, _ = port_main.build_module_and_trainer(_cfg(), "cpu", torch.float32)
    state = trainer.init_state(0)
    trainer.module = None
    rng = np.random.default_rng(3)
    batch = {"image": rng.uniform(-1, 1, (B, 13, IMG, IMG, 3)).astype(np.float32),
             "img_ipt_view": rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)}
    before = {n: p.detach().clone() for n, p in state.ldm.named_parameters()
              if "attn" in n or ".qkv." in n}
    state, logs = trainer.train_step(state, batch, torch.Generator().manual_seed(0))
    assert calls == [((B, 8, 1024, 4), torch.float32, True)] * 3
    assert np.isfinite(float(logs["loss"]))
    # the attention blocks' qkv weights moved: the backward reached them
    moved = [n for n, p in state.ldm.named_parameters()
             if n in before and not torch.equal(p.detach(), before[n])]
    assert any(".qkv." in n for n in moved)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_dtype_takes_fp32_and_bf16(dtype):
    x = torch.zeros((1, 2, 1024, 24), dtype=dtype)
    assert sa.kernel_dtype(("q", x), ("k", x), ("v", x)) == dtype
    assert dtype in sa.KERNEL_DTYPES


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64], ids=["fp16", "fp64"])
def test_kernel_dtype_refuses_other_dtypes(dtype):
    x = torch.zeros((1, 2, 1024, 24), dtype=dtype)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        sa.kernel_dtype(("q", x), ("k", x), ("v", x))
    # also where only the last tensor has it
    y = torch.zeros((1, 2, 1024, 24))
    with pytest.raises(TypeError, match="v torch"):
        sa.kernel_dtype(("q", y), ("k", y), ("v", x))


@pytest.mark.parametrize("pair", [(torch.float32, torch.bfloat16),
                                  (torch.bfloat16, torch.float32)],
                         ids=["fp32-bf16", "bf16-fp32"])
def test_kernel_dtype_refuses_mixed_dtypes(pair):
    a, b = (torch.zeros((1, 2, 1024, 24), dtype=d) for d in pair)
    with pytest.raises(TypeError, match="one dtype a call"):
        sa.kernel_dtype(("q", a), ("do", b))


def test_kernel_inputs_on_the_cpu_stop_at_the_device():
    """The full check on a CPU tensor stops at the device; the dtype rule
    it applies on the card is ``kernel_dtype`` (above)."""
    x = torch.zeros((1, 2, 1024, 24))
    with pytest.raises(ValueError, match="unsupported device"):
        sa._check_kernel_inputs(("q", x), ("k", x), ("v", x))


class _Recorder:
    """A stand-in for a C entry point: keeps each call's arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def recorders(monkeypatch):
    """The four C entry points replaced by recorders, and the CUDA device
    and stream calls of the launch helpers made harmless on the CPU."""
    rec = {(fwd, dt): _Recorder() for fwd in (True, False)
           for dt in (torch.bfloat16, torch.float32)}
    monkeypatch.setattr(sa, "kernel", lambda dtype=torch.bfloat16: rec[(True, dtype)])
    monkeypatch.setattr(sa, "kernel_bwd", lambda dtype=torch.bfloat16: rec[(False, dtype)])
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=7))
    for name in ("launches", "launches_bwd", "launches_f32", "launches_bwd_f32"):
        monkeypatch.setattr(sa, name, 0)
    return rec


def _counts():
    return (sa.launches, sa.launches_bwd, sa.launches_f32, sa.launches_bwd_f32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_launch_helpers_pick_the_library_and_counter_of_the_dtype(recorders, dtype):
    """Each dtype reaches its own entry points with the argument list the
    binding declares (fp32 backward: no dq scratch) and counts on its own
    counters; the log-sum-exp is fp32 in both."""
    shape, scale = (2, 3, 1024, 24), 0.2
    q, k, v, do = (torch.zeros(shape, dtype=dtype) for _ in range(4))
    out, lse = sa._forward_kernel(q, k, v, scale, with_lse=True)
    assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == shape[:3]
    (args,) = recorders[(True, dtype)].calls
    assert len(args) == 5 + 5 and args[5:9] == (6, 1024, 24, scale) and args[9] == 7
    assert args[4] == lse.data_ptr()
    dq, dk, dv = sa._backward_kernel(q, k, v, out, lse, do, scale)
    assert all(g.dtype == dtype and g.shape == shape for g in (dq, dk, dv))
    (args,) = recorders[(False, dtype)].calls
    n_ptrs = 10 if dtype == torch.float32 else 11
    assert len(args) == n_ptrs + 5 and args[n_ptrs:n_ptrs + 4] == (6, 1024, 24, scale)
    assert args[n_ptrs - 3:n_ptrs] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    f32 = dtype == torch.float32
    assert _counts() == ((0, 0, 1, 1) if f32 else (1, 1, 0, 0))
    other = torch.bfloat16 if f32 else torch.float32
    assert not recorders[(True, other)].calls and not recorders[(False, other)].calls


def test_forward_without_lse_passes_a_null_pointer(recorders):
    q = torch.zeros((1, 2, 1024, 48))
    out, lse = sa._forward_kernel(q, q, q, 0.1, with_lse=False)
    assert lse is None and recorders[(True, torch.float32)].calls[0][4] is None
    assert _counts() == (0, 0, 1, 0)


def test_a_failed_fp32_launch_raises(recorders, monkeypatch):
    monkeypatch.setattr(sa, "kernel", lambda dtype=torch.bfloat16: lambda *a: 98)
    q = torch.zeros((1, 2, 1024, 24))
    with pytest.raises(RuntimeError, match="float32 kernel launch failed: CUDA error 98"):
        sa._forward_kernel(q, q, q, 0.1, with_lse=False)
    assert _counts() == (0, 0, 0, 0)


@pytest.mark.parametrize("name", ["spatial_attention_f32x3.cu"])
def test_fp32_sources_use_fp32_alone(name):
    """The fp32 forward takes fp32 and gives fp32: no bf16 or half type, no
    library kernel, no inline assembly of its own, and the tensor cores only
    through the 3xTF32 helpers of csrc/attention_sm90.cuh."""
    with open(os.path.join(sa._CSRC, name)) as f:
        code = "\n".join(line.split("//")[0] for line in f)  # comments aside
    for word in ("bf16", "bfloat16", "half", "wmma", "cublas", "cudnn", "cutlass", "asm"):
        assert not re.search(word, code, flags=re.I), (name, word)
    assert set(re.findall(r"\w*tf32\w*", code, flags=re.I)) == {
        "tf32x3_ss", "tf32x3_rs", "tf32x3_from_acc"}
    assert re.findall(r"#include <([^>]+)>", code) == ["cuda_runtime.h", "math.h", "stdint.h"]
