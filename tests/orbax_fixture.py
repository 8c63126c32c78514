"""The JAX orbax checkpoint committed at
``slice3d_tpu_torch/train/testdata/jax_orbax/`` (``state/`` and
``expected.json``), written by the JAX package's own ``save_checkpoint(...,
backend="orbax")``.  ``chip_smoke.py`` reads it on the card's machine, which
has no JAX to write one.

orbax compresses chunks at zstd level 1, which never repeats a sequence
table from block to block (zstd's fast strategies do that only with a
dictionary), so the fixture also holds ``level19.zst``: the first 400,000
bytes of the ``params/big`` leaf as one zstd frame at level 19 with a content
checksum, written by ``zstandard``, whose blocks repeat their tables and use
all three repeat offsets.

Regenerate it from the repository root (8 virtual CPU devices for the
sharded leaf):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 python tests/orbax_fixture.py
"""

import hashlib
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "slice3d_tpu_torch", "train", "testdata", "jax_orbax")
LEVEL19_BYTES = 400_000


def fixture_state():
    """The state: an fp32 leaf sharded over 8 devices (8 chunks), a bf16 leaf,
    int32 / int64 / Python-int scalars, a None and an empty dict, and one
    ~1 MB fp32 chunk of quarter-step values in repeating runs, whose zstd frame
    spans several compressed blocks with matches, Huffman literals reused from
    block to block and repeated sequence tables."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(14)
    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    sharded = jax.device_put(jnp.asarray(rng.standard_normal((64, 48)).astype(np.float32)),
                             NamedSharding(mesh, P("d")))
    bf16 = jnp.asarray(rng.standard_normal((37, 5)).astype(np.float32) * 3).astype(jnp.bfloat16)
    runs = rng.integers(-8, 8, (4096,)).astype(np.float32) * 0.25
    starts = rng.integers(0, 4096 - 65, (1024 * 260 // 64,))
    big = np.concatenate([runs[s:s + 64] for s in starts]).reshape(1024, 260)
    big[rng.random(big.shape) < 0.02] = rng.standard_normal(1).astype(np.float32)[0]
    return {"params": {"sharded": sharded, "bf16": bf16, "big": jnp.asarray(big),
                       "empty": {}},
            "step": np.int32(41), "count": np.int64(-3), "epoch": 7, "none": None}


def leaves(tree, prefix=()):
    """(key path, leaf) of every array or scalar, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        elif v is not None:
            yield prefix + (k,), v


def describe(tree) -> dict:
    """Each leaf's shape, dtype and SHA-256 of its C-order bytes, as the
    port's ``read_flax_checkpoint`` gives it (bf16 widened to fp32)."""
    out = {}
    for path, v in leaves(tree):
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        a = a.copy(order="C")  # (ascontiguousarray makes a 0-d array 1-d)
        out["/".join(path)] = {"shape": list(a.shape), "dtype": str(a.dtype),
                               "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def write_fixture(out_dir: str) -> dict:
    """Write ``state/`` (the orbax directory) and ``expected.json`` into
    ``out_dir``; returns the expected description."""
    from slice3d_tpu.train.checkpoint import save_checkpoint

    state = fixture_state()
    target = os.path.join(out_dir, "state")
    if os.path.exists(target):
        shutil.rmtree(target)
    os.makedirs(out_dir, exist_ok=True)
    save_checkpoint(target, state, backend="orbax")
    import zstandard

    head = np.asarray(state["params"]["big"]).tobytes()[:LEVEL19_BYTES]
    with open(os.path.join(out_dir, "level19.zst"), "wb") as f:
        f.write(zstandard.ZstdCompressor(level=19, write_checksum=True).compress(head))
    expected = {"leaves": describe(state), "none": ["none"], "empty": ["params/empty"],
                "level19": {"size": len(head), "sha256": hashlib.sha256(head).hexdigest()}}
    with open(os.path.join(out_dir, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    return expected


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
