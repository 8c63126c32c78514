"""Time reading a full-width JAX ``RegressionTrainer`` (SliceNet) checkpoint
written with ``--ckpt_backend orbax``: the JAX package's
``restore_checkpoint`` (orbax and tensorstore) against the port's
``read_flax_checkpoint`` (its own zstd decoder and OCDBT / zarr reader), each
in a fresh process, on the CPU of the machine that runs it.

    python tests/time_orbax_read.py [--repeat 3] [--dir DIR]

The state (parameters, batch statistics, Adam's moments, step) has the
published widths and redrawn values (tests/jax_weights.py; the moments drawn
at 1e-3); the JAX package writes it once.  Each read runs ``--repeat``
times, alternating JAX and the port; the last line is a JSON object with the wall times of the reads (the
imports left out), the decoded bytes, the port's decode rate and its peak
resident memory above its start.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WRITE = r"""
import os, sys
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path[:0] = [{root!r}, os.path.join({root!r}, "tests")]
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax_weights import redraw
from slice3d_tpu.config import Options
from slice3d_tpu.train.train_reg import RegressionTrainer
trainer = RegressionTrainer(Options(name_model="slicenet", img_size=128,
                                    ckpt_backend="orbax"), steps_per_epoch=1)
shapes = jax.eval_shape(trainer.init_state)
variables = redraw({{"params": shapes.params, "batch_stats": shapes.batch_stats}}, 0)
params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
# Adam's moments drawn too (a trained state's are not zeros, which compress away)
rng = np.random.default_rng(1)
opt_state = jax.tree_util.tree_map(
    lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 1e-3)
    if jnp.issubdtype(x.dtype, jnp.floating) else x, trainer.tx.init(params))
state = shapes.replace(step=jnp.int32(100), params=params, opt_state=opt_state,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                          variables["batch_stats"]))
print(trainer.save(state, {out!r}, 1, {{}}))
"""

READ_JAX = r"""
import os, sys, time, json
sys.path.insert(0, {root!r})
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from slice3d_tpu.train.checkpoint import restore_checkpoint
restore_checkpoint({path!r}, None)  # orbax's imports and first-use set-up
t0 = time.perf_counter()
tree = restore_checkpoint({path!r})
n = sum(np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(tree))
print(json.dumps({{"s": time.perf_counter() - t0, "bytes": n}}))
"""

READ_PORT = r"""
import sys, time, json, resource
sys.path.insert(0, {root!r})
import numpy as np
from slice3d_tpu_torch.train import zstd
from slice3d_tpu_torch.train.flax_msgpack import read_flax_checkpoint
zstd.load_library()
def leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from leaves(v)
    elif t is not None:
        yield t
rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
t0 = time.perf_counter()
tree = read_flax_checkpoint({path!r})
s = time.perf_counter() - t0
rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
n = sum(np.asarray(x).nbytes for x in leaves(tree))
print(json.dumps({{"s": s, "bytes": n, "peak_rss_above_start": (rss1 - rss0) * 1024}}))
"""


def run(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    return proc.stdout.strip().splitlines()[-1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--dir", default=None, help="where to write (default: a temporary dir)")
    args = ap.parse_args(argv)
    base = args.dir or tempfile.mkdtemp(prefix="orbax_read_")
    os.makedirs(base, exist_ok=True)
    try:
        path = run(WRITE.format(root=ROOT, out=base))
        stored = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(path)
                     for n in ns)
        jax_runs, port_runs = [], []
        for _ in range(args.repeat):
            jax_runs.append(json.loads(run(READ_JAX.format(root=ROOT, path=path))))
            port_runs.append(json.loads(run(READ_PORT.format(root=ROOT, path=path))))
            print(f"jax {jax_runs[-1]}  port {port_runs[-1]}", flush=True)
    finally:
        if args.dir is None:
            shutil.rmtree(base, ignore_errors=True)
    n = port_runs[0]["bytes"]
    out = {"device": "cpu", "cpus": os.cpu_count(), "stored_bytes": stored,
           "decoded_bytes": n, "jax_bytes": jax_runs[0]["bytes"],
           "jax_s": [r["s"] for r in jax_runs], "port_s": [r["s"] for r in port_runs],
           "port_mb_per_s": [n / r["s"] / 1e6 for r in port_runs],
           "port_peak_rss_above_start": [r["peak_rss_above_start"] for r in port_runs]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
