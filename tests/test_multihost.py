"""True multi-process (N=2 "hosts") data-parallel decode test.

Spawns two Python processes, each owning 4 virtual CPU devices, connected
via jax.distributed (Gloo): each process feeds its local read shard with
``make_array_from_process_local_data``, decodes shard-locally, and the
``psum`` in decode_and_count must agree on the global counters across
processes — the reference has no distributed layer at all (SURVEY.md §2),
so this contract is authored fresh.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
# every child stays on the CPU: a GPU serves one JAX process
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

from fast_ctc_decode_tpu.parallel.mesh import (
    batch_sharding, distributed_init, make_data_mesh,
)
from fast_ctc_decode_tpu.parallel.pipeline import decode_and_count

distributed_init(f"127.0.0.1:{{port}}".format(port=port), nproc, pid)
assert jax.process_count() == nproc

mesh = make_data_mesh()
B, T, A1 = 16, 24, 5
rng = np.random.RandomState(0)
probs = rng.rand(B, T, A1).astype(np.float32)
probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
lengths = np.full((B,), T, np.int32)

sharding = batch_sharding(mesh)
lo, hi = pid * (B // nproc), (pid + 1) * (B // nproc)
probs_d = jax.make_array_from_process_local_data(
    sharding, probs[lo:hi], probs.shape
)
lengths_d = jax.make_array_from_process_local_data(
    sharding, lengths[lo:hi], lengths.shape
)

out, totals = decode_and_count(
    mesh, probs_d, lengths_d, beam_size=5, threshold=0.1, collapse=True
)
totals = jax.device_get(totals)
assert int(totals[0]) == B and int(totals[1]) == 0, totals
print("WORKER_OK", pid, totals.tolist(), jax.device_count())

# duplex through the cached shard_map wrapper over the same 2-process mesh
from jax.sharding import NamedSharding, PartitionSpec as P
from fast_ctc_decode_tpu.ops import duplex_fast
from fast_ctc_decode_tpu.parallel import pipeline

T1 = T2 = 12
env_full = np.zeros((T1, 2), np.int64); env_full[:, 1] = T2
ep = duplex_fast._prep_envelope_fast(env_full, T2)
n1 = rng.rand(B, T1, A1).astype(np.float32)
n1 /= np.linalg.norm(n1, ord=2, axis=-1, keepdims=True)
n2 = rng.rand(B, T2, A1).astype(np.float32)
n2 /= np.linalg.norm(n2, ord=2, axis=-1, keepdims=True)
with np.errstate(divide="ignore"):
    l1 = np.log(n1, dtype=np.float32); l2 = np.log(n2, dtype=np.float32)
rg = np.full((B, ep.Wr), -np.inf, np.float32)
rg[:, 0] = 0.0
rg[:, 1:] = np.cumsum(l2[:, : ep.Wr - 1, 0], axis=1)

def gput(x):
    return jax.make_array_from_process_local_data(sharding, x[lo:hi], x.shape)

rep = NamedSharding(mesh, P())

def rput(x):
    return jax.make_array_from_process_local_data(rep, x, x.shape)

fn = pipeline._duplex_fast_fn(
    mesh, 5, True, float(np.float32("-inf")), ep.W, ep.Wr, ep.Wext,
    bool(ep.needs_ext), False, bool(ep.static_window),
    bool(ep.rel_window and not ep.static_window), int(ep.D), True,
)
dout = fn(
    gput(l1), gput(l2), gput(rg),
    rput(ep.lo.astype(np.int32)), rput(ep.hi.astype(np.int32)),
    gput(np.zeros((B,), np.int32)), gput(np.full((B,), T1, np.int32)),
)
errs = np.concatenate(
    [np.asarray(s.data).ravel() for s in dout["err"].addressable_shards]
)
assert (errs == 0).all(), errs
print("DUPLEX_OK", pid)
"""


def test_two_process_decode_and_psum(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=repo))

    with socket.socket() as s:  # pick a free coordinator port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-2000:]}"
        assert f"WORKER_OK {i} [16, 0] 8" in out, out[-2000:]
        assert f"DUPLEX_OK {i}" in out, out[-2000:]
