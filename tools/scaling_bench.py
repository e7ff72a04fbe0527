"""Data-parallel scaling harness: reads/s + efficiency at 1 device /
1 host x N devices / N hosts.

The decode workload has no cross-read state — the only collective in the
framework is the psum of decode counters — so data-parallel scaling is
linear by construction; this harness *measures* it instead of asserting it.

Modes:

  python tools/scaling_bench.py devices [--reads-per-dev 256] [--T 1000]
      Weak-scaling sweep over single-process mesh sizes (1, 2, 4, ...
      GPUs of one host; one process drives them all).  Needs a GPU.

  python tools/scaling_bench.py overhead [--reads-per-dev 32768]
      The same batch decoded unsharded on one device and through the
      mesh + shard_map + psum machinery.  Needs a GPU.

  python tools/scaling_bench.py hosts [--nproc 2]
      A CPU rehearsal of the multi-process wiring (jax.distributed over
      Gloo): each "host" is a child process forced to the CPU with 4
      virtual devices and its read shard, decodes locally, psums the
      global counters, and reports the max per-host wall time.  The
      children stay on the CPU because a GPU serves one JAX process.

Each mode prints one JSON line per configuration, naming its device:
  {"mode": ..., "n": ..., "reads": ..., "reads_per_s": ..., "efficiency": ...}
Every timed call ends in ``block_until_ready`` after a warm-up call.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rand_reads(B, T, A1, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=2, keepdims=True)


def _timed(fn, reps):
    """Seconds per call after a warm-up call; each call ends in
    block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps


def bench_devices(reads_per_dev: int, T: int, reps: int = 5, engine=None):
    import numpy as np
    import jax

    from fast_ctc_decode_tpu import device

    info = device.require_gpu()
    from jax.sharding import Mesh
    from fast_ctc_decode_tpu.parallel.mesh import DATA_AXIS
    from fast_ctc_decode_tpu.parallel.pipeline import BatchBeamDecoder

    devs = jax.devices()
    sizes = [n for n in (1, 2, 4, 8, 16) if n <= len(devs)]
    base = None
    rows = []
    for n in sizes:
        mesh = Mesh(np.array(devs[:n]), (DATA_AXIS,))
        B = reads_per_dev * n
        probs = _rand_reads(B, T, 5, seed=n)
        lengths = np.full((B,), T, np.int32)
        dec = BatchBeamDecoder(
            "NACGT", T=T, beam_size=5, beam_cut_threshold=0.1, mesh=mesh,
            engine=engine,
        )
        pd = jax.device_put(probs, dec._sharding)
        ld = jax.device_put(lengths, dec._sharding)
        rps = B / _timed(lambda: dec.decode_arrays(pd, ld), reps)
        if base is None:
            base = rps / n
        row = {
            "mode": "devices",
            "n": n,
            "reads": B,
            "reads_per_s": round(rps, 1),
            "efficiency": round(rps / (n * base), 4),
            "engine": dec.engine,
            "device": info,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


_HOST_WORKER = r"""
import os, sys, time, json
sys.path.insert(0, __REPO__)
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
B_per = int(sys.argv[4]); T = int(sys.argv[5])
import numpy as np
import jax
# every child stays on the CPU: a GPU serves one JAX process
jax.config.update("jax_platforms", "cpu")
from fast_ctc_decode_tpu.parallel.mesh import (
    batch_sharding, distributed_init, make_data_mesh,
)
from fast_ctc_decode_tpu.parallel.pipeline import decode_and_count
if nproc > 1:
    distributed_init("127.0.0.1:%s" % port, nproc, pid)
mesh = make_data_mesh()
B = B_per * nproc
rng = np.random.RandomState(0)
probs = rng.rand(B, T, 5).astype(np.float32)
probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
lengths = np.full((B,), T, np.int32)
sh = batch_sharding(mesh)
lo, hi = pid * B_per, (pid + 1) * B_per
probs_d = jax.make_array_from_process_local_data(sh, probs[lo:hi], probs.shape)
lengths_d = jax.make_array_from_process_local_data(sh, lengths[lo:hi], lengths.shape)
out, totals = decode_and_count(mesh, probs_d, lengths_d, beam_size=5,
                               threshold=0.1, collapse=True)
jax.block_until_ready(totals)  # compile + warm
t0 = time.perf_counter()
REPS = 3
for _ in range(REPS):
    out, totals = decode_and_count(mesh, probs_d, lengths_d, beam_size=5,
                                   threshold=0.1, collapse=True)
totals = jax.device_get(totals)
dt = (time.perf_counter() - t0) / REPS
assert int(totals[0]) == B, totals
print("WORKER_RESULT", json.dumps({"pid": pid, "dt": dt, "B": B}), flush=True)
"""


def bench_hosts(nproc: int, reads_per_host: int = 64, T: int = 200):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rows = []
    base = None
    for n in [1, nproc] if nproc > 1 else [1]:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        import tempfile

        worker = os.path.join(tempfile.mkdtemp(), "worker.py")
        with open(worker, "w") as f:
            f.write(_HOST_WORKER.replace("__REPO__", repr(repo)))
        # children are forced to the CPU (one JAX process per card)
        env = {
            k: v
            for k, v in os.environ.items()
            if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
        }
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(i), str(n), str(port),
                 str(reads_per_host), str(T)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env,
            )
            for i in range(n)
        ]
        dts = []
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=600)
            assert p.returncode == 0, f"worker {i}:\n{out[-2000:]}"
            for line in out.splitlines():
                if line.startswith("WORKER_RESULT"):
                    dts.append(json.loads(line.split(" ", 1)[1])["dt"])
        dt = max(dts)  # global step time = slowest host
        B = reads_per_host * n
        rps = B / dt
        if base is None:
            base = rps / n
        row = {
            "mode": "hosts",
            "n": n,
            "reads": B,
            "reads_per_s": round(rps, 1),
            "efficiency": round(rps / (n * base), 4),
            "device": {"platform": "cpu", "count": 4 * n},
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def bench_overhead(reads_per_dev: int, T: int, reps: int = 5, engine=None):
    """Sharding/collective overhead on the real device(s): the same batch
    decoded (a) unsharded on one device and (b) through the mesh +
    shard_map + psum machinery.  The ratio is the per-card efficiency a
    multi-card mesh retains (reads never communicate; only the 8-byte
    counter psum crosses cards)."""
    import numpy as np
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from fast_ctc_decode_tpu import device
    from fast_ctc_decode_tpu.ops import beam_fast, beam_pallas
    from fast_ctc_decode_tpu.parallel.mesh import make_data_mesh
    from fast_ctc_decode_tpu.parallel.pipeline import decode_and_count

    info = device.require_gpu()
    engine = engine or device.beam_engine()
    plain = {
        "pallas": beam_pallas.beam_search_pallas_batch,
        "fast": beam_fast.beam_search_fast_batch,
    }[engine]
    B = reads_per_dev
    probs = _rand_reads(B, T, 5)
    lengths = np.full((B,), T, np.int32)
    pd = jax.device_put(probs, jax.devices()[0])
    ld = jax.device_put(lengths, jax.devices()[0])
    rps_plain = B / _timed(
        lambda: plain(pd, ld, np.float32(0.1), beam_size=5), reps
    )

    mesh = make_data_mesh()
    # re-place the inputs sharded over the mesh (with >1 device, the
    # single-device copies above are incompatible with shard_map)
    sh = NamedSharding(mesh, PartitionSpec("data"))
    pd = jax.device_put(probs, sh)
    ld = jax.device_put(lengths, sh)
    rps_shard = B / _timed(
        lambda: decode_and_count(
            mesh, pd, ld, beam_size=5, threshold=0.1, collapse=True,
            engine=engine,
        ),
        reps,
    )
    row = {
        "mode": "overhead",
        "n": len(mesh.devices.reshape(-1)),
        "reads": B,
        "engine": engine,
        "reads_per_s_plain": round(rps_plain, 1),
        "reads_per_s_sharded_psum": round(rps_shard, 1),
        "efficiency": round(rps_shard / rps_plain, 4),
        "device": info,
    }
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["devices", "hosts", "overhead"])
    ap.add_argument("--reads-per-dev", type=int, default=256)
    ap.add_argument("--reads-per-host", type=int, default=64)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument(
        "--engine", choices=["fast", "pallas"], default=None,
        help="decode engine (devices/overhead modes); default: the "
        "platform's (device.beam_engine)",
    )
    args = ap.parse_args()
    if args.mode != "hosts":
        from fast_ctc_decode_tpu.device import use_compile_cache

        use_compile_cache()
    if args.mode == "devices":
        bench_devices(args.reads_per_dev, args.T, engine=args.engine)
    elif args.mode == "overhead":
        bench_overhead(args.reads_per_dev, args.T, engine=args.engine)
    else:
        bench_hosts(args.nproc, args.reads_per_host, args.T)


if __name__ == "__main__":
    main()
