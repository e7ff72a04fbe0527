"""Benchmark: batched 1D CTC prefix beam search reads/s on one NVIDIA GPU.

Configuration: T=1000 x 5-label posteriors, beam_size=5,
beam_cut_threshold=0.1, B=32768 reads per batch, exact sequence parity vs
the reference beam_search (tests/oracle.py, hard gate on sampled reads).
Runs the platform's batched engine (``device.beam_engine``: the fused
Triton kernel, ops/beam_pallas.py); BENCH_ENGINE=fast selects the XLA scan
engine.  It fails when JAX finds no GPU.

Prints ONE JSON line: {"metric", "value", "unit", "engine", "device"},
where "device" holds JAX's platform, device_kind and device count and
nvidia-smi's card name and power limit.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    import jax

    from fast_ctc_decode_tpu import device
    from fast_ctc_decode_tpu.ops import beam_fast, beam_pallas

    device.use_compile_cache()
    info = device.require_gpu()
    engine = os.environ.get("BENCH_ENGINE", device.beam_engine())
    B = int(os.environ.get("BENCH_BATCH", "32768"))
    T = int(os.environ.get("BENCH_T", "1000"))
    A1 = 5
    beam_size = 5
    threshold = np.float32(0.1)

    rng = np.random.RandomState(42)
    probs = rng.rand(B, T, A1).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    lengths = np.full((B,), T, np.int32)

    dev = jax.devices()[0]
    probs_d = jax.device_put(probs, dev)
    lengths_d = jax.device_put(lengths, dev)

    decode = {
        "pallas": beam_pallas.beam_search_pallas_batch,
        "fast": beam_fast.beam_search_fast_batch,
    }[engine]

    def run():
        return jax.block_until_ready(
            decode(probs_d, lengths_d, threshold, beam_size=beam_size)
        )

    out = run()  # compile + warm
    assert not np.asarray(out["err"]).any(), "decode errors in bench"

    # correctness gate vs the sequential reference-semantics oracle: the
    # bench result is meaningless without sequence parity, so this is a
    # hard failure (no silent skip), sampled across the batch
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    import oracle

    n_check = int(os.environ.get("BENCH_PARITY_READS", "8"))
    for i in np.linspace(0, B - 1, n_check).astype(int):
        n = int(out["count"][i])
        labels_rev = np.asarray(out["labels_rev"][i])[:n]
        seq = "".join("NACGT"[int(l) + 1] for l in labels_rev[::-1])
        want, _ = oracle.beam_search(probs[i], "NACGT", beam_size, 0.1)
        assert seq == want, f"read {i}: {seq!r} != oracle {want!r}"

    iters = int(os.environ.get("BENCH_ITERS", "5"))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))

    print(
        json.dumps(
            {
                "metric": "beam_search_reads_per_sec_per_chip",
                "value": round(B / dt, 1),
                "unit": "reads/s",
                "engine": engine,
                "device": info,
            }
        )
    )


if __name__ == "__main__":
    main()
