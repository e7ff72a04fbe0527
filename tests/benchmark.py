"""Benchmark suite — the analog of the reference's tests/benchmark.py
(/root/reference/tests/benchmark.py): times each decoder entry point on the
README workload (L2-row-normalized random posteriors, alphabet NACGT,
beam_size=5, beam_cut_threshold=0.1) and, like the reference does for
third-party decoders, includes a pure-Python viterbi (argmax + groupby)
baseline for scale.  Where the reference times 10 single reads, this
engine's native unit is a batch, so batched reads/s is reported alongside
single-read latency.

It runs on an NVIDIA GPU only (it names the card and fails without one).
Every timed call ends in ``block_until_ready``, after a warm-up call.

Run: python tests/benchmark.py [--quick] [--full] [reads.npy]
  default: single-read latencies + batched 1D beam (the XLA scan engine,
           and the platform's own engine when it differs: the Triton
           kernel on the GPU)
  --full:  adds CRF beam and banded duplex (XLA slot-band engine, exact
           tree engine single + batched)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def python_viterbi(probs, alphabet="NACGT"):
    """The reference benchmark's python decoder (benchmark.py:8-13)."""
    from itertools import groupby

    path = np.argmax(probs, axis=1)
    return "".join(alphabet[b] for b, g in groupby(path) if b)


def timeit(fn, iters):
    """Seconds per call: one warm-up call, then ``iters`` calls, each
    ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn())  # warm/compile
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / iters


def norm_batch(B, T, A1, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=2, keepdims=True)


def diag_env(T1, T2, w):
    env = np.zeros((T1, 2), np.int64)
    for i in range(T1):
        c = int(i * T2 / T1)
        env[i, 0] = max(0, c - w)
        env[i, 1] = min(T2, c + w + 1)
    env[:, 0] = np.maximum.accumulate(env[:, 0])
    last = 0
    for i in range(T1):
        env[i, 0] = min(env[i, 0], last)
        env[i, 1] = max(env[i, 1], env[i, 0] + 1)
        last = max(last, env[i, 1])
    return env


def main():
    quick = "--quick" in sys.argv
    full = "--full" in sys.argv
    paths = [a for a in sys.argv[1:] if not a.startswith("-")]

    import jax

    from fast_ctc_decode_tpu import beam_search, device, viterbi_search
    from fast_ctc_decode_tpu.ops import beam_fast

    device.use_compile_cache()
    info = device.require_gpu()

    if paths:
        x = np.load(paths[0]).astype(np.float32)
    else:
        rng = np.random.RandomState(42)
        x = rng.rand(25 if quick else 1000, 5).astype(np.float32)
        x /= np.linalg.norm(x, ord=2, axis=1, keepdims=True)
    T, A1 = x.shape
    iters = 3 if quick else 10
    print(f"device: {info['kind']} x{info['count']} ({info['card']}), "
          f"read shape: {x.shape}")

    rows = []
    rows.append(("viterbi python argmax+groupby", timeit(lambda: python_viterbi(x), iters)))
    rows.append(("viterbi_search (this repo)", timeit(lambda: viterbi_search(x, "NACGT"), iters)))
    rows.append((
        "beam_search single read (exact engine)",
        timeit(lambda: beam_search(x, "NACGT", 5, 0.1), iters),
    ))
    rows.append((
        "beam_search single read (fast engine)",
        timeit(lambda: beam_search(x, "NACGT", 5, 0.1, engine="fast"), iters),
    ))

    print(f"{'decoder':46s} {'sec/read':>12s}")
    for name, sec in rows:
        print(f"{name:46s} {sec:12.6f}")

    # ---- batched 1D beam: the engine's native operating point ----
    B = 64 if quick else 4096
    xs_d = jax.device_put(norm_batch(B, T, A1, 7))
    ln_d = jax.device_put(np.full((B,), T, np.int32))

    dt = timeit(
        lambda: beam_fast.beam_search_fast_batch(
            xs_d, ln_d, np.float32(0.1), beam_size=5
        ),
        iters,
    )
    print(f"\n1D beam fast   x{B}: {B / dt:>12,.0f} reads/s")

    if device.beam_engine() == "pallas":
        from fast_ctc_decode_tpu.ops import beam_pallas

        dt = timeit(
            lambda: beam_pallas.beam_search_pallas_batch(
                xs_d, ln_d, np.float32(0.1), beam_size=5
            ),
            iters,
        )
        print(f"1D beam pallas x{B}: {B / dt:>12,.0f} reads/s")

    if not full:
        return

    # ---- CRF beam ----
    Bc, Tc, S = (32, 50, 8) if quick else (512, 400, 64)
    rng = np.random.RandomState(3)
    cp = rng.rand(Bc, Tc, S, A1).astype(np.float32)
    cp /= cp.sum(-1, keepdims=True)
    ci = rng.rand(Bc, S).astype(np.float32)
    cpd, cid = jax.device_put(cp), jax.device_put(ci)
    cld = jax.device_put(np.full((Bc,), Tc, np.int32))
    dt = timeit(
        lambda: beam_fast.crf_beam_search_fast_batch(
            cpd, cid, cld, np.float32(0.0), beam_size=5
        ),
        iters,
    )
    print(f"CRF beam fast   x{Bc} (S={S}): {Bc / dt:>10,.0f} reads/s")

    # ---- banded duplex ----
    from fast_ctc_decode_tpu import beam_search_duplex
    from fast_ctc_decode_tpu.ops import duplex, duplex_fast

    Bd, T1 = (16, 60) if quick else (256, 500)
    T2 = T1
    env = diag_env(T1, T2, 8 if quick else 40)
    ep = duplex_fast._prep_envelope_fast(env, T2)
    n1 = norm_batch(Bd, T1, A1, 11)
    n2 = norm_batch(Bd, T2, A1, 12)
    with np.errstate(divide="ignore"):
        l1 = np.log(n1).astype(np.float32)
        l2 = np.log(n2).astype(np.float32)
    rg = np.zeros((Bd, ep.Wr), np.float32)
    rg[:, 1:] = np.cumsum(l2[:, : ep.Wr - 1, 0], axis=1)
    a1d, a2d, rgd = (jax.device_put(v) for v in (l1, l2, rg))
    lod = jax.device_put(ep.lo.astype(np.int32))
    hid = jax.device_put(ep.hi.astype(np.int32))
    std = jax.device_put(np.zeros(Bd, np.int32))
    lnd = jax.device_put(np.full(Bd, T1, np.int32))

    dt = timeit(
        lambda: duplex_fast.duplex_fast_batch(
            a1d, a2d, rgd, lod, hid, np.float32(-np.inf), std, lnd,
            beam_size=5, collapse_repeats=True, W=ep.W, Wr=ep.Wr,
            Wext=ep.Wext, needs_ext=ep.needs_ext, crf=False,
            static_window=ep.static_window, rel_window=ep.rel_window,
            D=ep.D, shared_env=True,
        ),
        max(iters // 2, 2),
    )
    print(f"duplex banded fast(XLA) x{Bd} (W={ep.W}): {Bd / dt:>8,.0f} pairs/s")

    # exact tree engine: single pair + small batch
    dt = timeit(
        lambda: beam_search_duplex(
            n1[0], n2[0], "NACGT", envelope=env, engine="exact"
        ),
        max(iters // 3, 2),
    )
    print(f"duplex banded exact single pair: {dt:.3f} s/pair")
    Be = min(Bd, 32)
    lo_, hi_, We, Wre, ne, Wxe = duplex._prep_envelope(env, T2)
    N = duplex._duplex_max_nodes(T1, 5, A1 - 1, We)
    lob = np.tile(lo_, (Be, 1))
    hib = np.tile(hi_, (Be, 1))
    dt = timeit(
        lambda: duplex.duplex_exact_batch(
            a1d[:Be], a2d[:Be], rgd[:Be],
            lob, hib, np.float32(-np.inf),
            np.zeros(Be, np.int32), np.full(Be, T1, np.int32),
            beam_size=5, collapse_repeats=True, max_nodes=N, W=We, Wr=Wre,
            Wext=Wxe, needs_ext=ne, crf=False,
        ),
        2,
    )
    print(f"duplex banded exact batched x{Be}: {Be / dt:>8,.1f} pairs/s")


if __name__ == "__main__":
    main()
