"""Benchmark-shape (T=1000) sequence parity vs the reference oracle.

The oracle crosschecks elsewhere run at T<=60; this pins the *benchmark*
configuration (T=1000, A1=5, beam=5, cut=0.1 — BASELINE.json) so a
regression that only shows up at depth (renormalization drift, id-log
overflow, traceback at scale) cannot ship.  bench.py and chip_smoke.py run
the same check as a hard gate on the GPU; this copy is CI-runnable on the
CPU mesh.
"""

import numpy as np

import oracle
from fast_ctc_decode_tpu.ops import beam_fast, beam_pallas


def _reads(B, T=1000, A1=5, seed=123):
    rng = np.random.RandomState(seed)
    probs = rng.rand(B, T, A1).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    return probs


def _seqs(out, B):
    res = []
    for i in range(B):
        assert int(out["err"][i]) == 0
        n = int(out["count"][i])
        labels_rev = np.asarray(out["labels_rev"][i])[:n]
        res.append("".join("NACGT"[int(l) + 1] for l in labels_rev[::-1]))
    return res


def test_t1000_parity_fast_engine():
    B, T = 8, 1000
    probs = _reads(B, T)
    out = beam_fast.beam_search_fast_batch(
        probs, np.full((B,), T, np.int32), np.float32(0.1), beam_size=5
    )
    got = _seqs(out, B)
    for i in range(B):
        want, _ = oracle.beam_search(probs[i], "NACGT", 5, 0.1)
        assert got[i] == want, i


def test_t1000_parity_pallas_engine():
    # interpret mode on CPU is slow, so fewer reads; chip_smoke.py's gate
    # covers the compiled kernel at 64 reads on the card
    B, T = 2, 1000
    probs = _reads(B, T, seed=321)
    out = beam_pallas.beam_search_pallas_batch(
        probs,
        np.full((B,), T, np.int32),
        np.float32(0.1),
        beam_size=5,
        interpret=True,
    )
    got = _seqs(out, B)
    for i in range(B):
        want, _ = oracle.beam_search(probs[i], "NACGT", 5, 0.1)
        assert got[i] == want, i
