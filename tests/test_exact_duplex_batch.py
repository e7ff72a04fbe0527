"""The batched bit-exact duplex tree engine (ops/duplex.py
``duplex_exact_batch``, reference band-reuse semantics) and the decoders
that route moving-window envelopes to it, against the NumPy oracle."""

import numpy as np
import pytest

import oracle
from duplex_helpers import diag_env, random_data
from fast_ctc_decode_tpu import beam_search_duplex
from fast_ctc_decode_tpu.ops import duplex as duplex_ops
from fast_ctc_decode_tpu import errors
from fast_ctc_decode_tpu.parallel.pipeline import (
    BatchCrfDuplexDecoder,
    BatchDuplexDecoder,
)


def _prep(n1, n2, env, B, thr_lin):
    T1 = n1.shape[1]
    T2 = n2.shape[1]
    l, h, W, Wr, needs_ext, Wext = duplex_ops._prep_envelope(env, T2)
    with np.errstate(divide="ignore"):
        l1 = np.log(n1, dtype=np.float32)
        l2 = np.log(n2, dtype=np.float32)
        thr = np.float32(np.log(np.float32(thr_lin)))
    rg = np.full((B, Wr), -np.inf, np.float32)
    for b in range(B):
        rg[b, 0] = 0.0
        rg[b, 1:Wr] = np.cumsum(l2[b, : Wr - 1, 0], dtype=np.float32)
    los = np.broadcast_to(l, (B, T1)).astype(np.int32)
    his = np.broadcast_to(h, (B, T1)).astype(np.int32)
    return l1, l2, rg, los, his, thr, W, Wr, Wext, needs_ext


def _seqs(out, B, alphabet="NACGT"):
    res = []
    for b in range(B):
        n = int(out["count"][b])
        labs = np.asarray(out["labels_rev"][b])[:n]
        res.append("".join(alphabet[int(x) + 1] for x in labs[::-1]))
    return res


def _exact(l1, l2, rg, los, his, thr, inits, lens, *, N, W, Wr, Wext, ne,
           crf=False, collapse=True):
    return duplex_ops.duplex_exact_batch(
        l1, l2, rg, los, his, thr, inits, lens,
        beam_size=5, collapse_repeats=collapse, max_nodes=N, W=W, Wr=Wr,
        Wext=Wext, needs_ext=ne, crf=crf,
    )


def test_moving_window_matches_exact_engine():
    T1, T2, B = 12, 14, 3
    env = diag_env(T1, T2, 3)
    n1 = np.stack([random_data(T1, 5, i) for i in range(B)])
    n2 = np.stack([random_data(T2, 5, 100 + i) for i in range(B)])
    l1, l2, rg, los, his, thr, W, Wr, Wext, ne = _prep(n1, n2, env, B, 0.0)
    lens = np.full((B,), T1, np.int32)
    inits = np.zeros((B,), np.int32)
    N = duplex_ops._duplex_max_nodes(T1, 5, 4, W)
    got = _exact(l1, l2, rg, los, his, thr, inits, lens,
                 N=N, W=W, Wr=Wr, Wext=Wext, ne=ne)
    assert list(np.asarray(got["err"])) == [0] * B
    # band-reuse semantics: the oracle agrees
    for b in range(B):
        want = oracle.beam_search_duplex(n1[b], n2[b], "NACGT", env, 5, 0.0)
        assert _seqs(got, B)[b] == want, b


def test_divergence_prone_case_reproduces_band_reuse():
    """On the weak-signal moving-window class where the slot-band fast
    engine measurably diverges from reference band reuse
    (test_duplex_engines.py), the batch decoder's automatic choice must
    side with the exact engine."""
    T1, T2 = 30, 34
    env = diag_env(T1, T2, 4)
    seeds = (25, 26)
    n1 = np.stack([random_data(T1, 4, s) for s in seeds])
    n2 = np.stack([random_data(T2, 4, 1000 + s) for s in seeds])
    res = BatchDuplexDecoder("NACG", T1=T1, T2=T2).decode(n1, n2, envelopes=env)
    diverged = 0
    for b in range(len(seeds)):
        e = beam_search_duplex(n1[b], n2[b], "NACG", envelope=env, engine="exact")
        f = beam_search_duplex(n1[b], n2[b], "NACG", envelope=env, engine="fast")
        assert res[b] == (e, 0), b
        diverged += f != e
    assert diverged > 0  # the case actually exercises band reuse


def test_crf_moving_window_matches_exact_engine():
    S, A1 = 16, 5
    T1, T2, B = 12, 14, 2
    env = diag_env(T1, T2, 3)

    def mk(T, seed):
        r = np.random.RandomState(seed)
        x = r.rand(T, S, A1).astype(np.float32)
        return x / x.sum(-1, keepdims=True)

    n1 = np.stack([mk(T1, 70 + i) for i in range(B)])
    n2 = np.stack([mk(T2, 170 + i) for i in range(B)])
    rng = np.random.RandomState(9)
    i1 = rng.rand(B, S).astype(np.float32)
    i2 = rng.rand(B, S).astype(np.float32)
    l, h, W, Wr, ne, Wext = duplex_ops._prep_envelope(env, T2)
    with np.errstate(divide="ignore"):
        l1 = np.log(n1, dtype=np.float32)
        l2 = np.log(n2, dtype=np.float32)
        thr = np.float32(-np.inf)
    rg = np.full((B, Wr), -np.inf, np.float32)
    for b in range(B):
        st = int(np.argmax(i2[b]))
        cur = np.float32(0.0)
        rg[b, 0] = cur
        for i in range(Wr - 1):
            cur = np.float32(cur + l2[b, i, st, 0])
            rg[b, i + 1] = cur
            st = (st * (A1 - 1)) % S
    los = np.broadcast_to(l, (B, T1)).astype(np.int32)
    his = np.broadcast_to(h, (B, T1)).astype(np.int32)
    lens = np.full((B,), T1, np.int32)
    inits = np.argmax(i1, axis=1).astype(np.int32)
    N = duplex_ops._duplex_max_nodes(T1, 5, A1 - 1, W)

    got = _exact(l1, l2, rg, los, his, thr, inits, lens, N=N, W=W, Wr=Wr,
                 Wext=Wext, ne=ne, crf=True, collapse=False)
    for b in range(B):
        want = oracle.crf_beam_search_duplex(
            n1[b], i1[b], n2[b], i2[b], "NACGT", env, beam_size=5
        )
        assert _seqs(got, B)[b] == want, b


def test_node_overflow_status_and_pipeline_fallback():
    T1, T2, B = 12, 14, 8
    env = diag_env(T1, T2, 3)
    n1 = np.stack([random_data(T1, 4, 40 + i) for i in range(B)])
    n2 = np.stack([random_data(T2, 4, 140 + i) for i in range(B)])
    l1, l2, rg, los, his, thr, W, Wr, Wext, ne = _prep(n1, n2, env, B, 0.0)
    lens = np.full((B,), T1, np.int32)
    inits = np.zeros((B,), np.int32)

    # a 4-node budget must blow and report per-read NODE_OVERFLOW
    out = _exact(l1, l2, rg, los, his, thr, inits, lens,
                 N=4, W=W, Wr=Wr, Wext=Wext, ne=ne)
    assert all(int(e) == errors.NODE_OVERFLOW for e in np.asarray(out["err"]))

    # the pipeline sizes the budget for the worst case: no overflow, and
    # every pair equals the oracle
    res = BatchDuplexDecoder("NACG", T1=T1, T2=T2, engine="exact").decode(
        n1, n2, envelopes=env
    )
    for b in range(B):
        want = oracle.beam_search_duplex(n1[b], n2[b], "NACG", env, 5, 0.0)
        assert res[b] == (want, 0), b


def test_engine_validation():
    for bad in ("bogus", "pallas", "exact-pallas"):
        with pytest.raises(ValueError, match="unknown engine"):
            BatchDuplexDecoder("NACG", T1=8, T2=8, engine=bad)
        with pytest.raises(ValueError, match="unknown engine"):
            BatchCrfDuplexDecoder("NACG", T1=8, T2=8, n_state=4, engine=bad)
    dec = BatchDuplexDecoder("NACG", T1=8, T2=8, beam_size=8, engine="exact")
    n1 = np.stack([random_data(8, 4, 1)])
    n2 = np.stack([random_data(8, 4, 2)])
    env = diag_env(8, 8, 2)
    res = dec.decode(n1, n2, envelopes=env)
    want = beam_search_duplex(n1[0], n2[0], "NACG", envelope=env,
                              beam_size=8, engine="exact")
    assert res[0] == (want, 0)


def test_zero_probability_step_keeps_beam():
    """A valid beam entry whose log score is exactly -inf (an all-zero
    probability step) must stay selectable: the reference keeps it in the
    beam (only the absence of a push empties a slot)."""
    T1, T2, B = 5, 6, 2
    env = diag_env(T1, T2, 2)
    n1 = np.stack([random_data(T1, 5, i) for i in range(B)])
    n2 = np.stack([random_data(T2, 5, 50 + i) for i in range(B)])
    n1[1, 2, :] = 0.0  # read 1 has one all-zero step
    l1, l2, rg, los, his, thr, W, Wr, Wext, ne = _prep(n1, n2, env, B, 0.0)
    lens = np.full((B,), T1, np.int32)
    inits = np.zeros((B,), np.int32)
    N = duplex_ops._duplex_max_nodes(T1, 5, 4, W)
    out = _exact(l1, l2, rg, los, his, thr, inits, lens,
                 N=N, W=W, Wr=Wr, Wext=Wext, ne=ne)
    assert np.asarray(out["err"]).tolist() == [0, 0]
    for b in range(B):
        want = oracle.beam_search_duplex(n1[b], n2[b], "NACGT", env, 5, 0.0)
        assert _seqs(out, B)[b] == want, b


def test_crf_duplex_auto_moving_window():
    """The CRF duplex decoder routes a moving window to the tree engine by
    itself, and that route equals the oracle."""
    S, A1, T1, T2, B = 8, 5, 10, 12, 2
    env = diag_env(T1, T2, 3)
    rng = np.random.RandomState(31)

    def mk(T):
        x = rng.rand(B, T, S, A1).astype(np.float32)
        return x / x.sum(-1, keepdims=True)

    n1, n2 = mk(T1), mk(T2)
    i1 = rng.rand(B, S).astype(np.float32)
    i2 = rng.rand(B, S).astype(np.float32)
    dec = BatchCrfDuplexDecoder("NACGT", T1=T1, T2=T2, n_state=S)
    res = dec.decode(n1, i1, n2, i2, envelopes=env)
    for b in range(B):
        want = oracle.crf_beam_search_duplex(
            n1[b], i1[b], n2[b], i2[b], "NACGT", env, beam_size=5
        )
        assert res[b] == (want, 0), b
