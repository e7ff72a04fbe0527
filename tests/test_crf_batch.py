"""Batched CRF beam search (the XLA scan engine, ops/beam_fast.py, which
serves every CRF batch) against the NumPy oracle of the reference
crf_beam_search: sequences must be equal read by read."""

import numpy as np
import pytest

import oracle
from fast_ctc_decode_tpu.ops import beam_fast
from fast_ctc_decode_tpu.parallel.pipeline import BatchCrfBeamDecoder


def _inputs(seed, B, T, S, A1):
    rng = np.random.RandomState(seed)
    probs = rng.rand(B, T, S, A1).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    inits = rng.rand(B, S).astype(np.float32)
    return probs, inits


def _assert_oracle(out, probs, inits, lens, thr, K, alphabet):
    for b in range(len(lens)):
        assert int(out["err"][b]) == 0, b
        n = int(out["count"][b])
        labs = np.asarray(out["labels_rev"][b])[:n][::-1]
        got = "".join(alphabet[int(l) + 1] for l in labs)
        want, _ = oracle.crf_beam_search(
            probs[b, : lens[b]], inits[b], alphabet, K, thr
        )
        assert got == want, b


class TestCrfBatchOracle:
    @pytest.mark.parametrize("S,thr", [(8, 0.02), (64, 0.0), (16, 0.0)])
    def test_fast_engine_vs_oracle(self, S, thr):
        B, T, A1, K = 3, 20, 5, 5
        probs, inits = _inputs(S, B, T, S, A1)
        lens = np.array([T, T - 5, T], np.int32)
        out = beam_fast.crf_beam_search_fast_batch(
            probs, inits, lens, np.float32(thr), beam_size=K
        )
        _assert_oracle(out, probs, inits, lens, thr, K, "NACGT")

    def test_small_alphabet_wide_beam(self):
        B, T, S, A1, K = 2, 16, 4, 3, 8
        probs, inits = _inputs(7, B, T, S, A1)
        lens = np.full((B,), T, np.int32)
        out = beam_fast.crf_beam_search_fast_batch(
            probs, inits, lens, np.float32(0.0), beam_size=K
        )
        _assert_oracle(out, probs, inits, lens, 0.0, K, "NAC")

    def test_batch_decoder_auto_engine(self):
        B, T, S, A1 = 8, 18, 8, 5
        probs, inits = _inputs(9, B, T, S, A1)
        lens = np.full((B,), T, np.int32)
        dec = BatchCrfBeamDecoder("NACGT", T=T, n_state=S)
        assert dec.engine == "fast"
        for b, (seq, _, err) in enumerate(dec.decode(probs, inits, lens)):
            assert err == 0
            want, _ = oracle.crf_beam_search(probs[b], inits[b], "NACGT", 5, 0.0)
            assert seq == want, b
        with pytest.raises(ValueError, match="unknown engine"):
            BatchCrfBeamDecoder("NACGT", T=T, n_state=S, engine="pallas")


class TestNonPow2States:
    def test_s9_matches_oracle(self):
        # S=9 (3-base CRF): a non-power-of-two state count
        B, T, S, A1, K = 2, 14, 9, 4, 5
        probs, inits = _inputs(11, B, T, S, A1)
        lens = np.full((B,), T, np.int32)
        out = beam_fast.crf_beam_search_fast_batch(
            probs, inits, lens, np.float32(0.0), beam_size=K
        )
        _assert_oracle(out, probs, inits, lens, 0.0, K, "NACG")
