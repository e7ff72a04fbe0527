"""Batched duplex decode through ``BatchDuplexDecoder``'s automatic engine
choice (the XLA slot-band engine for constant windows, the XLA tree engine
for moving ones) against the NumPy oracle of the reference
beam_search_duplex, pair by pair, across envelope shapes."""

import numpy as np
import pytest

import oracle
from duplex_helpers import diag_env, random_data
from fast_ctc_decode_tpu import beam_search_duplex, errors
from fast_ctc_decode_tpu.parallel.pipeline import BatchDuplexDecoder

ALPHA = {4: "NACG", 3: "NAC", 5: "NACGT"}


def full_env(T1, T2):
    env = np.zeros((T1, 2), np.int64)
    env[:, 1] = T2
    return env


def run_vs_oracle(n1, n2, env, K=5, thr=0.0, collapse=True, lengths=None):
    """Returns ([(seq, err)] decoded, [(seq, 0)] oracle) for a batch."""
    B, T1, A1 = n1.shape
    T2 = n2.shape[1]
    alphabet = ALPHA[A1]
    dec = BatchDuplexDecoder(
        alphabet, T1=T1, T2=T2, beam_size=K, beam_cut_threshold=thr,
        collapse_repeats=collapse,
    )
    got = dec.decode(n1, n2, envelopes=env, lengths=lengths)
    if lengths is None:
        lengths = np.full((B,), T1, np.int32)
    want = [
        (
            oracle.beam_search_duplex(
                n1[b, : lengths[b]], n2[b], alphabet, env[: lengths[b]], K,
                thr, collapse,
            ),
            errors.OK,
        )
        for b in range(B)
    ]
    return got, want


class TestDuplexBatchOracle:
    @pytest.mark.parametrize("seed", range(3))
    def test_banded_diag(self, seed):
        T1, T2 = 16, 18
        n1 = np.stack([random_data(T1, 4, seed * 10 + i) for i in range(3)])
        n2 = np.stack(
            [random_data(T2, 4, 500 + seed * 10 + i) for i in range(3)]
        )
        got, want = run_vs_oracle(n1, n2, diag_env(T1, T2, 3))
        assert got == want

    def test_banded_with_threshold(self):
        T1, T2 = 14, 16
        n1 = np.stack([random_data(T1, 4, 70 + i) for i in range(2)])
        n2 = np.stack([random_data(T2, 4, 80 + i) for i in range(2)])
        got, want = run_vs_oracle(n1, n2, diag_env(T1, T2, 4), thr=0.1)
        assert got == want

    def test_collapse_off(self):
        T1, T2 = 12, 12
        n1 = random_data(T1, 4, 90)[None]
        n2 = random_data(T2, 4, 91)[None]
        got, want = run_vs_oracle(
            n1, n2, diag_env(T1, T2, 3), collapse=False
        )
        assert got == want

    def test_full_range(self):
        T1, T2 = 10, 11
        n1 = random_data(T1, 4, 95)[None]
        n2 = random_data(T2, 4, 96)[None]
        got, want = run_vs_oracle(n1, n2, full_env(T1, T2))
        assert got == want

    def test_ragged_lengths(self):
        T1, T2 = 14, 15
        n1 = np.stack([random_data(T1, 4, 100 + i) for i in range(2)])
        n2 = np.stack([random_data(T2, 4, 110 + i) for i in range(2)])
        lengths = np.array([T1, T1 - 5], np.int32)
        got, want = run_vs_oracle(
            n1, n2, diag_env(T1, T2, 3), lengths=lengths
        )
        assert got == want

    def test_wider_beam_small_alphabet(self):
        T1, T2 = 12, 13
        n1 = random_data(T1, 3, 120)[None]
        n2 = random_data(T2, 3, 121)[None]
        got, want = run_vs_oracle(n1, n2, diag_env(T1, T2, 3), K=8)
        assert got == want

    def test_invalid_envelope_status(self):
        T1, T2 = 10, 10
        n1 = random_data(T1, 4, 130)[None]
        n2 = random_data(T2, 4, 131)[None]
        env = diag_env(T1, T2, 2)
        env[6, 0] = env[6, 1]  # lower >= upper mid-decode
        dec = BatchDuplexDecoder("NACG", T1=T1, T2=T2)
        ((seq, err),) = dec.decode(n1, n2, envelopes=env)
        assert (seq, err) == ("", errors.INVALID_ENVELOPE)
        # the single-read API raises the reference's error for it
        with pytest.raises(RuntimeError, match="Invalid envelope"):
            beam_search_duplex(n1[0], n2[0], "NACG", envelope=env)

    def test_zero_probability_rows_survive(self):
        # -inf log scores are legitimate hypotheses (explicit validity)
        T1, T2 = 10, 11
        n1 = random_data(T1, 4, 140)
        n1[4, :] = 0.0
        n2 = random_data(T2, 4, 141)
        got, want = run_vs_oracle(n1[None], n2[None], diag_env(T1, T2, 4))
        assert got == want


class TestDippingUpperBound:
    def test_hi_dips_then_recovers(self):
        # a dipping upper bound must re-extend from the dipped value
        T1, T2 = 12, 12
        env = np.zeros((T1, 2), np.int64)
        env[:, 0] = [0, 0, 1, 2, 2, 3, 3, 4, 5, 6, 6, 7]
        env[:, 1] = [4, 6, 8, 8, 6, 6, 9, 10, 11, 12, 12, 12]
        n1 = random_data(T1, 4, 77)[None]
        n2 = random_data(T2, 4, 78)[None]
        got, want = run_vs_oracle(n1, n2, env)
        assert got == want
