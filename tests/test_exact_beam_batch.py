"""The bit-exact XLA tree engines (ops/beam.py, ops/crf.py) in their
batched forms against the NumPy oracle of the reference: sequences AND
paths (emit-time semantics, node-id tie-breaks) and error codes."""

import numpy as np
import jax
import pytest

import oracle
from fast_ctc_decode_tpu import errors
from fast_ctc_decode_tpu.ops import beam as beam_exact
from fast_ctc_decode_tpu.ops import crf as crf_ops

_ORACLE_ERR = {
    "Failed to compare": errors.INCOMPARABLE_VALUES,
    "Ran out of search space": errors.RAN_OUT_OF_BEAM,
}


def _oracle(fn, *args):
    """(seq, path, err) of an oracle call, its raise mapped to a code."""
    try:
        seq, path = fn(*args)
    except RuntimeError as exc:
        code = [c for m, c in _ORACLE_ERR.items() if m in str(exc)]
        return "", [], code[0]
    return seq, list(path), errors.OK


def _decoded(out, b, alphabet="NACGT"):
    err = int(out["err"][b])
    if err != errors.OK:
        return "", [], err
    n = int(out["count"][b])
    labs = list(out["labels_rev"][b][:n])[::-1]
    times = [int(t) for t in list(out["times_rev"][b][:n])[::-1]]
    return "".join(alphabet[int(l) + 1] for l in labs), times, err


def _batch(x, lens, thr, beam_size=5, collapse=True, max_nodes=None):
    B, T, A1 = x.shape
    N = max_nodes or beam_exact.default_max_nodes(T, beam_size, A1 - 1)
    return jax.device_get(
        beam_exact.beam_search_device_batch(
            x, lens, np.float32(thr), beam_size=beam_size,
            collapse_repeats=collapse, max_nodes=N,
        )
    )


def _assert_oracle(x, lens, thr, collapse=True):
    out = _batch(x, lens, thr, collapse=collapse)
    for b in range(len(lens)):
        want = _oracle(
            oracle.beam_search, x[b, : lens[b]], "NACGT", 5, thr, collapse
        )
        assert _decoded(out, b) == want, (b, thr)


@pytest.mark.parametrize("collapse", [True, False])
@pytest.mark.parametrize("thr", [0.0, 0.1])
def test_random_parity(collapse, thr):
    rng = np.random.RandomState(11)
    for T in (1, 3, 24, 60):
        B = 4
        x = rng.rand(B, T, 5).astype(np.float32)
        x /= np.linalg.norm(x, axis=2, keepdims=True)
        lens = rng.randint(1, T + 1, size=B).astype(np.int32)
        _assert_oracle(x, lens, thr, collapse)


def test_tie_heavy_and_uniform():
    rng = np.random.RandomState(3)
    B, T = 4, 40
    x = (rng.rand(B, T, 5) > 0.5).astype(np.float32) * 0.9 + 0.05
    lens = np.full(B, T, np.int32)
    _assert_oracle(x, lens, 0.0)
    # threshold prunes every candidate -> RanOutOfBeam parity
    _assert_oracle(np.full((B, T, 5), 0.05, np.float32), lens, 0.1)


def test_nan_parity():
    rng = np.random.RandomState(5)
    B, T = 3, 16
    x = rng.rand(B, T, 5).astype(np.float32)
    x[0, 4, 2] = np.nan
    x[1, 0, 0] = np.nan
    lens = np.full(B, T, np.int32)
    _assert_oracle(x, lens, 0.0)
    assert int(_batch(x, lens, 0.0)["err"][0]) == errors.INCOMPARABLE_VALUES


def test_overflow_flag():
    rng = np.random.RandomState(9)
    B, T = 2, 40
    x = rng.rand(B, T, 5).astype(np.float32)
    lens = np.full(B, T, np.int32)
    out = _batch(x, lens, 0.0, max_nodes=8)
    assert all(int(e) == errors.NODE_OVERFLOW for e in out["err"])


def test_crf_random_parity():
    rng = np.random.RandomState(17)
    for T, S in ((1, 4), (12, 16), (30, 8)):
        B = 3
        x = rng.rand(B, T, S, 5).astype(np.float32)
        x /= x.sum(axis=-1, keepdims=True)
        init = rng.rand(B, S).astype(np.float32)
        init /= init.sum(axis=1, keepdims=True)
        lens = rng.randint(1, T + 1, size=B).astype(np.int32)
        N = beam_exact.default_max_nodes(T, 5, 4)
        out = jax.device_get(
            jax.vmap(
                lambda p, s, l: crf_ops.crf_beam_search_device(
                    p, s, l, np.float32(0.0), beam_size=5, max_nodes=N
                )
            )(x, init, lens)
        )
        for b in range(B):
            want = _oracle(
                oracle.crf_beam_search, x[b, : lens[b]], init[b], "NACGT", 5,
                0.0,
            )
            assert _decoded(out, b) == want, (T, S, b)


def test_crf_batch_decoder_exact_engine():
    """BatchCrfBeamDecoder(engine='exact') equals the oracle in sequence
    and path."""
    from fast_ctc_decode_tpu.parallel.pipeline import BatchCrfBeamDecoder

    rng = np.random.RandomState(21)
    B, T, S = 8, 14, 8  # multiple of the 8-device test mesh
    x = rng.rand(B, T, S, 5).astype(np.float32)
    x /= x.sum(axis=-1, keepdims=True)
    init = rng.rand(B, S).astype(np.float32)
    init /= init.sum(axis=1, keepdims=True)
    lens = np.full(B, T, np.int32)
    dec = BatchCrfBeamDecoder(
        "NACGT", T=T, n_state=S, beam_size=5, engine="exact"
    )
    for b, res in enumerate(dec.decode(x, init, lens)):
        want = _oracle(oracle.crf_beam_search, x[b], init[b], "NACGT", 5, 0.0)
        assert res == want, b


def test_pipeline_overflow_fallback():
    """BatchBeamDecoder(engine='exact') runs the XLA tree engine with the
    true worst-case node budget: complete, oracle-equal results in
    sequence and path."""
    from fast_ctc_decode_tpu.parallel.pipeline import BatchBeamDecoder

    rng = np.random.RandomState(2)
    B, T = 8, 24
    x = rng.rand(B, T, 5).astype(np.float32)
    x /= np.linalg.norm(x, axis=2, keepdims=True)
    lens = np.full(B, T, np.int32)
    dec = BatchBeamDecoder(
        "NACGT", T=T, beam_size=5, beam_cut_threshold=0.1, engine="exact"
    )
    assert dec.max_nodes == beam_exact.default_max_nodes(T, 5, 4)
    for b, res in enumerate(dec.decode(x, lens)):
        assert res == _oracle(oracle.beam_search, x[b], "NACGT", 5, 0.1), b
