"""Data-parallel pipeline tests on the virtual 8-device CPU mesh:
batched decode parity vs the single-read API, explicit shard_map + psum
counters, ragged batching, and the driver entry points.
"""

import numpy as np
import pytest

import jax

from fast_ctc_decode_tpu import beam_search, viterbi_search
from fast_ctc_decode_tpu.parallel.mesh import batch_sharding, make_data_mesh
from fast_ctc_decode_tpu.parallel.pipeline import (
    BatchBeamDecoder,
    BatchViterbiDecoder,
    decode_and_count,
)
from fast_ctc_decode_tpu.utils.padding import bucket_reads, pad_batch


def random_batch(B, T, A1, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=-1, keepdims=True)


def test_devices_available():
    assert len(jax.devices()) == 8  # conftest forces 8 virtual CPU devices


def test_batch_beam_matches_single_read_fast_engine():
    # the default (fast) engine is sequence-exact; its path entries may
    # report later creation times for pruned-and-re-derived prefixes
    B, T, A1 = 16, 40, 5
    probs = random_batch(B, T, A1)
    dec = BatchBeamDecoder("NACGT", T=T, beam_size=5, beam_cut_threshold=0.1)
    assert dec.engine == "fast"
    results = dec.decode(probs, np.full((B,), T, np.int32))
    assert len(results) == B
    for i in range(B):
        seq, path, err = results[i]
        assert err == 0
        want_seq, _ = beam_search(probs[i], "NACGT", 5, 0.1)
        assert seq == want_seq
        assert len(path) == len(seq) and path == sorted(path)
        assert all(0 <= t < T for t in path)


def test_batch_beam_matches_single_read_exact_engine():
    B, T, A1 = 8, 40, 5
    probs = random_batch(B, T, A1)
    dec = BatchBeamDecoder(
        "NACGT", T=T, beam_size=5, beam_cut_threshold=0.1, engine="exact"
    )
    results = dec.decode(probs, np.full((B,), T, np.int32))
    for i in range(B):
        seq, path, err = results[i]
        assert err == 0
        want_seq, want_path = beam_search(probs[i], "NACGT", 5, 0.1)
        assert seq == want_seq
        assert path == want_path


def test_batch_beam_ragged_lengths():
    B, T, A1 = 8, 50, 5
    probs = random_batch(B, T, A1, seed=3)
    lengths = np.array([50, 37, 12, 50, 1, 25, 49, 8], np.int32)
    dec = BatchBeamDecoder("NACGT", T=T, beam_size=5, beam_cut_threshold=0.1)
    results = dec.decode(probs, lengths)
    for i in range(B):
        seq, path, err = results[i]
        assert err == 0
        want_seq, _ = beam_search(probs[i, : lengths[i]], "NACGT", 5, 0.1)
        assert seq == want_seq
        assert len(path) == len(seq) and path == sorted(path)
        assert all(0 <= t < int(lengths[i]) for t in path)


def test_batch_viterbi_matches_single_read():
    B, T, A1 = 16, 60, 5
    probs = random_batch(B, T, A1, seed=5)
    dec = BatchViterbiDecoder("NACGT", T=T)
    results = dec.decode(probs, np.full((B,), T, np.int32), qstring=True)
    for i in range(B):
        seq, path = results[i]
        want_seq, want_path = viterbi_search(probs[i], "NACGT", qstring=True)
        assert seq == want_seq
        assert path == want_path


def test_shard_map_psum_counters():
    mesh = make_data_mesh()
    B, T, A1 = 16, 24, 5
    probs = random_batch(B, T, A1, seed=7)
    lengths = np.full((B,), T, np.int32)
    sharding = batch_sharding(mesh)
    probs_d = jax.device_put(probs, sharding)
    lengths_d = jax.device_put(lengths, sharding)
    from fast_ctc_decode_tpu.ops.beam import default_max_nodes

    out, totals = decode_and_count(
        mesh,
        probs_d,
        lengths_d,
        beam_size=5,
        threshold=0.1,
        collapse=True,
        max_nodes=default_max_nodes(T, 5, A1 - 1),
    )
    totals = jax.device_get(totals)
    assert int(totals[0]) == B
    assert int(totals[1]) == 0


def test_pad_batch_and_buckets():
    rng = np.random.RandomState(0)
    reads = [rng.rand(t, 5).astype(np.float32) for t in (10, 33, 7, 64)]
    batch, lengths = pad_batch(reads)
    assert batch.shape == (4, 64, 5)
    assert list(lengths) == [10, 33, 7, 64]
    buckets = bucket_reads(reads, [16, 64])
    assert sorted(buckets[16]) == [0, 2]
    assert sorted(buckets[64]) == [1, 3]


def test_graft_entry_single():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn, static_argnames=())(*args)
    out = jax.device_get(out)
    assert all(int(e) == 0 for e in out["err"])


def test_graft_entry_multichip():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_wide_alphabet_both_engines():
    """The reference long-alphabet case (A1=12 — reference
    tests/test_decode.py:101-107 analog) must decode through
    BatchBeamDecoder on both the XLA engine and the fused Triton kernel
    (interpret mode here)."""
    import oracle

    rng = np.random.RandomState(11)
    B, T, A1 = 8, 30, 12
    probs = rng.rand(B, T, A1).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    lengths = np.full((B,), T, np.int32)
    alphabet = "NABCDEFGHIJK"

    want = [
        oracle.beam_search(probs[i], alphabet, 5, 0.0)[0] for i in range(B)
    ]
    for engine in ("fast", "pallas"):
        dec = BatchBeamDecoder(
            alphabet, T=T, beam_size=5, beam_cut_threshold=0.0, engine=engine,
            interpret=engine == "pallas",
        )
        res = dec.decode(probs, lengths)
        for i in range(B):
            seq, path, err = res[i]
            assert err == 0
            assert seq == want[i], (engine, i)
