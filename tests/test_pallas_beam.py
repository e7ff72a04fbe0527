"""The fused Triton beam kernels (ops/beam_pallas.py) must be bit-identical
to the XLA scan engine (ops/beam_fast.py) — same hashes, same merge, same
selection, same errors.  On the CPU they run in interpret mode, so shapes
stay small; ``test_lower_for_cuda_at_benchmark_widths`` lowers them for the
GPU's Triton route from this host at the benchmark widths, and the
``gpu``-marked test runs them on the card.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fast_ctc_decode_tpu import errors
from fast_ctc_decode_tpu.ops import beam_fast, beam_pallas


def rand_batch(B, T, A1, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=-1, keepdims=True)


def run_both(probs, lengths, thr, beam_size=5, collapse=True, **pk):
    ref = beam_fast.beam_search_fast_batch(
        probs, lengths, np.float32(thr),
        beam_size=beam_size, collapse_repeats=collapse,
    )
    got = beam_pallas.beam_search_pallas_batch(
        probs, lengths, np.float32(thr),
        beam_size=beam_size, collapse_repeats=collapse,
        interpret=pk.pop("interpret", True), **pk,
    )
    return ref, got


def assert_same(ref, got):
    for k in ("labels_rev", "times_rev", "count", "err"):
        assert np.array_equal(np.asarray(ref[k]), np.asarray(got[k])), k


class TestPallasBitParity:
    def test_ragged_batch(self):
        probs = rand_batch(4, 40, 5, seed=1)
        lengths = np.array([40, 23, 7, 40], np.int32)
        assert_same(*run_both(probs, lengths, 0.1))

    def test_block_boundaries(self):
        # B not a multiple of block_b: padded reads are length 0
        probs = rand_batch(3, 37, 5, seed=2)
        lengths = np.full((3,), 37, np.int32)
        assert_same(*run_both(probs, lengths, 0.1, block_b=2))

    def test_collapse_off_and_thr0(self):
        probs = rand_batch(2, 30, 4, seed=3)
        lengths = np.full((2,), 30, np.int32)
        assert_same(*run_both(probs, lengths, 0.0, beam_size=3, collapse=False))

    def test_nan_and_empty_beam_errors(self):
        probs = rand_batch(3, 20, 5, seed=4)
        probs[1, 5, 2] = np.nan
        probs[2] = 0.01  # all under the cut
        lengths = np.full((3,), 20, np.int32)
        ref, got = run_both(probs, lengths, 0.19)
        assert_same(ref, got)
        errs = np.asarray(got["err"])
        assert errs[1] == errors.INCOMPARABLE_VALUES
        assert errs[2] == errors.RAN_OUT_OF_BEAM


@pytest.mark.parametrize("beam_size", [1, 5, 8])
def test_pallas_wide_beams(beam_size):
    probs = rand_batch(3, 30, 5, seed=5)
    lengths = np.array([30, 17, 0], np.int32)
    assert_same(*run_both(probs, lengths, 0.0, beam_size=beam_size))


def test_id_log_matches_scan_engine():
    """The raw kernel outputs: the [T, K, B] entry-tip id log and the final
    head id equal the scan engine's [T, B, K] log and carry."""
    probs = rand_batch(5, 25, 5, seed=6)
    lengths = np.array([25, 25, 9, 1, 25], np.int32)
    raw = beam_pallas.beam_search_pallas_batch(
        probs, lengths, np.float32(0.05), beam_size=4, interpret=True,
        raw=True,
    )
    ref = beam_fast.beam_search_fast_batch(
        probs, lengths, np.float32(0.05), beam_size=4, raw=True
    )
    assert np.array_equal(
        np.asarray(raw["ids_log"]),
        np.transpose(np.asarray(ref["ids_log"]), (0, 2, 1)),
    )
    assert np.array_equal(np.asarray(raw["fin"]), np.asarray(ref["fin"]))
    assert np.array_equal(np.asarray(raw["err"]), np.asarray(ref["err"]))


def test_traceback_kernel_matches_scan():
    probs = rand_batch(6, 30, 5, seed=7)
    lengths = np.array([30, 12, 30, 0, 30, 5], np.int32)
    raw = beam_pallas.beam_search_pallas_batch(
        probs, lengths, np.float32(0.1), beam_size=5, interpret=True,
        raw=True,
    )
    want = beam_fast._traceback_scan_batch(raw["fin"], raw["ids_log"], 30, 5, 4)
    got = beam_pallas.traceback_pallas_batch(
        raw["fin"], raw["ids_log"], T=30, K=5, A=4, block_b=4, interpret=True
    )
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), np.asarray(g))


def test_cpu_runs_kernel_only_in_interpret_mode():
    probs = rand_batch(2, 8, 5)
    with pytest.raises(Exception, match="interpret"):
        beam_pallas.beam_search_pallas_batch(
            probs, np.full((2,), 8, np.int32), np.float32(0.0), beam_size=2
        )


@pytest.mark.parametrize("stage", ["decode", "traceback"])
def test_lower_for_cuda_at_benchmark_widths(stage):
    """Each kernel lowers for CUDA through Triton from this host at the
    benchmark shape (B=32768 reads, T=1000, 5 labels, beam 5)."""
    B, T, A1, K = 32768, 1000, 5, 5
    if stage == "decode":
        fn = lambda p, l: beam_pallas.beam_search_pallas_batch(
            p, l, np.float32(0.1), beam_size=K
        )
        args = (
            jax.ShapeDtypeStruct((B, T, A1), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.int32),
        )
        names = {"ctc_beam_decode", "ctc_beam_traceback"}
    else:
        fn = lambda f, i: beam_pallas.traceback_pallas_batch(
            f, i, T=T, K=K, A=A1 - 1
        )
        args = (
            jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((T, K, B), jnp.int32),
        )
        names = {"ctc_beam_traceback"}
    txt = (
        jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    )
    calls = re.findall(r"custom_call @([^\(]+)\(", txt)
    assert calls == ["__gpu$xla.gpu.triton"] * len(names)
    for name in names:
        assert name in txt


@pytest.mark.gpu
def test_kernels_on_card_match_scan_engine(gpu):
    """The compiled kernels on the card against the scan engine on the
    host's CPU: XLA's GPU code for the scan engine rounds differently on
    rare reads (PERF.md, H100 bring-up), its CPU code matches the oracle."""
    probs = rand_batch(300, 200, 5, seed=8)
    lengths = np.random.RandomState(8).randint(0, 201, 300).astype(np.int32)
    got = beam_pallas.beam_search_pallas_batch(
        probs, lengths, np.float32(0.1), beam_size=5
    )
    with jax.default_device(jax.devices("cpu")[0]):
        ref = beam_fast.beam_search_fast_batch(
            probs, lengths, np.float32(0.1), beam_size=5
        )
    assert_same(ref, got)
