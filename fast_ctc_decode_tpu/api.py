"""Reference-parity Python API.

Mirrors the six PyO3 entry points of the reference binding layer
(/root/reference/src/lib.rs:170-578) — same signatures, defaults, argument
validation (messages included), and exception mapping (ValueError for
precondition failures before the kernel runs, RuntimeError for search
failures).  Under the hood every call runs the JAX device kernels and
assembles ragged strings host-side.

The reference aborts the process (panic=abort) on a handful of internal
asserts (e.g. empty network_output); this layer raises ValueError instead.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from . import errors
from .alphabet import normalize_alphabet
from .ops import beam as beam_ops
from .ops import crf as crf_ops
from .ops import viterbi as viterbi_ops

__all__ = [
    "viterbi_search",
    "beam_search",
    "crf_greedy_search",
    "crf_beam_search",
    "beam_search_duplex",
    "crf_beam_search_duplex",
]


def _as_f32(arr, ndim: int, name: str) -> np.ndarray:
    """Strict dtype/rank check mirroring PyO3's PyArrayN<f32> extraction:
    a non-f32 or wrong-rank array is a TypeError, not a silent cast."""
    if not isinstance(arr, np.ndarray):
        raise TypeError(f"{name} must be a numpy.ndarray")
    if arr.dtype != np.float32:
        raise TypeError(f"{name} must have dtype float32")
    if arr.ndim != ndim:
        raise TypeError(f"{name} must be {ndim}-dimensional")
    return np.ascontiguousarray(arr)


def _check_beam_args(alphabet: List[str], beam_size: int, beam_cut_threshold: float):
    """Shared beam_search argument validation (src/lib.rs:332-350), with the
    threshold comparison done in f32 like the Rust binding."""
    if beam_size == 0:
        raise ValueError("beam_size cannot be 0")
    thr = np.float32(beam_cut_threshold)
    if thr < -np.float32(0.0):
        raise ValueError("beam_cut_threshold must be at least 0.0")
    max_beam_cut = np.float32(1.0) / np.float32(len(alphabet))
    if thr >= max_beam_cut:
        raise ValueError(f"beam_cut_threshold cannot be more than {max_beam_cut}")


def _beam_result_to_seq_path(
    out, alphabet: List[str]
) -> Tuple[str, List[int]]:
    errors.raise_for_status(int(out["err"]))
    n = int(out["count"])
    labels_rev = np.asarray(out["labels_rev"])[:n]
    times_rev = np.asarray(out["times_rev"])[:n]
    # traceback is leaf→root; the reference reverses both (src/search.rs:295-298)
    seq = "".join(alphabet[int(l) + 1] for l in labels_rev[::-1])
    path = [int(t) for t in times_rev[::-1]]
    return seq, path


def viterbi_search(
    network_output,
    alphabet: Union[str, Sequence],
    qstring: bool = False,
    qscale: float = 1.0,
    qbias: float = 0.0,
    collapse_repeats: bool = True,
) -> Tuple[str, List[int]]:
    """Viterbi decode; parity with src/lib.rs:180-212 / src/search.rs:320-383."""
    alphabet = normalize_alphabet(alphabet)
    network_output = _as_f32(network_output, 2, "network_output")
    if len(alphabet) == 0:
        raise ValueError("Empty alphabet given")
    if len(alphabet) != network_output.shape[1]:
        raise ValueError(
            "alphabet size does not match probability matrix dimensions"
        )
    if network_output.shape[0] == 0:
        raise ValueError("network_output must not be empty")

    labels, pmax = viterbi_ops.viterbi_core(network_output)
    return viterbi_ops.assemble_host(
        np.asarray(labels),
        np.asarray(pmax),
        alphabet,
        qstring,
        qscale,
        qbias,
        collapse_repeats,
    )


def beam_search(
    network_output,
    alphabet: Union[str, Sequence],
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    collapse_repeats: bool = True,
    *,
    max_nodes: Optional[int] = None,
    engine: Optional[str] = None,
) -> Tuple[str, List[int]]:
    """CTC prefix beam search; parity with src/lib.rs:323-365 /
    src/search.rs:159-301.

    ``engine`` selects the device kernel:
      - "exact" (default): flattened-suffix-tree engine (ops/beam.py) —
        bit-exact sequence, path, and tie-break parity with the Rust
        reference; honours ``max_nodes`` (the device-side tree budget,
        defaulting to the worst case for the input length).
      - "fast": hash-identity engine (ops/beam_fast.py) — identical
        *sequences*, orders of magnitude faster on long reads; ``path``
        entries for prefixes that were pruned from the beam and later
        re-derived report their latest creation time instead of the first
        (this shows up on engineered fixtures — e.g. the reference's 10x3
        WASM golden — so it cannot be the parity default), and exact float
        ties can break differently.  Use it (or the batch pipeline, which
        runs the fused Triton kernel on the GPU) when throughput
        matters and reference path parity does not.
    Combining ``max_nodes`` with ``engine="fast"`` is an error (only the
    exact engine has a node budget)."""
    alphabet = normalize_alphabet(alphabet)
    network_output = _as_f32(network_output, 2, "network_output")
    if len(alphabet) != network_output.shape[1]:
        raise ValueError(
            f"alphabet size {len(alphabet)} does not match probability matrix "
            f"inner dimension {network_output.shape[1]}"
        )
    _check_beam_args(alphabet, beam_size, beam_cut_threshold)

    T, A1 = network_output.shape
    if T == 0:
        return "", []
    if engine is None:
        engine = "exact"

    if engine == "fast":
        if max_nodes is not None:
            raise ValueError("max_nodes requires engine='exact'")
        from .ops import beam_fast as beam_fast_ops

        out = beam_fast_ops.beam_search_fast_device(
            network_output,
            np.int32(T),
            np.float32(beam_cut_threshold),
            beam_size=int(beam_size),
            collapse_repeats=bool(collapse_repeats),
        )
    elif engine == "exact":
        if max_nodes is None:
            max_nodes = beam_ops.default_max_nodes(T, beam_size, A1 - 1)
        out = beam_ops.beam_search_device(
            network_output,
            np.int32(T),
            np.float32(beam_cut_threshold),
            beam_size=int(beam_size),
            collapse_repeats=bool(collapse_repeats),
            max_nodes=int(max_nodes),
        )
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return _beam_result_to_seq_path(
        {k: np.asarray(v) for k, v in out.items()}, alphabet
    )


def crf_greedy_search(
    network_output,
    init_state,
    alphabet: Union[str, Sequence],
    qstring: bool = False,
    qscale: float = 1.0,
    qbias: float = 0.0,
) -> Tuple[str, List[int]]:
    """Greedy CRF decode; parity with src/lib.rs:217-250 / src/search.rs:385-423."""
    alphabet = normalize_alphabet(alphabet)
    network_output = _as_f32(network_output, 3, "network_output")
    init_state = _as_f32(init_state, 1, "init_state")
    if len(alphabet) == 0:
        raise ValueError("Empty alphabet given")
    if network_output.shape[2] != len(alphabet):
        raise ValueError(
            "alphabet size does not match probability matrix dimensions"
        )
    if network_output.shape[0] == 0:
        raise ValueError("network_output must not be empty")

    out = crf_ops.crf_greedy_device(
        network_output,
        init_state,
        np.int32(network_output.shape[0]),
        np.float32(qscale),
        np.float32(qbias),
    )
    n = int(out["n"])
    tokens = np.asarray(out["tokens"])[:n]
    path = [int(i) for i in np.asarray(out["path"])[:n]]
    seq = "".join(alphabet[int(t)] for t in tokens)
    if qstring:
        qints = np.asarray(out["qints"])[:n]
        seq += "".join(chr(int(q) + 33) for q in qints)
    return seq, path


def crf_beam_search(
    network_output,
    init_state,
    alphabet: Union[str, Sequence],
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    *,
    max_nodes: Optional[int] = None,
    engine: str = "exact",
) -> Tuple[str, List[int]]:
    """CRF prefix beam search; parity with src/lib.rs:255-286 /
    src/search.rs:38-157.  Note the reference binding performs no
    beam_size/threshold validation here; beam_size=0 empties the beam on the
    first step, which surfaces as RanOutOfBeam.

    ``engine``: "exact" (default — bit-exact path/tie parity via the
    flattened suffix tree) or "fast" (hash-identity engine, sequence-exact,
    much faster; see ops/beam_fast.py for the contract)."""
    alphabet = normalize_alphabet(alphabet)
    network_output = _as_f32(network_output, 3, "network_output")
    init_state = _as_f32(init_state, 1, "init_state")
    if len(alphabet) == 0:
        raise ValueError("Empty alphabet given")
    if network_output.shape[2] != len(alphabet):
        raise ValueError(
            "alphabet size does not match probability matrix dimensions"
        )
    if network_output.shape[0] == 0:
        raise ValueError("network_output must not be empty")
    if beam_size == 0:
        # truncate(0) empties the beam immediately (src/search.rs:133-137)
        raise errors.SearchError(errors.RAN_OUT_OF_BEAM)

    T = network_output.shape[0]
    A = network_output.shape[2] - 1
    if engine == "fast":
        from .ops import beam_fast as beam_fast_ops

        out = beam_fast_ops.crf_beam_search_fast_device(
            network_output,
            init_state,
            np.int32(T),
            np.float32(beam_cut_threshold),
            beam_size=int(beam_size),
        )
    elif engine == "exact":
        if max_nodes is None:
            max_nodes = beam_ops.default_max_nodes(T, beam_size, A)
        out = crf_ops.crf_beam_search_device(
            network_output,
            init_state,
            np.int32(T),
            np.float32(beam_cut_threshold),
            beam_size=int(beam_size),
            max_nodes=int(max_nodes),
        )
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return _beam_result_to_seq_path(
        {k: np.asarray(v) for k, v in out.items()}, alphabet
    )


def _pick_duplex_engine(
    engine: Optional[str],
    envelope: np.ndarray,
    t2: int,
    max_nodes: Optional[int] = None,
) -> str:
    """Engine auto-selection for the duplex decoders.

    "fast" (ops/duplex_fast.py) is sequence-exact vs the reference whenever
    every step sees the *same* clamped window — in particular the default
    full-range envelope — because then a re-derived prefix's rebuilt band is
    value-identical to the reference's reused one.  Any envelope whose
    window moves (lower OR upper bound) can make the fast engine rebuild
    bands over a different window than the reference's stale ones, so those
    default to the bit-exact tree engine ("exact", ops/duplex.py).

    An explicitly supplied ``max_nodes`` (the exact engine's tree budget)
    also forces "exact" rather than being silently ignored.
    """
    if engine is None:
        if max_nodes is not None:
            return "exact"
        lo = np.maximum(envelope[:, 0], 0)
        hi = np.minimum(envelope[:, 1], t2)
        constant_window = bool(
            len(lo) == 0 or (np.all(lo == lo[0]) and np.all(hi == hi[0]))
        )
        return "fast" if constant_window else "exact"
    if engine not in ("fast", "exact"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "fast" and max_nodes is not None:
        raise ValueError("max_nodes requires engine='exact'")
    return engine


def beam_search_duplex(
    network_output_1,
    network_output_2,
    alphabet: Union[str, Sequence],
    envelope=None,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    collapse_repeats: bool = True,
    *,
    max_nodes: Optional[int] = None,
    engine: Optional[str] = None,
) -> str:
    """2-D pair-consensus beam search; parity with src/lib.rs:411-488 /
    src/duplex.rs:443-650.  ``engine`` selects the device kernel (see
    ``_pick_duplex_engine``); default: auto."""
    alphabet = normalize_alphabet(alphabet)
    network_output_1 = _as_f32(network_output_1, 2, "network_output_1")
    network_output_2 = _as_f32(network_output_2, 2, "network_output_2")
    if network_output_1.shape[1] != network_output_2.shape[1]:
        raise ValueError("inner axes of the network outputs do not match")
    if len(alphabet) != network_output_1.shape[1]:
        raise ValueError(
            f"alphabet size {len(alphabet)} does not match probability matrix "
            f"inner dimension {network_output_1.shape[1]}"
        )
    _check_beam_args(alphabet, beam_size, beam_cut_threshold)
    envelope = _check_envelope(envelope, network_output_1, network_output_2)

    engine = _pick_duplex_engine(engine, envelope, network_output_2.shape[0], max_nodes)
    if engine == "fast":
        from .ops import duplex_fast as duplex_fast_ops

        return duplex_fast_ops.beam_search_duplex_fast_host(
            network_output_1,
            network_output_2,
            alphabet,
            envelope,
            int(beam_size),
            float(beam_cut_threshold),
            bool(collapse_repeats),
        )
    from .ops import duplex as duplex_ops  # deferred: heaviest module

    return duplex_ops.beam_search_duplex_host(
        network_output_1,
        network_output_2,
        alphabet,
        envelope,
        int(beam_size),
        float(beam_cut_threshold),
        bool(collapse_repeats),
        max_nodes=max_nodes,
    )


def crf_beam_search_duplex(
    network_output_1,
    init_state_1,
    network_output_2,
    init_state_2,
    alphabet: Union[str, Sequence],
    envelope=None,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    *,
    max_nodes: Optional[int] = None,
    engine: Optional[str] = None,
) -> str:
    """2-D CRF pair-consensus beam search; parity with src/lib.rs:495-578 /
    src/duplex.rs:652-834.  ``engine`` as in ``beam_search_duplex``."""
    alphabet = normalize_alphabet(alphabet)
    network_output_1 = _as_f32(network_output_1, 3, "network_output_1")
    network_output_2 = _as_f32(network_output_2, 3, "network_output_2")
    init_state_1 = _as_f32(init_state_1, 1, "init_state_1")
    init_state_2 = _as_f32(init_state_2, 1, "init_state_2")
    if network_output_1.shape[2] != network_output_2.shape[2]:
        raise ValueError("inner axes of the network outputs do not match")
    if len(alphabet) != network_output_1.shape[2]:
        raise ValueError(
            f"alphabet size {len(alphabet)} does not match probability matrix "
            f"inner dimension {network_output_1.shape[1]}"
        )
    _check_beam_args(alphabet, beam_size, beam_cut_threshold)
    envelope = _check_envelope(envelope, network_output_1, network_output_2)

    engine = _pick_duplex_engine(engine, envelope, network_output_2.shape[0], max_nodes)
    if engine == "fast":
        from .ops import duplex_fast as duplex_fast_ops

        return duplex_fast_ops.crf_beam_search_duplex_fast_host(
            network_output_1,
            init_state_1,
            network_output_2,
            init_state_2,
            alphabet,
            envelope,
            int(beam_size),
            float(beam_cut_threshold),
        )
    from .ops import duplex as duplex_ops

    return duplex_ops.crf_beam_search_duplex_host(
        network_output_1,
        init_state_1,
        network_output_2,
        init_state_2,
        alphabet,
        envelope,
        int(beam_size),
        float(beam_cut_threshold),
        max_nodes=max_nodes,
    )


def _check_envelope(envelope, network_output_1, network_output_2) -> np.ndarray:
    """Envelope validation + default construction (src/lib.rs:445-469):
    default = the full network_output_2 range for every network_output_1 row."""
    t1 = network_output_1.shape[0]
    t2 = network_output_2.shape[0]
    if envelope is None:
        env = np.zeros((t1, 2), dtype=np.int64)
        env[:, 1] = t2
        return env
    if not isinstance(envelope, np.ndarray):
        raise TypeError("envelope must be a numpy.ndarray")
    if envelope.ndim != 2:
        raise TypeError("envelope must be 2-dimensional")
    if not np.issubdtype(envelope.dtype, np.integer):
        raise TypeError("envelope must have an integer dtype")
    if envelope.shape[0] != t1:
        raise ValueError("the lengths of network_output_1 and envelope do not match")
    if envelope.shape[1] != 2:
        raise ValueError("the inner axis of envelope must have size 2")
    if np.any(envelope < 0):
        # reference takes usize — negative values are a TypeError at binding
        raise TypeError("envelope values must be non-negative")
    return envelope.astype(np.int64)
