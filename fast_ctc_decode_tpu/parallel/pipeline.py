"""Sharded batch decode pipeline.

Reads stream in as padded posterior batches ``[B, T, A+1]`` with per-read
lengths; the batch axis is sharded over the 1-D ``data`` mesh (pjit infers
the partitioning of the vmapped scan — reads never communicate), decoded
token/path arrays come back sharded, and only fixed-width arrays + counters
cross host boundaries.  Ragged strings are assembled host-local per shard.

A ``shard_map``-based variant demonstrates explicit collectives: a ``psum``
over the data axis merges per-shard read counters (the reads/s accounting
the multi-host benchmark uses).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .. import errors
from ..alphabet import normalize_alphabet
from ..ops import beam as beam_ops
from ..ops import beam_fast as beam_fast_ops
from ..ops import viterbi as viterbi_ops
from ..device import beam_engine
from .mesh import DATA_AXIS, batch_sharding, make_data_mesh


class BatchBeamDecoder:
    """Batched, mesh-sharded CTC prefix beam search decoder.

    Static configuration (shapes compile once): T, alphabet size, beam size,
    collapse flag.  ``decode`` accepts [B, T, A+1] f32 posteriors + [B]
    lengths, with B divisible by the mesh size.

    ``engine`` selects the device kernel:
      - "pallas": the fused Triton kernel (ops/beam_pallas.py) —
        bit-identical to "fast" on the CPU, the whole T loop in one kernel.
        It compiles for the GPU only; elsewhere it needs ``interpret=True``
        (tests).
      - "fast": hash-identity scan engine (ops/beam_fast.py) — O(beam)
        scan state, sequence-exact vs the reference; ``path`` entries for
        pruned-and-re-derived prefixes report their latest creation time.
      - "exact": flattened-suffix-tree engine (ops/beam.py) — bit-exact
        path and tie-break parity at much lower throughput; honours
        ``max_nodes``.
      - None (default): ``device.beam_engine()`` — "pallas" on the GPU,
        "fast" elsewhere.
    """

    def __init__(
        self,
        alphabet,
        T: int,
        beam_size: int = 5,
        beam_cut_threshold: float = 0.0,
        collapse_repeats: bool = True,
        max_nodes: Optional[int] = None,
        mesh=None,
        engine: Optional[str] = None,
        interpret: bool = False,
    ):
        self.alphabet = normalize_alphabet(alphabet)
        self.T = int(T)
        self.beam_size = int(beam_size)
        self.threshold = np.float32(beam_cut_threshold)
        self.collapse = bool(collapse_repeats)
        if engine is None:
            engine = beam_engine()
        if engine not in ("pallas", "fast", "exact"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.mesh = mesh if mesh is not None else make_data_mesh()
        self._sharding = batch_sharding(self.mesh)

        if engine == "pallas":
            from ..ops import beam_pallas as beam_pallas_ops

            kernel = functools.partial(
                beam_pallas_ops.beam_search_pallas_batch,
                beam_size=self.beam_size,
                collapse_repeats=self.collapse,
                interpret=interpret,
            )
        elif engine == "fast":
            kernel = functools.partial(
                beam_fast_ops.beam_search_fast_batch,
                beam_size=self.beam_size,
                collapse_repeats=self.collapse,
            )
        else:
            self.max_nodes = int(
                max_nodes
                if max_nodes is not None
                else beam_ops.default_max_nodes(
                    T, beam_size, len(self.alphabet) - 1
                )
            )
            kernel = functools.partial(
                beam_ops.beam_search_device_batch,
                beam_size=self.beam_size,
                collapse_repeats=self.collapse,
                max_nodes=self.max_nodes,
            )
        call = lambda p, l: kernel(p, l, self.threshold)
        if engine == "pallas":
            # a pallas_call does not partition under pjit — shard-map it so
            # each device runs the fused kernel on its local read shard
            self._fn = jax.jit(
                jax.shard_map(
                    call,
                    mesh=self.mesh,
                    in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                    out_specs=P(DATA_AXIS),
                    check_vma=False,
                )
            )
        else:
            self._fn = jax.jit(
                call,
                in_shardings=(self._sharding, self._sharding),
                out_shardings=self._sharding,
            )

    def decode_arrays(self, probs, lengths):
        """Device decode only — returns the raw fixed-width result dict
        (labels_rev, times_rev, count, err), sharded over the mesh."""
        return self._fn(
            jnp.asarray(probs, jnp.float32), jnp.asarray(lengths, jnp.int32)
        )

    def decode(self, probs, lengths) -> List[Tuple[str, List[int], int]]:
        """Full decode: returns [(sequence, path, err_code)] per read.
        Reads that fail keep their status code instead of raising, so one
        bad read cannot abort a batch (reference would raise per call).
        String assembly uses the native C++ detokenizer when available.
        Per-stage wall times land in ``utils.profiling.METRICS``."""
        from ..native import detokenize_batch
        from ..utils import profiling

        B = int(np.asarray(probs).shape[0])
        with profiling.stage("beam.device", reads=B):
            out = jax.device_get(self.decode_arrays(probs, lengths))
        with profiling.stage("beam.detok"):
            counts = np.where(
                np.asarray(out["err"]) == errors.OK, np.asarray(out["count"]), 0
            ).astype(np.int32)
            seqs = detokenize_batch(
                np.asarray(out["labels_rev"]), counts, self.alphabet[1:], reverse=True
            )
        res = []
        for seq, times_rev, n, err in zip(
            seqs, out["times_rev"], counts, out["err"]
        ):
            err = int(err)
            if err != errors.OK:
                res.append(("", [], err))
                continue
            path = [int(t) for t in times_rev[: int(n)][::-1]]
            res.append((seq, path, errors.OK))
        return res


class BatchViterbiDecoder:
    """Batched, mesh-sharded viterbi decoder (device argmax + emission)."""

    def __init__(
        self,
        alphabet,
        T: int,
        collapse_repeats: bool = True,
        qscale: float = 1.0,
        qbias: float = 0.0,
        mesh=None,
    ):
        self.alphabet = normalize_alphabet(alphabet)
        self.T = int(T)
        self.collapse = bool(collapse_repeats)
        self.qscale = np.float32(qscale)
        self.qbias = np.float32(qbias)
        self.mesh = mesh if mesh is not None else make_data_mesh()
        self._sharding = batch_sharding(self.mesh)

        self._fn = jax.jit(
            lambda p, l: jax.vmap(
                lambda pp, ll: viterbi_ops.viterbi_device(
                    pp, ll, self.qscale, self.qbias, collapse_repeats=self.collapse
                )
            )(p, l),
            in_shardings=(self._sharding, self._sharding),
            out_shardings=self._sharding,
        )

    def decode_arrays(self, probs, lengths):
        probs = jnp.asarray(probs, jnp.float32)
        lengths = jnp.asarray(lengths, jnp.int32)
        return self._fn(probs, lengths)

    def decode(self, probs, lengths, qstring: bool = False):
        from ..native import detokenize_batch, qstrings_batch

        out = jax.device_get(self.decode_arrays(probs, lengths))
        counts = np.asarray(out["n"], np.int32)
        # viterbi tokens are 1-based alphabet rows: index the full alphabet
        seqs = detokenize_batch(
            np.asarray(out["tokens"]), counts, self.alphabet, reverse=False
        )
        if qstring:
            qstrs = qstrings_batch(np.asarray(out["qints"], np.uint32), counts)
            seqs = [s + q for s, q in zip(seqs, qstrs)]
        return [
            (seq, [int(i) for i in path[: int(n)]])
            for seq, path, n in zip(seqs, out["path"], counts)
        ]


@functools.lru_cache(maxsize=64)
def _decode_and_count_fn(mesh, beam_size, threshold, collapse, engine, interpret):
    """Cached jitted shard_map — rebuilding the jit wrapper per call would
    recompile on every invocation."""
    if engine == "pallas":
        from ..ops import beam_pallas as beam_pallas_ops

        decode = functools.partial(
            beam_pallas_ops.beam_search_pallas_batch, interpret=interpret
        )
    elif engine == "fast":
        decode = beam_fast_ops.beam_search_fast_batch
    else:
        raise ValueError(f"unknown engine {engine!r}")

    def shard_fn(p, l):
        out = decode(
            p, l, jnp.float32(threshold), beam_size=beam_size,
            collapse_repeats=collapse,
        )
        ok = jnp.sum((out["err"] == errors.OK).astype(jnp.int32))
        bad = jnp.sum((out["err"] != errors.OK).astype(jnp.int32))
        totals = jax.lax.psum(jnp.stack([ok, bad]), DATA_AXIS)
        return out, totals

    return jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(DATA_AXIS), P()),
            # per-shard decode is communication-free until the final psum;
            # the scan carry starts from replicated constants, which the
            # varying-axes checker would otherwise reject
            check_vma=False,
        )
    )


def decode_and_count(
    mesh, probs, lengths, *, beam_size, threshold, collapse, max_nodes=None,
    engine=None, interpret=False,
):
    """shard_map decode with an explicit psum over the data axis: every shard
    decodes its reads and all shards agree on the global (decoded, errored)
    counters — the cross-host merge the reference never had.  ``engine`` is
    "fast", "pallas" or None (``device.beam_engine()``); ``max_nodes`` is
    accepted for API compatibility and ignored."""
    del max_nodes
    fn = _decode_and_count_fn(
        mesh, int(beam_size), float(threshold), bool(collapse),
        str(engine or beam_engine()), bool(interpret),
    )
    return fn(probs, lengths)


def _bucket_edge_for(T: int, min_edge: int = 128) -> int:
    """Smallest power-of-two edge >= T (and >= min_edge).  The serve layer
    keys its compiled-decoder cache on this, so requests with nearby read
    lengths share one compiled decoder at <= 2x padding waste."""
    e = int(min_edge)
    while e < T:
        e *= 2
    return e


def _auto_bucket_edges(lengths: Sequence[int], min_edge: int = 128) -> List[int]:
    """Power-of-two length-bucket edges covering ``lengths``: padding waste
    is bounded at 2x per read while the number of compiled kernels stays
    logarithmic in the length range."""
    mx = max(lengths)
    edges = []
    e = min_edge
    while e < mx:
        edges.append(e)
        e *= 2
    edges.append(mx)
    return edges


def decode_many(
    reads: Sequence[np.ndarray],
    alphabet,
    *,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    collapse_repeats: bool = True,
    batch_size: int = 256,
    T: Optional[int] = None,
    bucket_edges: Optional[Sequence[int]] = None,
    mesh=None,
    engine: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
) -> List[Tuple[str, List[int], int]]:
    """Decode a long list of variable-length reads with checkpoint/resume.

    Reads are grouped into length buckets (``bucket_edges``; auto power-of-2
    edges unless ``T`` pins a single bucket), so mixed 100-10,000-frame read
    sets pay bounded (≤2x) padding waste with one compiled kernel per bucket
    instead of padding everything to the global max.  Each bucket is decoded
    in fixed ``batch_size`` device batches over the data mesh (final partial
    batches are padded with length-0 dummy reads, not duplicate decodes) and
    results are appended to the JSONL checkpoint per batch — a preempted run
    restarted with the same ``checkpoint_path`` resumes at exactly the
    undecoded reads.  Results are returned in input order.  ``engine``
    as in ``BatchBeamDecoder`` (None: the platform's batched engine).
    """
    from ..utils.checkpoint import DecodeCheckpoint
    from ..utils.padding import bucket_reads

    if not reads:
        return []
    engine = engine or beam_engine()
    if T is not None:
        edges = [int(T)]
    elif bucket_edges is not None:
        edges = sorted(int(e) for e in bucket_edges)
    else:
        edges = _auto_bucket_edges([r.shape[0] for r in reads])
    meta = {
        "bucket_edges": edges,
        "beam_size": int(beam_size),
        "beam_cut_threshold": float(beam_cut_threshold),
        "collapse_repeats": bool(collapse_repeats),
        "engine": engine,
    }
    from ..utils import profiling

    ckpt = DecodeCheckpoint.load_or_create(checkpoint_path, meta)
    try:
        if ckpt.cursor >= len(reads):
            profiling.log.info(
                "decode_many: all %d reads already in checkpoint", len(reads)
            )
            return ckpt.results_in_order(len(reads))

        buckets = bucket_reads(reads, edges)
        A1 = reads[0].shape[1]
        for edge, idxs in sorted(buckets.items()):
            todo = [i for i in idxs if i not in ckpt.done]
            if not todo:
                continue
            dec = BatchBeamDecoder(
                alphabet,
                T=edge,
                beam_size=beam_size,
                beam_cut_threshold=beam_cut_threshold,
                collapse_repeats=collapse_repeats,
                mesh=mesh,
                engine=engine,
            )
            n_dev = len(dec.mesh.devices.reshape(-1))
            bs = max(batch_size - batch_size % n_dev, n_dev)
            profiling.log.info(
                "decode_many: bucket T<=%d, %d reads, batch=%d", edge,
                len(todo), bs,
            )
            for s in range(0, len(todo), bs):
                chunk = todo[s : s + bs]
                n = len(chunk)
                # partial batches ride length-0 padding rows (decoded as
                # empty in O(1) work), never duplicate decodes
                with profiling.stage("decode_many.pad"):
                    probs = np.zeros((bs, edge, A1), np.float32)
                    lengths = np.zeros((bs,), np.int32)
                    for j, i in enumerate(chunk):
                        r = reads[i]
                        probs[j, : r.shape[0]] = r
                        lengths[j] = r.shape[0]
                res = dec.decode(probs, lengths)[:n]
                with profiling.stage("decode_many.checkpoint"):
                    ckpt.record(chunk, res)
                bad = sum(1 for r in res if r[2] != errors.OK)
                if bad:
                    profiling.log.warning(
                        "decode_many: %d/%d reads errored in batch", bad, n
                    )
        profiling.log.info(
            "decode_many: %d reads done; stage seconds: %s",
            len(reads),
            {k: round(v, 3) for k, v in profiling.METRICS.stages.items()},
        )
        return ckpt.results_in_order(len(reads))
    finally:
        ckpt.close()


def decode_many_crf(
    reads: Sequence,
    alphabet,
    *,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    batch_size: int = 256,
    mesh=None,
    engine: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
) -> List[Tuple[str, List[int], int]]:
    """Checkpointable streaming CRF decode — decode_many for the CRF
    family.  ``reads`` entries are ``(posteriors [T, S, A+1],
    init_state [S])``; variable T rides power-of-two buckets (padded
    frames are masked by per-read lengths).  Returns
    ``[(sequence, path, err_code)]`` in input order."""
    from ..utils import profiling
    from ..utils.checkpoint import DecodeCheckpoint

    if not reads:
        return []
    edges = _auto_bucket_edges([r[0].shape[0] for r in reads])
    S = reads[0][0].shape[1]
    meta = {
        "crf": True,
        "bucket_edges": edges,
        "n_state": int(S),
        "beam_size": int(beam_size),
        "beam_cut_threshold": float(beam_cut_threshold),
        "engine": engine,
    }
    ckpt = DecodeCheckpoint.load_or_create(checkpoint_path, meta)
    try:
        if ckpt.cursor >= len(reads):
            return ckpt.results_in_order(len(reads))

        buckets: Dict[int, List[int]] = {}
        for i, r in enumerate(reads):
            e = next(e for e in edges if e >= r[0].shape[0])
            buckets.setdefault(e, []).append(i)

        A1 = reads[0][0].shape[2]
        for edge, idxs in sorted(buckets.items()):
            todo = [i for i in idxs if i not in ckpt.done]
            if not todo:
                continue
            dec = BatchCrfBeamDecoder(
                alphabet, T=edge, n_state=S, beam_size=beam_size,
                beam_cut_threshold=beam_cut_threshold, mesh=mesh,
                engine=engine,
            )
            n_dev = len(dec.mesh.devices.reshape(-1))
            bs = max(batch_size - batch_size % n_dev, n_dev)
            profiling.log.info(
                "decode_many_crf: bucket T<=%d, %d reads, batch=%d",
                edge, len(todo), bs,
            )
            for s in range(0, len(todo), bs):
                chunk = todo[s : s + bs]
                n = len(chunk)
                probs = np.zeros((bs, edge, S, A1), np.float32)
                inits = np.zeros((bs, S), np.float32)
                inits[:, 0] = 1.0  # padding rows decode empty (length 0)
                lengths = np.zeros((bs,), np.int32)
                for j, i in enumerate(chunk):
                    p, st = reads[i][0], reads[i][1]
                    probs[j, : p.shape[0]] = p
                    inits[j] = st
                    lengths[j] = p.shape[0]
                res = dec.decode(probs, inits, lengths)[:n]
                ckpt.record(chunk, res)
        return ckpt.results_in_order(len(reads))
    finally:
        ckpt.close()


def decode_many_duplex(
    pairs: Sequence,
    alphabet,
    *,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    collapse_repeats: bool = True,
    batch_size: int = 64,
    mesh=None,
    engine: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
) -> List[Tuple[str, int]]:
    """Decode a long list of read pairs with checkpoint/resume — the
    duplex analog of ``decode_many``.

    ``pairs`` entries are ``(net1, net2)`` or ``(net1, net2, envelope)``
    with per-pair ``[T1, 2]`` envelopes (None/omitted = full range).
    Pairs are grouped into (T1, T2) power-of-two buckets — one compiled
    decoder per bucket, ≤2x padding waste per axis.  Padding frames never
    leak into a decode: read 1 rides per-pair ``lengths``, read 2 rides
    the per-pair envelope (capped at the true T2).  Results
    ``[(sequence, err_code)]`` return in input order; the JSONL
    checkpoint (see utils/checkpoint.py) resumes a preempted run at
    exactly the undecoded pairs.
    """
    from ..utils import profiling
    from ..utils.checkpoint import DecodeCheckpoint

    if not pairs:
        return []
    e1s = _auto_bucket_edges([p[0].shape[0] for p in pairs])
    e2s = _auto_bucket_edges([p[1].shape[0] for p in pairs])

    def edge_for(T, edges):
        return next(e for e in edges if e >= T)

    meta = {
        "duplex": True,
        "bucket_edges": [e1s, e2s],
        "beam_size": int(beam_size),
        "beam_cut_threshold": float(beam_cut_threshold),
        "collapse_repeats": bool(collapse_repeats),
        "engine": engine,
    }
    ckpt = DecodeCheckpoint.load_or_create(checkpoint_path, meta)
    try:
        if ckpt.cursor >= len(pairs):
            return [(s, e) for s, _, e in ckpt.results_in_order(len(pairs))]

        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i, p in enumerate(pairs):
            key = (
                edge_for(p[0].shape[0], e1s), edge_for(p[1].shape[0], e2s)
            )
            buckets.setdefault(key, []).append(i)

        A1 = pairs[0][0].shape[1]
        for (edge1, edge2), idxs in sorted(buckets.items()):
            todo = [i for i in idxs if i not in ckpt.done]
            if not todo:
                continue
            dec = BatchDuplexDecoder(
                alphabet,
                T1=edge1,
                T2=edge2,
                beam_size=beam_size,
                beam_cut_threshold=beam_cut_threshold,
                collapse_repeats=collapse_repeats,
                mesh=mesh,
                engine=engine,
            )
            n_dev = len(dec.mesh.devices.reshape(-1))
            bs = max(batch_size - batch_size % n_dev, n_dev)
            profiling.log.info(
                "decode_many_duplex: bucket T1<=%d T2<=%d, %d pairs, "
                "batch=%d", edge1, edge2, len(todo), bs,
            )
            for s in range(0, len(todo), bs):
                chunk = todo[s : s + bs]
                n = len(chunk)
                with profiling.stage("decode_many_duplex.pad"):
                    n1 = np.zeros((n, edge1, A1), np.float32)
                    n2 = np.zeros((n, edge2, A1), np.float32)
                    envs = np.zeros((n, edge1, 2), np.int64)
                    lengths = np.zeros((n,), np.int32)
                    for j, i in enumerate(chunk):
                        p = pairs[i]
                        len1, len2 = p[0].shape[0], p[1].shape[0]
                        n1[j, :len1] = p[0]
                        n2[j, :len2] = p[1]
                        lengths[j] = len1
                        env = p[2] if len(p) > 2 else None
                        if env is None:
                            envs[j, :, 1] = len2  # full range of read 2
                        else:
                            env = np.asarray(env)
                            envs[j, :len1] = env
                            # rows past len1 are masked by `lengths`, but
                            # must stay monotone-valid: repeat the last row
                            envs[j, len1:] = env[len1 - 1 : len1]
                res = dec.decode(n1, n2, envelopes=envs, lengths=lengths)[:n]
                with profiling.stage("decode_many_duplex.checkpoint"):
                    # checkpoint rows are (seq, path, err); duplex has no
                    # path (reference contract), stored as []
                    ckpt.record(chunk, [(sq, [], er) for sq, er in res])
        return [(s, e) for s, _, e in ckpt.results_in_order(len(pairs))]
    finally:
        ckpt.close()


class BatchCrfBeamDecoder:
    """Batched, mesh-sharded CRF prefix beam search.

    Accepts [B, T, S, A+1] f32 posteriors, [B, S] init states and [B]
    lengths; sequence-exact vs the reference crf_beam_search (ops/beam_fast
    contract).

    ``engine``: "fast" (default; XLA scan, ops/beam_fast.py) or "exact"
    (bit-exact path/tie parity: the XLA suffix-tree engine, ops/crf.py).
    """

    def __init__(
        self,
        alphabet,
        T: int,
        n_state: int,
        beam_size: int = 5,
        beam_cut_threshold: float = 0.0,
        mesh=None,
        engine: Optional[str] = None,
    ):
        self.alphabet = normalize_alphabet(alphabet)
        self.T = int(T)
        self.n_state = int(n_state)
        self.beam_size = int(beam_size)
        self.threshold = np.float32(beam_cut_threshold)
        self.mesh = mesh if mesh is not None else make_data_mesh()
        self._sharding = batch_sharding(self.mesh)
        engine = engine or "fast"
        if engine not in ("fast", "exact"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        if engine == "exact":
            from ..ops import crf as crf_xops

            self.max_nodes = beam_ops.default_max_nodes(
                self.T, self.beam_size, len(self.alphabet) - 1
            )
            kernel = lambda p, s, l: jax.vmap(
                lambda pp, ss, ll: crf_xops.crf_beam_search_device(
                    pp, ss, ll, self.threshold,
                    beam_size=self.beam_size, max_nodes=self.max_nodes,
                )
            )(p, s, l)
        else:
            kernel = lambda p, s, l: beam_fast_ops.crf_beam_search_fast_batch(
                p, s, l, self.threshold, beam_size=self.beam_size
            )
        self._fn = jax.jit(
            kernel,
            in_shardings=(self._sharding,) * 3,
            out_shardings=self._sharding,
        )

    def decode_arrays(self, probs, init_states, lengths):
        return self._fn(
            jnp.asarray(probs, jnp.float32),
            jnp.asarray(init_states, jnp.float32),
            jnp.asarray(lengths, jnp.int32),
        )

    def decode(self, probs, init_states, lengths):
        """Returns [(sequence, path, err_code)] per read."""
        from ..native import detokenize_batch

        out = jax.device_get(self.decode_arrays(probs, init_states, lengths))
        counts = np.where(
            np.asarray(out["err"]) == errors.OK, np.asarray(out["count"]), 0
        ).astype(np.int32)
        seqs = detokenize_batch(
            np.asarray(out["labels_rev"]), counts, self.alphabet[1:], reverse=True
        )
        res = []
        for seq, times_rev, n, err in zip(
            seqs, out["times_rev"], counts, out["err"]
        ):
            err = int(err)
            if err != errors.OK:
                res.append(("", [], err))
            else:
                res.append((seq, [int(t) for t in times_rev[: int(n)][::-1]], 0))
        return res


class BatchDuplexDecoder:
    """Batched, mesh-sharded 2-D duplex pair-consensus decoder.

    Static shapes per batch: T1, T2 (bucket upstream).  Envelopes: None
    (full range), a shared ``[T1, 2]`` array, or per-pair ``[B, T1, 2]``.

    ``engine``:
      - None (auto, parity-first): constant-window envelopes run the XLA
        fast engine — sequence-exact there; moving windows run the
        bit-exact tree engine, batched (``ops.duplex.duplex_exact_batch``).
      - "fast": slot-band semantics everywhere (re-derived prefixes
        rebuild bands over the current window — measurably different
        from the reference on moving windows, much faster).
      - "exact": the tree engine for everything.
    """

    def __init__(
        self,
        alphabet,
        T1: int,
        T2: int,
        beam_size: int = 5,
        beam_cut_threshold: float = 0.0,
        collapse_repeats: bool = True,
        mesh=None,
        engine: Optional[str] = None,
    ):
        from ..ops import duplex_fast as duplex_fast_ops

        self._ops = duplex_fast_ops
        self.alphabet = normalize_alphabet(alphabet)
        self.T1, self.T2 = int(T1), int(T2)
        self.beam_size = int(beam_size)
        self.threshold = float(beam_cut_threshold)
        self.collapse = bool(collapse_repeats)
        self.mesh = mesh if mesh is not None else make_data_mesh()
        self._sharding = batch_sharding(self.mesh)
        if engine not in (None, "fast", "exact"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine

    def decode(self, net1, net2, envelopes=None, lengths=None):
        """net1 [B, T1, A+1], net2 [B, T2, A+1] linear probabilities.
        ``envelopes``: None (full range), [T1, 2] (one envelope shared by
        the whole batch) or [B, T1, 2] (per-pair).  Returns
        [(sequence, err_code)] per pair (duplex returns no path, matching
        the reference — src/duplex.rs:638-649)."""
        B0 = net1.shape[0]
        T1, T2 = self.T1, self.T2
        (net1, net2), envelopes, lengths, B, shared_env = _pad_duplex_batch(
            self.mesh, [net1, net2], envelopes, lengths, T1, T2
        )
        los, his, eps = _prep_envelope_batch(
            self._ops, envelopes, B, T1, T2, shared_env
        )
        ep = eps[0]
        # static W/Wr/Wext are batch maxima
        W = max(1, max(e.W for e in eps))
        Wr = max(1, max(e.Wr for e in eps))
        Wext = max(1, max(e.Wext for e in eps))
        D = max(0, max(e.D for e in eps))
        needs_ext = any(e.needs_ext for e in eps)
        static_window = all(e.static_window for e in eps)
        rel_window = all(e.rel_window for e in eps) and not static_window

        with np.errstate(divide="ignore", invalid="ignore"):
            l1 = np.log(np.asarray(net1, np.float32), dtype=np.float32)
            l2 = np.log(np.asarray(net2, np.float32), dtype=np.float32)
            thr = np.float32(np.log(np.float32(self.threshold)))
        root_gap = np.full((B, Wr), -np.inf, np.float32)
        for b in range(B):
            wr_b = int(min(max(envelopes[b][0, 1], 0), T2)) + 1
            root_gap[b, 0] = 0.0
            root_gap[b, 1:wr_b] = np.cumsum(
                l2[b, : wr_b - 1, 0], dtype=np.float32
            )

        engine = self.engine
        if engine is None:
            # auto is parity-first, mirroring api._pick_duplex_engine: the
            # slot-band engine is sequence-exact only for constant-window
            # envelopes; moving windows need reference band-reuse semantics
            constant_window = bool(
                np.all(los == los[0, 0]) and np.all(his == his[0, 0])
            )
            engine = "fast" if constant_window else "exact"

        if engine == "exact":
            out = _exact_engine_out(
                self, l1, l2, root_gap, los, his,
                np.asarray(lengths, np.int32), thr, envelopes, shared_env,
                crf=False,
                collapse=self.collapse,
                init_states=np.zeros((B,), np.int32),
            )
            return self._assemble(out, B0)

        # shared envelopes ride in_axes=None so window starts stay
        # scalars inside the vmapped scan (see duplex_fast_batch)
        if shared_env:
            lo_a, hi_a = los[0], his[0]
        else:
            lo_a, hi_a = los, his
        fn = _duplex_fast_fn(
            self.mesh, self.beam_size, self.collapse, float(thr),
            W, Wr, Wext, needs_ext, False,
            static_window, rel_window, D, shared_env,
        )
        out = jax.device_get(
            fn(l1, l2, root_gap, lo_a, hi_a,
               np.zeros((l1.shape[0],), np.int32),
               np.asarray(lengths, np.int32))
        )
        return self._assemble(out, B0)

    def _assemble(self, out, B0):
        return _assemble_duplex(out, B0, self.alphabet)


@functools.lru_cache(maxsize=32)
def _duplex_fast_fn(
    mesh, beam_size, collapse, thr, W, Wr, Wext, needs_ext, crf,
    static_window, rel_window, D, shared_env,
):
    """Cached jitted shard_map over duplex_fast_batch — rebuilding the jit
    wrapper per decode() call would recompile on every invocation."""
    from ..ops import duplex_fast as duplex_fast_ops

    env_spec = (P(),) * 2 if shared_env else (P(DATA_AXIS),) * 2
    return jax.jit(
        jax.shard_map(
            lambda a, c, rg, lo, hi, st, ln: duplex_fast_ops.duplex_fast_batch(
                a, c, rg, lo, hi, np.float32(thr), st, ln,
                beam_size=beam_size, collapse_repeats=collapse,
                W=W, Wr=Wr, Wext=Wext, needs_ext=needs_ext, crf=crf,
                static_window=static_window, rel_window=rel_window, D=D,
                shared_env=shared_env,
            ),
            mesh=mesh,
            in_specs=(P(DATA_AXIS),) * 3 + env_spec + (P(DATA_AXIS),) * 2,
            out_specs=P(DATA_AXIS),
            check_vma=False,
        )
    )


@functools.lru_cache(maxsize=32)
def _duplex_exact_xla_fn(
    mesh, beam_size, collapse, thr, N, We, Wre, Wxe, ne, crf,
):
    """Cached jitted shard_map over the batched XLA tree engine."""
    from ..ops import duplex as duplex_ops

    return jax.jit(
        jax.shard_map(
            lambda a, c, rg, lo_, hi_, st, ln: duplex_ops.duplex_exact_batch(
                a, c, rg, lo_, hi_, np.float32(thr), st, ln,
                beam_size=beam_size, collapse_repeats=collapse,
                max_nodes=N, W=We, Wr=Wre, Wext=Wxe,
                needs_ext=ne, crf=crf,
            ),
            mesh=mesh,
            in_specs=(P(DATA_AXIS),) * 7,
            out_specs=P(DATA_AXIS),
            check_vma=False,
        )
    )


def _assemble_duplex(out, B0, alphabet):
    """Duplex result assembly: [(sequence, err_code)] per pair (duplex
    returns no path, matching the reference — src/duplex.rs:638-649)."""
    from ..native import detokenize_batch

    counts = np.where(
        np.asarray(out["err"]) == errors.OK, np.asarray(out["count"]), 0
    ).astype(np.int32)
    seqs = detokenize_batch(
        np.asarray(out["labels_rev"]), counts, alphabet[1:], reverse=True
    )
    return [
        (s if int(e) == errors.OK else "", int(e))
        for s, e in zip(seqs[:B0], np.asarray(out["err"])[:B0])
    ]


def _pad_duplex_batch(mesh, arrays, envelopes, lengths, T1, T2):
    """Shared duplex batch prep: pad per-pair arrays to a full device
    batch (padding pairs are length-0 reads), normalize ``envelopes`` to a
    dense [B, T1, 2] view (None = full range; [T1, 2] = shared), default
    ``lengths``.  Returns (arrays, envelopes, lengths, B, shared_env)."""
    B0 = arrays[0].shape[0]
    shared_env = envelopes is None or np.asarray(envelopes).ndim == 2
    n_dev = len(mesh.devices.reshape(-1))
    pad = (-B0) % n_dev
    if pad:
        arrays = [
            np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0) for a in arrays
        ]
        if envelopes is not None and not shared_env:
            envelopes = np.concatenate(
                [envelopes, np.repeat(envelopes[-1:], pad, 0)], 0
            )
        if lengths is not None:
            lengths = np.concatenate(
                [np.asarray(lengths), np.zeros((pad,), np.int32)]
            )
    B = arrays[0].shape[0]
    if shared_env:
        env = None if envelopes is None else np.asarray(envelopes)
        if env is None:
            env = np.zeros((T1, 2), np.int64)
            env[:, 1] = T2
        envelopes = np.broadcast_to(env.astype(np.int64), (B, T1, 2))
    if lengths is None:
        lengths = np.full((B,), T1, np.int32)
        if pad:
            lengths[B0:] = 0
    return arrays, envelopes, np.asarray(lengths, np.int32), B, shared_env


def _prep_envelope_batch(ops, envelopes, B, T1, T2, shared_env):
    """Fast-engine envelope prep per pair (once when shared): returns
    ([B, T1] lo, [B, T1] hi, [EnvPrep, ...])."""
    los = np.zeros((B, T1), np.int32)
    his = np.zeros((B, T1), np.int32)
    eps = []
    for b in range(1 if shared_env else B):
        ep = ops._prep_envelope_fast(np.asarray(envelopes[b]), T2)
        eps.append(ep)
        los[b], his[b] = ep.lo, ep.hi
    if shared_env:
        los[:] = los[0]
        his[:] = his[0]
    return los, his, eps


def _exact_engine_out(
    dec, l1, l2, root_gap, los, his, lengths, thr, envelopes, shared_env,
    *, crf, collapse, init_states,
):
    """Reference-band-reuse decode of a prepared batch on the batched XLA
    tree engine (ops/duplex.py), chunked so its band tables fit in device
    memory."""
    from ..ops import duplex as duplex_ops

    B, T1 = los.shape
    T2 = l2.shape[1]
    A = len(dec.alphabet) - 1
    eps = [
        duplex_ops._prep_envelope(np.asarray(envelopes[b]), T2)
        for b in range(1 if shared_env else B)
    ]
    We = max(e[2] for e in eps)
    Wre = max(e[3] for e in eps)
    ne = any(e[4] for e in eps)
    Wxe = max(e[5] for e in eps)
    N = duplex_ops._duplex_max_nodes(T1, dec.beam_size, A, We)

    # chunk so band tables stay within ~2 GB of device memory per call
    per_read = N * We * 8
    n_dev = len(dec.mesh.devices.reshape(-1))
    chunk = max(int(2e9 // max(per_read, 1)), 1) * n_dev
    fn = _duplex_exact_xla_fn(
        dec.mesh, dec.beam_size, collapse, float(thr),
        N, We, Wre, Wxe, ne, crf,
    )
    args = (l1, l2, root_gap, los, his, init_states, lengths)
    outs = []
    # the ~2 GB chunk sizing is a heuristic; if a W/max_nodes miscount
    # still overflows device memory, catch the OOM and halve the chunk
    # instead of aborting the batch
    s = 0
    while s < B:
        e = min(s + chunk, B)
        try:
            outs.append(jax.device_get(fn(*(a[s:e] for a in args))))
        except jax.errors.JaxRuntimeError as exc:
            if "RESOURCE_EXHAUSTED" not in str(exc) or chunk <= n_dev:
                raise
            chunk = max(chunk // 2 - (chunk // 2) % n_dev, n_dev)
            continue
        s = e
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


class BatchCrfDuplexDecoder:
    """Batched, mesh-sharded 2-D CRF duplex pair-consensus decoder
    (reference /root/reference/src/duplex.rs:652-834).

    Inputs per batch: ``net1 [B, T1, S, A+1]``, ``init1 [B, S]``,
    ``net2 [B, T2, S, A+1]``, ``init2 [B, S]`` linear probabilities, plus
    optional envelopes (None = full range, ``[T1, 2]`` shared, or
    ``[B, T1, 2]`` per-pair) and ``lengths [B]``.

    ``engine`` mirrors ``BatchDuplexDecoder``'s parity-first policy:
      - None (auto): constant-window envelopes run the XLA fast engine
        (sequence-exact there); moving windows run the bit-exact tree
        engine, batched.
      - "fast": slot-band semantics everywhere (re-derived prefixes
        rebuild bands over the current window).
      - "exact": the tree engine for everything.
    """

    def __init__(
        self,
        alphabet,
        T1: int,
        T2: int,
        n_state: int,
        beam_size: int = 5,
        beam_cut_threshold: float = 0.0,
        mesh=None,
        engine: Optional[str] = None,
    ):
        from ..ops import duplex_fast as duplex_fast_ops

        self._ops = duplex_fast_ops
        self.alphabet = normalize_alphabet(alphabet)
        self.T1, self.T2 = int(T1), int(T2)
        self.S = int(n_state)
        self.beam_size = int(beam_size)
        self.threshold = float(beam_cut_threshold)
        self.mesh = mesh if mesh is not None else make_data_mesh()
        if engine not in (None, "fast", "exact"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine

    def decode(self, net1, init1, net2, init2, envelopes=None, lengths=None):
        """Returns [(sequence, err_code)] per pair."""
        B0 = net1.shape[0]
        T1, T2, S = self.T1, self.T2, self.S
        A = len(self.alphabet) - 1
        (net1, net2, init1, init2), envelopes, lengths, B, shared_env = (
            _pad_duplex_batch(
                self.mesh, [net1, net2, init1, init2], envelopes, lengths,
                T1, T2,
            )
        )

        with np.errstate(divide="ignore", invalid="ignore"):
            l1 = np.log(np.asarray(net1, np.float32), dtype=np.float32)
            l2 = np.log(np.asarray(net2, np.float32), dtype=np.float32)
            thr = np.float32(np.log(np.float32(self.threshold)))
        init_states = np.argmax(np.asarray(init1, np.float32), axis=1).astype(
            np.int32
        )

        los, his, eps = _prep_envelope_batch(
            self._ops, envelopes, B, T1, T2, shared_env
        )
        Wr = max(
            int(min(max(envelopes[b][0, 1], 0), T2)) + 1
            for b in range(1 if shared_env else B)
        )

        # crf root band walks the blank state trajectory per read
        # (duplex.rs:411-441), vectorized across the batch
        root_gap = np.full((B, Wr), -np.inf, np.float32)
        states = np.argmax(np.asarray(init2, np.float32), axis=1).astype(
            np.int64
        )
        cur = np.zeros((B,), np.float32)
        wr_b = np.minimum(np.maximum(envelopes[:, 0, 1], 0), T2) + 1
        root_gap[:, 0] = 0.0
        for i in range(Wr - 1):
            cur = (cur + l2[np.arange(B), i, states, 0]).astype(np.float32)
            live = i + 1 < wr_b
            root_gap[live, i + 1] = cur[live]
            states = (states * A) % S

        engine = self.engine
        if engine is None:
            constant_window = bool(
                np.all(los == los[0, 0]) and np.all(his == his[0, 0])
            )
            engine = "fast" if constant_window else "exact"

        if engine == "exact":
            out = _exact_engine_out(
                self, l1, l2, root_gap, los, his, lengths, thr,
                envelopes, shared_env, crf=True,
                collapse=False, init_states=init_states,
            )
            return _assemble_duplex(out, B0, self.alphabet)

        # fast engine: batch maxima for the static window sizes
        W = max(ep.W for ep in eps)
        Wrm = Wr
        Wext = max(ep.Wext for ep in eps)
        D = max(ep.D for ep in eps)
        needs_ext = any(ep.needs_ext for ep in eps)
        static_window = all(ep.static_window for ep in eps)
        rel_window = all(ep.rel_window for ep in eps) and not static_window
        if shared_env:
            lo_a, hi_a = los[0], his[0]
        else:
            lo_a, hi_a = los, his
        fn = _duplex_fast_fn(
            self.mesh, self.beam_size, False, float(thr),
            W, Wrm, Wext, needs_ext, True,
            static_window, rel_window, D, shared_env,
        )
        out = jax.device_get(
            fn(l1, l2, root_gap, lo_a, hi_a, init_states, lengths)
        )
        return _assemble_duplex(out, B0, self.alphabet)
