"""Viterbi (greedy argmax) CTC decoding on device arrays.

Reference semantics (/root/reference/src/search.rs:320-383): per-frame argmax
(first occurrence of the max wins — the fold at src/search.rs:303-318 uses a
strict ``>``); a frame emits when its label is non-blank and (collapse is off
or the label differs from the previous frame's label); the path records the
emitting frame; a per-run mean label probability becomes one phred char per
emitted label, flushed when the *next* emit happens (or at the end).  The run
accumulator keeps counting over collapsed repeats and is not reset by blanks.

Device design: the per-frame argmax/max is one wide fused reduction over
the ``[T, A]`` posterior block.  Emission, path extraction and run-mean
quality are computed with masks/cumsums — no sequential host loop.  Ragged
reads are handled with a per-read ``length`` and padding rows masked to
blanks.  Batched decoding is ``vmap`` over reads.

Two assembly paths:
 - ``viterbi_device``: everything on device, fixed-width outputs (tokens,
   path, phred ints, count).  Run means use an f64 cumsum (may differ from
   the reference's sequential f32 accumulation by 1 ulp pre-rounding).
 - ``assemble_host``: NumPy assembly from (labels, pmax) with *bit-exact*
   sequential f32 run sums (np.add.reduceat), used by the single-read
   parity API.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .phred import phred_int, phred_int_np


def viterbi_core(probs: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-frame (argmax label, max prob) over the label axis.

    First-occurrence argmax matches the reference fold (src/search.rs:303-318).
    """
    labels = jnp.argmax(probs, axis=-1).astype(jnp.int32)
    pmax = jnp.max(probs, axis=-1)
    return labels, pmax


@functools.partial(jax.jit, static_argnames=("collapse_repeats",))
def viterbi_device(
    probs: jnp.ndarray,
    length: jnp.ndarray,
    qscale: jnp.ndarray,
    qbias: jnp.ndarray,
    *,
    collapse_repeats: bool = True,
):
    """Full-device viterbi decode of one (possibly padded) read.

    Args:
      probs: [T, A] f32 posterior block (row 0 of the label axis is blank).
      length: scalar int32, number of valid frames (<= T).
      qscale/qbias: phred parameters.

    Returns dict of fixed-width outputs:
      tokens: [T] int32, label indices (1-based rows of the alphabet) of the
        emitted sequence, front-packed; garbage beyond ``n``.
      path:   [T] int32, emitting frame per token, front-packed.
      qints:  [T] uint32, rounded phred integer per token (add 33 and chr()).
      n:      scalar int32 count of emitted tokens.
    """
    T = probs.shape[0]
    frame = jnp.arange(T, dtype=jnp.int32)
    in_range = frame < length

    labels, pmax = viterbi_core(probs)
    labels = jnp.where(in_range, labels, 0)
    pmax = jnp.where(in_range, pmax, jnp.float32(0))

    nonzero = labels != 0
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), labels[:-1]])
    if collapse_repeats:
        emit = nonzero & (labels != prev)
    else:
        emit = nonzero

    # Segment index of each frame: the index of the most recent emit.
    seg = jnp.cumsum(emit.astype(jnp.int32)) - 1
    n = jnp.sum(emit.astype(jnp.int32))

    # Run means: nonzero frames accumulate into the current segment (may
    # differ from the reference's sequential f32 adds by 1 ulp pre-rounding;
    # the parity API uses the bit-exact host assembly below instead).
    contrib = jnp.where(nonzero, pmax, jnp.float32(0))
    seg_safe = jnp.maximum(seg, 0)
    sums = jax.ops.segment_sum(contrib, seg_safe, num_segments=T)
    counts = jax.ops.segment_sum(
        jnp.where(nonzero, jnp.float32(1), jnp.float32(0)), seg_safe, num_segments=T
    )
    mean = sums / jnp.maximum(counts, jnp.float32(1))
    qints_by_seg = phred_int(mean, qscale, qbias)

    # Front-pack emitted frames: stable sort by (not emit) keeps frame order.
    order = jnp.argsort(jnp.where(emit, frame, jnp.int32(T)), stable=True)
    packed = order  # first n entries are the emitting frames in order
    path = jnp.where(jnp.arange(T) < n, packed, 0).astype(jnp.int32)
    tokens = jnp.take(labels, path)
    return {"tokens": tokens, "path": path, "qints": qints_by_seg, "n": n}


def assemble_host(
    labels: np.ndarray,
    pmax: np.ndarray,
    alphabet: List[str],
    qstring: bool,
    qscale: float,
    qbias: float,
    collapse_repeats: bool,
) -> Tuple[str, List[int]]:
    """Bit-exact host assembly from per-frame (label, max prob).

    Replicates the reference's sequential f32 run accumulation
    (src/search.rs:341-380) using np.add.reduceat (sequential f32 adds).
    """
    labels = np.asarray(labels, dtype=np.int64)
    pmax = np.asarray(pmax, dtype=np.float32)
    nonzero = labels != 0
    if collapse_repeats:
        prev = np.concatenate(([np.int64(-1)], labels[:-1]))
        emit = nonzero & (labels != prev)
    else:
        emit = nonzero
    path = np.nonzero(emit)[0]
    seq = "".join(alphabet[int(l)] for l in labels[path])
    if not qstring:
        return seq, [int(i) for i in path]

    n = len(path)
    if n == 0:
        return seq, []
    nz_idx = np.nonzero(nonzero)[0]
    # segment of each nonzero frame = index of the latest emit at or before it
    seg_of_nz = np.searchsorted(path, nz_idx, side="right") - 1
    boundaries = np.searchsorted(seg_of_nz, np.arange(n))
    sums = np.add.reduceat(pmax[nz_idx], boundaries).astype(np.float32)
    counts = np.diff(np.concatenate((boundaries, [len(nz_idx)])))
    means = sums / counts.astype(np.float32)
    qints = phred_int_np(means, qscale, qbias)
    quality = "".join(chr(int(q) + 33) for q in qints)
    return seq + quality, [int(i) for i in path]
