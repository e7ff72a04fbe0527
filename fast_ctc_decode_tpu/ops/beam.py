"""CTC prefix beam search on the flattened suffix tree (the bit-exact engine).

Reference semantics: /root/reference/src/search.rs:159-301 (`beam_search`) and
src/search.rs:38-157 (`crf_beam_search`).  The reference keeps a beam of
``SearchPoint{node, state, label_prob, gap_prob}`` over a pointer-based suffix
tree, working in *linear* f32 probability space with a per-step division by
the top beam score to avoid underflow.

Accelerator-first redesign (not a port):

 - The suffix tree is flattened to preallocated device arrays
   ``parent/label/time [max_nodes]`` plus a dense child table
   ``child [max_nodes+1, A]`` (row ``node+1``, so the virtual root
   ``ROOT = -1`` maps to row 0 — the reference keeps a separate
   ``root_children`` vec, src/tree.rs:43).  Node ids are allocated with a
   monotone counter in the reference's exact ``add_node`` order (per tip,
   labels ascending; tips in beam order), so ids, emit times and tie-breaks
   match the reference bit-for-bit.

 - One decode step = expand → merge → select, all fixed-shape:
     * expand the beam to a ``[K, 1+2A]`` candidate grid laid out in the
       reference's push order (blank; then per label: stay-then-fork for a
       collapsed repeat, else a single arrival) with validity masks standing
       in for data-dependent pushes;
     * merge duplicate nodes by stable sort on node id + two conditional
       accumulation passes — a node can receive at most THREE candidates per
       step (blank from the tip sitting on it, stay from that same tip on a
       repeat, and one arrival from the unique tip on its parent), so two
       passes reproduce the reference's left-fold `+=` exactly
       (src/search.rs:244-260);
     * select by a stable 3-key lexicographic ``lax.sort`` (valid, total
       probability desc, node id asc) — the reference's unstable sort is
       insertion sort at beam sizes, which is stable over the node-sorted
       input, hence ties resolve ascending-node-id (src/search.rs:261-273);
     * renormalize by the top score via division (src/search.rs:278-282).

 - ``lax.scan`` over time, ``vmap`` over reads; per-read ragged lengths are
   handled by gating scatters and beam updates on ``t < length`` so padded
   steps are true no-ops without copying the tree state.

 - Errors become per-read status codes (see errors.py): NaN detection
   reproduces the reference exactly — Rust only flags
   ``IncomparableValues`` when a NaN is *compared* during the sort, which
   happens iff the merged beam has >= 2 entries and any total is NaN.
   After the first error the carry freezes (the reference returns early).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .. import errors

ROOT = -1  # reference tree.rs:88
_I32_MAX = np.iinfo(np.int32).max


class BeamCarry(NamedTuple):
    node: jnp.ndarray  # [K] i32, -2 = empty slot
    state: jnp.ndarray  # [K] i32 (CRF transition state; 0 for plain CTC)
    lab: jnp.ndarray  # [K] f32 label_prob
    gap: jnp.ndarray  # [K] f32 gap_prob
    valid: jnp.ndarray  # [K] bool
    parent: jnp.ndarray  # [N] i32
    label: jnp.ndarray  # [N] i32
    time: jnp.ndarray  # [N] i32
    child: jnp.ndarray  # [N+1, A] i32, -1 = no child; row = parent+1
    n_nodes: jnp.ndarray  # scalar i32
    err: jnp.ndarray  # scalar i32, first error code (0 = OK)


def _merge_select(node, lab, gap, state, valid, K):
    """Select the top-K beam from an already-merged candidate plane.

    ``node`` must be duplicate-free among ``valid`` rows (the step
    functions merge analytically: a node receives at most blank + stay +
    one arrival per step, each landing in a distinct ProbPair field or —
    for the two label-field contributions — summed commutatively, so no
    sort-and-scan duplicate pass is needed; see the module docstring).

    Selection is K rounds of (max total, tie -> min node id) — the same
    result as the reference's post-merge sort (total desc, stable over
    node-ascending input, src/search.rs:261-273) without a ``lax.sort``.
    Returns (node, lab, gap, state, valid, nan_flag, empty_flag, top);
    ``top`` is the best entry's total probability (pre-normalization).
    """
    total = lab + gap
    cnt = jnp.sum(valid.astype(jnp.int32))
    nan_flag = (cnt >= 2) & jnp.any(valid & jnp.isnan(total))
    empty_flag = cnt == 0

    # `total + 0.0` canonicalizes -0.0 to +0.0 so float comparisons agree
    # with the reference's partial_cmp on signed zeros; NaN totals map to
    # +inf so they sort first (the nan_flag error freezes the read anyway,
    # matching the reference's IncomparableValues early return).
    key = jnp.where(
        valid,
        jnp.where(jnp.isnan(total), jnp.float32(np.inf), total + jnp.float32(0.0)),
        -jnp.float32(np.inf),
    )

    sel = []
    top = None
    for _ in range(K):
        mx = jnp.max(key)
        ok = mx > -jnp.float32(np.inf)
        at = key == mx
        sid = jnp.min(jnp.where(at, node, _I32_MAX))
        chosen = at & (node == sid)

        def pick(arr, z):
            return jnp.sum(jnp.where(chosen, arr, z))

        if top is None:
            top = pick(total, jnp.float32(0))
        sel.append(
            (
                jnp.where(ok, sid, -2),
                pick(lab, jnp.float32(0)),
                pick(gap, jnp.float32(0)),
                pick(state, 0),
                ok,
            )
        )
        key = jnp.where(chosen, -jnp.float32(np.inf), key)

    node_f, lab_f, gap_f, state_f, ok_f = (
        jnp.stack([s[i] for s in sel]) for i in range(5)
    )
    return node_f, lab_f, gap_f, state_f, ok_f, nan_flag, empty_flag, top


def _allocate_nodes_core(
    node, parent, label, child, n_nodes, needs_new, active, N, A, K, time=None, t=None
):
    """Allocate new suffix-tree nodes for ``needs_new [K, A]`` (which must
    already require a child-table miss) in reference add_node order
    (tip-major, labels ascending).  Returns (new_id [K, A] — only meaningful
    where needs_new, -1 when the budget is blown — plus updated tree fields
    and the overflow flag).  ``time``/``t`` record allocation steps when the
    tree carries emit times (the 1D engines; the duplex tree does not)."""
    needs_new = needs_new & active
    flat_new = needs_new.reshape(-1)
    ranks = jnp.cumsum(flat_new.astype(jnp.int32)) - flat_new.astype(jnp.int32)
    total_new = jnp.sum(flat_new.astype(jnp.int32))
    new_id_flat = n_nodes + ranks
    overflow = active & (n_nodes + total_new > N)

    new_id = jnp.where(
        needs_new & (new_id_flat.reshape(K, A) < N), new_id_flat.reshape(K, A), -1
    )

    upd_ok = flat_new & (new_id_flat < N)
    scatter_idx = jnp.where(upd_ok, new_id_flat, N)  # index N is OOB -> dropped
    tip_flat = jnp.broadcast_to(node[:, None], (K, A)).reshape(-1)
    lbl_flat = jnp.broadcast_to(
        jnp.arange(A, dtype=jnp.int32)[None, :], (K, A)
    ).reshape(-1)

    parent = parent.at[scatter_idx].set(tip_flat, mode="drop")
    label = label.at[scatter_idx].set(lbl_flat, mode="drop")
    if time is not None:
        time = time.at[scatter_idx].set(t.astype(jnp.int32), mode="drop")
    crow = jnp.where(upd_ok, tip_flat + 1, N + 1)  # row N+1 is OOB -> dropped
    child = child.at[crow, lbl_flat].set(new_id_flat, mode="drop")
    n_nodes = jnp.where(
        active, jnp.minimum(n_nodes + total_new, N), n_nodes
    )
    return new_id, parent, label, time, child, n_nodes, overflow


def _allocate_nodes(carry: BeamCarry, needs_new, t, active, N, A, K):
    return _allocate_nodes_core(
        carry.node, carry.parent, carry.label, carry.child, carry.n_nodes,
        needs_new, active, N, A, K, time=carry.time, t=t,
    )


def _finish_step(carry, merged, overflow, active, renorm=True):
    """Apply merge results + error bookkeeping, gated on ``active``."""
    node_n, lab_n, gap_n, state_n, valid_n, nan_flag, empty_flag, top = merged
    if renorm:
        lab_n = lab_n / top
        gap_n = gap_n / top
    node_n = jnp.where(valid_n, node_n, -2)
    lab_n = jnp.where(valid_n, lab_n, jnp.float32(0))
    gap_n = jnp.where(valid_n, gap_n, jnp.float32(0))

    # error priority within a step: overflow (ours) > NaN > empty beam,
    # matching the reference's check order (src/search.rs:261-277).
    step_err = jnp.where(
        overflow,
        errors.NODE_OVERFLOW,
        jnp.where(
            nan_flag,
            errors.INCOMPARABLE_VALUES,
            jnp.where(empty_flag, errors.RAN_OUT_OF_BEAM, errors.OK),
        ),
    )
    err = jnp.where(
        carry.err > 0, carry.err, jnp.where(active, step_err, errors.OK)
    ).astype(jnp.int32)

    return (
        jnp.where(active, node_n, carry.node),
        jnp.where(active, state_n, carry.state),
        jnp.where(active, lab_n, carry.lab),
        jnp.where(active, gap_n, carry.gap),
        jnp.where(active, valid_n, carry.valid),
        err,
    )


def _beam_step(carry: BeamCarry, xs, *, A, K, N, collapse, length, threshold):
    """One decode step of plain-CTC prefix beam search (src/search.rs:178-283)."""
    (p, t) = xs
    active = (t < length) & (carry.err == errors.OK)

    p0 = p[0]
    plab = p[1:]  # [A]
    tip_label = jnp.where(
        carry.node >= 0, jnp.take(carry.label, jnp.maximum(carry.node, 0)), -1
    )
    rows = jnp.clip(carry.node + 1, 0, N)
    c = jnp.take(carry.child, rows, axis=0)  # [K, A] existing children

    lbl_idx = jnp.arange(A, dtype=jnp.int32)
    if collapse:
        is_rep = tip_label[:, None] == lbl_idx[None, :]
    else:
        is_rep = jnp.zeros((K, A), bool)
    # blank requires strictly-greater, labels tolerate equality (NaN passes
    # the label check and fails the blank check, as in the reference
    # src/search.rs:191, 201-203).
    pushed_lab = carry.valid[:, None] & ~(plab[None, :] < threshold)
    gap_pos = carry.gap > jnp.float32(0)
    needs_new = pushed_lab & (c < 0) & (~is_rep | gap_pos[:, None])

    new_id, parent, label, time, child, n_nodes, overflow = _allocate_nodes(
        carry, needs_new, t, active, N, A, K
    )
    nid = jnp.where(c >= 0, c, new_id)  # -1 where no node exists/was made

    lg = carry.lab + carry.gap

    # ---- analytic merge (reference push set, src/search.rs:178-260).
    # Per step a node receives at most: blank from the tip sitting on it
    # (gap field), stay from that same tip on a collapsed repeat (label
    # field), and ONE nid-targeted mass — the arrival (non-repeat,
    # lg*plab) or the fork of a repeat (gap*plab) — label field.  The two
    # label-field contributions sum commutatively, so no sort is needed:
    # nid-targeted masses that land on a node currently in the beam are
    # routed into that tip's row; the rest stand alone (children are
    # unique per (parent, label), so they are duplicate-free).
    push_b = carry.valid & (p0 > threshold)
    gap_tip = jnp.where(push_b, lg * p0, jnp.float32(0))

    m_nid = jnp.where(is_rep, carry.gap[:, None], lg[:, None]) * plab[None, :]
    push_nid = pushed_lab & (nid >= 0)  # fork and arrival both need a node

    push_stay = pushed_lab & is_rep  # at most one label per tip (a == tip)
    stay_sum = jnp.sum(
        jnp.where(push_stay, carry.lab[:, None] * plab[None, :], 0.0), axis=1
    )

    tgt = jnp.where(push_nid, nid, -9)  # nid >= 0, so -9 never matches
    eq = (tgt[None, :, :] == carry.node[:, None, None]) & carry.valid[
        :, None, None
    ]  # [K tips, K, A]
    recv = jnp.sum(jnp.where(eq, m_nid[None, :, :], 0.0), axis=(1, 2))
    recv_any = jnp.any(eq, axis=(1, 2))
    matched = jnp.any(eq, axis=0)  # [K, A]

    lab_tip = stay_sum + recv
    tip_valid = push_b | jnp.any(push_stay, axis=1) | recv_any

    node_all = jnp.concatenate([carry.node, nid.reshape(-1)])
    lab_all = jnp.concatenate([lab_tip, m_nid.reshape(-1)])
    gap_all = jnp.concatenate([gap_tip, jnp.zeros((K * A,), jnp.float32)])
    valid_all = jnp.concatenate(
        [tip_valid, (push_nid & ~matched).reshape(-1)]
    )
    state_all = jnp.zeros_like(node_all)

    merged = _merge_select(node_all, lab_all, gap_all, state_all, valid_all, K)
    node_n, state_n, lab_n, gap_n, valid_n, err = _finish_step(
        carry, merged, overflow, active
    )

    new_carry = BeamCarry(
        node_n, state_n, lab_n, gap_n, valid_n, parent, label, time, child, n_nodes, err
    )
    return new_carry, None


def _traceback(node0, parent, label, time, T):
    """Walk parent pointers root-ward; returns reversed labels/times + count.

    Chain depth never exceeds T: a child's allocation step is strictly after
    its parent's, so a fixed T-trip fori_loop is enough.
    """

    def body(i, st):
        cur, labs, times = st
        ok = cur >= 0
        safe = jnp.maximum(cur, 0)
        labs = labs.at[i].set(jnp.where(ok, jnp.take(label, safe), -1))
        times = times.at[i].set(jnp.where(ok, jnp.take(time, safe), -1))
        cur = jnp.where(ok, jnp.take(parent, safe), jnp.int32(-2))
        return (cur, labs, times)

    labs0 = jnp.full((T,), -1, jnp.int32)
    times0 = jnp.full((T,), -1, jnp.int32)
    _, labs, times = jax.lax.fori_loop(0, T, body, (node0.astype(jnp.int32), labs0, times0))
    count = jnp.sum((labs >= 0).astype(jnp.int32))
    return labs, times, count


def _init_carry(K, N, A, init_lab, init_gap, init_state):
    slot = jnp.arange(K, dtype=jnp.int32)
    return BeamCarry(
        node=jnp.where(slot == 0, jnp.int32(ROOT), jnp.int32(-2)),
        state=jnp.where(slot == 0, jnp.asarray(init_state, jnp.int32), 0),
        lab=jnp.where(slot == 0, jnp.asarray(init_lab, jnp.float32), 0.0).astype(
            jnp.float32
        ),
        gap=jnp.where(slot == 0, jnp.asarray(init_gap, jnp.float32), 0.0).astype(
            jnp.float32
        ),
        valid=slot == 0,
        parent=jnp.full((N,), -2, jnp.int32),
        label=jnp.full((N,), -1, jnp.int32),
        time=jnp.full((N,), -1, jnp.int32),
        child=jnp.full((N + 1, A), -1, jnp.int32),
        n_nodes=jnp.int32(0),
        err=jnp.int32(0),
    )


@functools.partial(
    jax.jit, static_argnames=("beam_size", "collapse_repeats", "max_nodes")
)
def beam_search_device(
    probs: jnp.ndarray,
    length: jnp.ndarray,
    beam_cut_threshold: jnp.ndarray,
    *,
    beam_size: int,
    collapse_repeats: bool = True,
    max_nodes: int,
):
    """Decode one (possibly padded) read with CTC prefix beam search.

    Args:
      probs: [T, A+1] f32 posteriors, column 0 = blank.
      length: scalar i32 valid frames.
      beam_cut_threshold: scalar f32.

    Returns dict: labels_rev [T] i32 (0-based label ids, deepest-first),
      times_rev [T] i32, count, err.
    """
    T, A1 = probs.shape
    A = A1 - 1
    K = beam_size
    N = max_nodes

    carry = _init_carry(K, N, A, 0.0, 1.0, 0)
    xs = (probs, jnp.arange(T, dtype=jnp.int32))
    step = functools.partial(
        _beam_step,
        A=A,
        K=K,
        N=N,
        collapse=collapse_repeats,
        length=jnp.asarray(length, jnp.int32),
        threshold=jnp.asarray(beam_cut_threshold, jnp.float32),
    )
    carry, _ = jax.lax.scan(step, carry, xs)

    labels_rev, times_rev, count = _traceback(
        carry.node[0], carry.parent, carry.label, carry.time, T
    )
    return {
        "labels_rev": labels_rev,
        "times_rev": times_rev,
        "count": count,
        "err": carry.err,
    }


@functools.partial(
    jax.jit, static_argnames=("beam_size", "collapse_repeats", "max_nodes")
)
def beam_search_device_batch(
    probs: jnp.ndarray,
    lengths: jnp.ndarray,
    beam_cut_threshold: jnp.ndarray,
    *,
    beam_size: int,
    collapse_repeats: bool = True,
    max_nodes: int,
):
    """vmap of beam_search_device over a [B, T, A+1] batch with [B] lengths."""
    fn = lambda p, l: beam_search_device(
        p,
        l,
        beam_cut_threshold,
        beam_size=beam_size,
        collapse_repeats=collapse_repeats,
        max_nodes=max_nodes,
    )
    return jax.vmap(fn)(probs, lengths)


def default_max_nodes(T: int, beam_size: int, n_labels: int, cap: int = 4_000_000) -> int:
    """Worst-case node budget: every step can allocate at most beam*A nodes
    (one per (tip, label) miss — src/search.rs:229-239)."""
    return int(min(T * beam_size * n_labels + 8, cap))
