"""Fast CTC prefix beam search: O(beam) carry, no materialized suffix tree.

This is the throughput engine behind the batched pipeline and the benchmark.
The exact-tree kernel (ops/beam.py) carries the whole flattened suffix tree
(parent/label/time [N] + child table [N+1, A]) through the scan; its cost
scales with the node budget N (~T*K*A) because every step's scatters touch
O(N) state.  This kernel removes *all* O(N) state from the scan:

 - **Prefix identity by rolling hash.**  Each beam tip carries a 64-bit
   content hash of its prefix (two independent 32-bit lanes), with
   ``child_hash = mix(parent_hash, label)``.  Two creations of the same
   prefix always produce the same hash, so "does candidate (tip i, label l)
   target an existing beam tip j?" is the K x (K*A) comparison
   ``mix(hash_i, l) == hash_j`` — no child table.  The reference answers
   the same question with ``SuffixTree::get_child``
   (/root/reference/src/tree.rs:147-161, used at src/search.rs:205-239).

 - **Analytic merge.**  A node can receive at most three candidates per
   step — blank from the tip sitting on it (src/search.rs:191-198), stay
   from that tip on a collapsed repeat (src/search.rs:205-211), and one
   arrival from the unique tip at its parent prefix (src/search.rs:229-239;
   unique because beam tips are deduplicated) — and the partners are known
   from the match matrix, so merging (src/search.rs:244-260) is three adds,
   not a sort.  The top-K select is K rounds of (max, tie -> min id)
   extraction over the K*(A+1) merged candidates — no sort anywhere.

 - **Position-coded node ids.**  A node created from tip slot k by label l
   at step t gets id ``t*K*A + k*A + l`` (root = -1).  Ids are strictly
   monotone in the reference's allocation order (per step: tip-major,
   labels ascending — src/search.rs:229-239), so ascending-id tie-breaking
   is order-isomorphic to the reference's, and the id *is* the traceback
   record: decode (t, k, l), emit label l at time t, step to the parent
   ``beam_ids[t, k]``.  The scan's only per-step output is the K tip ids.

Exactness contract vs the reference ``beam_search`` (src/search.rs:159-301):
the decoded **sequence** is identical except in three measure-zero cases,
none of which arise on non-degenerate float inputs (validated against the
oracle on randomized posteriors by tests/test_fast_beam.py):

 1. The reference reuses the node id of a previously-created prefix when it
    is re-derived (get_child hit on a node outside the beam); this kernel
    allocates a fresh id.  Merging is unaffected (hash identity is
    canonical), but exact float *ties* between beam entries can break in a
    different order, and the reported ``path`` entry for a re-derived prefix
    is its latest creation time rather than its first.  Use the exact-tree
    kernel when reference path/tie semantics matter (the single-read API
    does).
 2. The reference pushes a zero-mass fork when a collapsed repeat's child
    node exists in the tree but gap_prob == 0 (src/search.rs:212-218 with an
    existing child); this kernel only sees children that are current tips.
    A zero-mass entry can only influence the result by padding an underfull
    beam with probability-0 hypotheses.
 3. A 64-bit hash collision between two distinct live prefixes (~2^-64 per
    comparison) would merge them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .. import errors

ROOT = -1
_I32_MAX = np.iinfo(np.int32).max

# two independent 32-bit mix lanes (murmur3/splitmix-style avalanche)
_SEED1 = np.uint32(0x9E3779B9)
_SEED2 = np.uint32(0x85EBCA6B)


def _mix(h, x, mult, add):
    """One avalanche round folding label ``x`` into hash lane ``h``."""
    z = h ^ (x.astype(jnp.uint32) * mult + add)
    z = z * mult
    return z ^ (z >> jnp.uint32(16))


def _mix1(h, lbl):
    return _mix(h, lbl, jnp.uint32(0xC2B2AE35), jnp.uint32(0x165667B1))


def _mix2(h, lbl):
    return _mix(h, lbl, jnp.uint32(0x27D4EB2F), jnp.uint32(0x9E3779B1))


class FastCarry(NamedTuple):
    id: jnp.ndarray  # [K] i32 position-coded node id; -1 root, -2 empty
    h1: jnp.ndarray  # [K] u32 prefix hash lane 1
    h2: jnp.ndarray  # [K] u32 prefix hash lane 2
    lastlab: jnp.ndarray  # [K] i32 last label (0-based), -1 for root
    state: jnp.ndarray  # [K] i32 CRF transition state (0 for plain CTC)
    lab: jnp.ndarray  # [K] f32 label_prob
    gap: jnp.ndarray  # [K] f32 gap_prob
    valid: jnp.ndarray  # [K] bool
    err: jnp.ndarray  # scalar i32


def _init_fast_carry(K, init_lab, init_gap, init_state):
    slot = jnp.arange(K, dtype=jnp.int32)
    is0 = slot == 0
    return FastCarry(
        id=jnp.where(is0, jnp.int32(ROOT), jnp.int32(-2)),
        h1=jnp.where(is0, _SEED1, np.uint32(0)).astype(jnp.uint32),
        h2=jnp.where(is0, _SEED2, np.uint32(0)).astype(jnp.uint32),
        lastlab=jnp.full((K,), -1, jnp.int32),
        state=jnp.where(is0, jnp.asarray(init_state, jnp.int32), 0),
        lab=jnp.where(is0, jnp.asarray(init_lab, jnp.float32), 0.0).astype(
            jnp.float32
        ),
        gap=jnp.where(is0, jnp.asarray(init_gap, jnp.float32), 0.0).astype(
            jnp.float32
        ),
        valid=is0,
        err=jnp.int32(0),
    )


def _expand_merge_select(
    carry, t, active, p0, plab, is_rep, new_state, threshold, *, A, K, crf
):
    """Shared step core: expand tips, merge analytically, select top-K.

    Args:
      p0: blank probability — scalar for plain CTC, [K] per-tip for CRF.
      plab: label probabilities — [A] for plain CTC, [K, A] for CRF.
      is_rep: [K, A] collapsed-repeat mask (all-False disables collapse).
      new_state: [K, A] i32 state after emitting label l from tip k.
    Returns the next carry (minus err handling) + (nan_flag, empty_flag).
    """
    lbl = jnp.arange(A, dtype=jnp.int32)
    if not crf:
        plab_k = jnp.broadcast_to(plab[None, :], (K, A))
        p0_k = jnp.broadcast_to(p0, (K,))
    else:
        plab_k, p0_k = plab, p0

    # NaN must pass the label threshold check and fail the blank check,
    # as in the reference (src/search.rs:191, 201-203).
    pushed_lab = carry.valid[:, None] & ~(plab_k < threshold)
    gap_pos = carry.gap > jnp.float32(0)

    # target hashes of every (tip, label) extension
    th1 = _mix1(carry.h1[:, None], lbl[None, :])  # [K, A]
    th2 = _mix2(carry.h2[:, None], lbl[None, :])

    # match[i, l, j]: extension (i, l) targets the prefix of current tip j —
    # target hash equals j's own prefix hash (the lastlab check is a
    # belt-and-braces collision guard; it is implied by hash equality)
    m = (
        (th1[:, :, None] == carry.h1[None, None, :])
        & (th2[:, :, None] == carry.h2[None, None, :])
        & (lbl[None, :, None] == carry.lastlab[None, None, :])
        & carry.valid[None, None, :]
    )
    matched = jnp.any(m, axis=-1)  # [K, A]

    # extension mass: collapsed repeat forks with gap only (src/search.rs:
    # 212-227), otherwise arrival with label+gap (src/search.rs:229-239)
    lg = carry.lab + carry.gap
    m_ext = jnp.where(is_rep, carry.gap[:, None], lg[:, None]) * plab_k
    push_ext = pushed_lab & (~is_rep | matched | gap_pos[:, None])

    # ---- analytic merge ----
    # each tip j receives: its blank, its stay (collapse), and at most one
    # arrival (the unique extension whose target hash matches it)
    recv = jnp.sum(
        jnp.where(m & push_ext[:, :, None], m_ext[:, :, None], jnp.float32(0)),
        axis=(0, 1),
    )  # [K]
    recv_any = jnp.any(m & push_ext[:, :, None], axis=(0, 1))  # [K]

    if not crf:
        # stay: collapsed repeat keeps the node via label_prob only
        safe_last = jnp.clip(carry.lastlab, 0, A - 1)
        p_stay = jnp.take(plab, safe_last)  # [K]
        stay_push = (
            carry.valid & (carry.lastlab >= 0) & ~(p_stay < threshold)
        )
        # honour the is_rep gate so collapse_repeats=False disables stays
        stay_push = stay_push & jnp.any(is_rep, axis=1)
        stay_lab = jnp.where(stay_push, carry.lab * p_stay, jnp.float32(0))
    else:
        stay_push = jnp.zeros((K,), bool)
        stay_lab = jnp.zeros((K,), jnp.float32)

    blank_push = carry.valid & (p0_k > threshold)
    blank_gap = jnp.where(blank_push, lg * p0_k, jnp.float32(0))

    tip_lab = stay_lab + recv
    tip_gap = blank_gap
    tip_valid = blank_push | stay_push | recv_any

    # fresh candidates: extensions that target no current tip
    fresh_valid = push_ext & ~matched  # [K, A]
    base = t.astype(jnp.int32) * np.int32(K * A)
    slot_code = (
        jnp.arange(K, dtype=jnp.int32)[:, None] * np.int32(A) + lbl[None, :]
    )
    fresh_id = base + slot_code  # [K, A]

    # ---- candidate table: K tip slots then K*A fresh slots ----
    def cat(a_tip, a_fresh):
        return jnp.concatenate([a_tip, a_fresh.reshape(-1)])

    c_valid = cat(tip_valid, fresh_valid)
    c_lab = cat(tip_lab, jnp.where(fresh_valid, m_ext, jnp.float32(0)))
    c_gap = cat(tip_gap, jnp.zeros((K, A), jnp.float32))
    c_id = cat(carry.id, fresh_id)
    c_h1 = cat(carry.h1, th1)
    c_h2 = cat(carry.h2, th2)
    c_lastlab = cat(carry.lastlab, jnp.broadcast_to(lbl[None, :], (K, A)))
    c_state = cat(carry.state, new_state)

    total = c_lab + c_gap
    cnt = jnp.sum(c_valid.astype(jnp.int32))
    # the reference only reports IncomparableValues when a NaN is actually
    # *compared* during its sort (>= 2 merged entries — src/search.rs:261-272)
    nan_flag = (cnt >= 2) & jnp.any(c_valid & jnp.isnan(total))
    empty_flag = cnt == 0

    # ---- top-K select: total desc (canonicalizing -0.0), id asc ----
    # K rounds of (max, min-id) extraction instead of a multi-operand sort:
    # a sorting network rewrites every operand O(log^2 n) times, while each
    # round here is a handful of reductions over the candidate axis.  The
    # (max, tie -> min id) rule reproduces the reference's ordering exactly
    # (src/search.rs:261-273 — unstable insertion sort over node-id-sorted
    # input resolves ties ascending node id).  NaN totals map to +inf so a
    # lone NaN entry still tops the beam as in Rust (with >= 2 candidates
    # the NaN error path makes ordering irrelevant).
    key = jnp.where(
        c_valid,
        jnp.where(jnp.isnan(total), jnp.float32(np.inf), total + jnp.float32(0.0)),
        jnp.float32(-np.inf),
    )

    ids_sel = []
    h1_sel = []
    h2_sel = []
    ll_sel = []
    st_sel = []
    lab_sel = []
    gap_sel = []
    v_sel = []
    top = None
    for _ in range(K):
        mx = jnp.max(key)
        slot_valid = mx > -jnp.float32(np.inf)
        at_mx = key == mx
        sel_id = jnp.min(jnp.where(at_mx, c_id, _I32_MAX))
        chosen = at_mx & (c_id == sel_id)  # exactly one lane (ids unique)

        def pick(x, zero):
            return jnp.sum(jnp.where(chosen, x, zero))

        if top is None:
            # per-step renormalizer (src/search.rs:278-282); use the raw
            # total (NaN included) rather than the +inf-mapped key
            top = pick(total, jnp.float32(0))
        ids_sel.append(jnp.where(slot_valid, pick(c_id, 0), jnp.int32(-2)))
        h1_sel.append(pick(c_h1, jnp.uint32(0)))
        h2_sel.append(pick(c_h2, jnp.uint32(0)))
        ll_sel.append(pick(c_lastlab, 0).astype(jnp.int32))
        st_sel.append(pick(c_state, 0).astype(jnp.int32))
        lab_sel.append(pick(c_lab, jnp.float32(0)))
        gap_sel.append(pick(c_gap, jnp.float32(0)))
        v_sel.append(slot_valid)
        key = jnp.where(chosen, jnp.float32(-np.inf), key)

    v_k = jnp.stack(v_sel)
    next_c = FastCarry(
        id=jnp.stack(ids_sel).astype(jnp.int32),
        h1=jnp.stack(h1_sel),
        h2=jnp.stack(h2_sel),
        lastlab=jnp.stack(ll_sel),
        state=jnp.stack(st_sel),
        lab=jnp.where(v_k, jnp.stack(lab_sel) / top, jnp.float32(0)),
        gap=jnp.where(v_k, jnp.stack(gap_sel) / top, jnp.float32(0)),
        valid=v_k,
        err=carry.err,
    )
    return next_c, nan_flag, empty_flag


def _apply_step(carry, next_c, nan_flag, empty_flag, active):
    """Gate the step result on ``active`` and fold in the error code."""
    step_err = jnp.where(
        nan_flag,
        errors.INCOMPARABLE_VALUES,
        jnp.where(empty_flag, errors.RAN_OUT_OF_BEAM, errors.OK),
    )
    err = jnp.where(
        carry.err > 0, carry.err, jnp.where(active, step_err, errors.OK)
    ).astype(jnp.int32)

    def g(new, old):
        return jnp.where(active, new, old)

    return FastCarry(
        id=g(next_c.id, carry.id),
        h1=g(next_c.h1, carry.h1),
        h2=g(next_c.h2, carry.h2),
        lastlab=g(next_c.lastlab, carry.lastlab),
        state=g(next_c.state, carry.state),
        lab=g(next_c.lab, carry.lab),
        gap=g(next_c.gap, carry.gap),
        valid=g(next_c.valid, carry.valid),
        err=err,
    )


def _traceback_positional(id0, beam_ids, T, K, A):
    """Walk position-coded ids root-ward via the per-step beam-id log.

    ``beam_ids[t, k]`` is the id of tip slot k at entry to step t, i.e. the
    parent of any node allocated as (t, k, l).  A parent is always created
    at a strictly earlier step, so T iterations suffice.
    """
    flat = beam_ids.reshape(-1)  # [T*K]

    def body(i, st):
        cur, labs, times = st
        ok = cur >= 0
        safe = jnp.maximum(cur, 0)
        t = safe // np.int32(K * A)
        r = safe % np.int32(K * A)
        k = r // np.int32(A)
        l = r % np.int32(A)
        labs = labs.at[i].set(jnp.where(ok, l, -1))
        times = times.at[i].set(jnp.where(ok, t, -1))
        parent = jnp.take(flat, t * np.int32(K) + k)
        cur = jnp.where(ok, parent, jnp.int32(-2))
        return (cur, labs, times)

    labs0 = jnp.full((T,), -1, jnp.int32)
    times0 = jnp.full((T,), -1, jnp.int32)
    _, labs, times = jax.lax.fori_loop(
        0, T, body, (id0.astype(jnp.int32), labs0, times0)
    )
    count = jnp.sum((labs >= 0).astype(jnp.int32))
    return labs, times, count


def _beam_fast_step(carry, xs, *, A, K, collapse, length, threshold):
    (p, t) = xs
    active = (t < length) & (carry.err == errors.OK)

    p0 = p[0]
    plab = p[1:]
    lbl = jnp.arange(A, dtype=jnp.int32)
    if collapse:
        is_rep = carry.lastlab[:, None] == lbl[None, :]
    else:
        is_rep = jnp.zeros((K, A), bool)
    new_state = jnp.zeros((K, A), jnp.int32)

    next_c, nan_flag, empty_flag = _expand_merge_select(
        carry, t, active, p0, plab, is_rep, new_state, threshold,
        A=A, K=K, crf=False
    )
    new_carry = _apply_step(carry, next_c, nan_flag, empty_flag, active)
    return new_carry, carry.id  # log entry-tips for traceback


@functools.partial(jax.jit, static_argnames=("beam_size", "collapse_repeats"))
def beam_search_fast_device(
    probs: jnp.ndarray,
    length: jnp.ndarray,
    beam_cut_threshold: jnp.ndarray,
    *,
    beam_size: int,
    collapse_repeats: bool = True,
):
    """Decode one (possibly padded) read; see module docstring for contract.

    Args:
      probs: [T, A+1] f32 posteriors, column 0 = blank.
      length: scalar i32 valid frames.

    Returns dict: labels_rev [T] i32 (0-based, deepest-first), times_rev [T]
      i32, count, err — the same contract as ops.beam.beam_search_device.
    """
    T, A1 = probs.shape
    A = A1 - 1
    K = beam_size

    carry = _init_fast_carry(K, 0.0, 1.0, 0)
    xs = (probs, jnp.arange(T, dtype=jnp.int32))
    step = functools.partial(
        _beam_fast_step,
        A=A,
        K=K,
        collapse=collapse_repeats,
        length=jnp.asarray(length, jnp.int32),
        threshold=jnp.asarray(beam_cut_threshold, jnp.float32),
    )
    carry, beam_ids = jax.lax.scan(step, carry, xs, unroll=4)

    labels_rev, times_rev, count = _traceback_positional(
        carry.id[0], beam_ids, T, K, A
    )
    return {
        "labels_rev": labels_rev,
        "times_rev": times_rev,
        "count": count,
        "err": carry.err,
    }


@functools.partial(
    jax.jit, static_argnames=("beam_size", "collapse_repeats", "raw")
)
def beam_search_fast_batch(
    probs: jnp.ndarray,
    lengths: jnp.ndarray,
    beam_cut_threshold: jnp.ndarray,
    *,
    beam_size: int,
    collapse_repeats: bool = True,
    raw: bool = False,
):
    """Batched fast beam over [B, T, A+1] + [B] lengths: scan-outside /
    vmap-inside decode plus the gather-free batched traceback.
    ``raw=True`` returns the decode's id log ([T, B, K] entry-tip ids),
    final head ids and status codes instead of the traceback."""
    B, T, A1 = probs.shape
    A = A1 - 1
    K = beam_size
    thr = jnp.asarray(beam_cut_threshold, jnp.float32)
    lengths = jnp.asarray(lengths, jnp.int32)

    carry0 = jax.vmap(lambda _: _init_fast_carry(K, 0.0, 1.0, 0))(
        jnp.arange(B)
    )
    probs_t = jnp.transpose(probs, (1, 0, 2))  # [T, B, A+1]

    def step(carry, xs):
        p, t = xs
        fn = lambda c, pp, ln: _beam_fast_step(
            c, (pp, t), A=A, K=K, collapse=collapse_repeats, length=ln,
            threshold=thr,
        )
        return jax.vmap(fn)(carry, p, lengths)

    carry, beam_ids = jax.lax.scan(
        step, carry0, (probs_t, jnp.arange(T, dtype=jnp.int32))
    )  # beam_ids: [T, B, K]
    if raw:
        return {"ids_log": beam_ids, "fin": carry.id[:, 0], "err": carry.err}
    labels_rev, times_rev, count = _traceback_scan_batch_tbk(
        carry.id[:, 0], beam_ids, T, K, A
    )
    return {
        "labels_rev": labels_rev,
        "times_rev": times_rev,
        "count": count,
        "err": carry.err,
    }


def _crf_fast_step(carry, xs, *, A, S, K, length, threshold):
    (p, t) = xs  # [S, A+1] or flat [S*(A+1)]
    active = (t < length) & (carry.err == errors.OK)

    # per-tip state row selection as a one-hot masked sum: a vmapped XLA
    # gather can lower to something O(B*S)-slow, while this fuses into
    # a masked reduction; `where` (not multiply) keeps NaN confined to the
    # selected row, matching the reference's plain row indexing
    p3 = p.reshape(S, A + 1)
    oh = (
        jnp.clip(carry.state, 0, S - 1)[:, None]
        == jnp.arange(S, dtype=jnp.int32)[None, :]
    )[:, :, None]  # [K, S, 1]
    prow = jnp.sum(
        jnp.where(oh, p3[None, :, :], jnp.float32(0)), axis=1
    )  # [K, A+1]
    p0 = prow[:, 0]
    plab = prow[:, 1:]
    lbl = jnp.arange(A, dtype=jnp.int32)
    is_rep = jnp.zeros((K, A), bool)  # CRF has no repeat collapse
    new_state = (
        (carry.state[:, None] * np.int32(A)) % np.int32(S) + lbl[None, :]
    ).astype(jnp.int32)

    next_c, nan_flag, empty_flag = _expand_merge_select(
        carry, t, active, p0, plab, is_rep, new_state, threshold,
        A=A, K=K, crf=True
    )
    new_carry = _apply_step(carry, next_c, nan_flag, empty_flag, active)
    return new_carry, carry.id


@functools.partial(jax.jit, static_argnames=("beam_size",))
def crf_beam_search_fast_device(
    probs: jnp.ndarray,
    init_state: jnp.ndarray,
    length,
    beam_cut_threshold,
    *,
    beam_size: int,
):
    """CRF prefix beam search (src/search.rs:38-157), hash-identity engine.

    probs: [T, S, A+1]; init beam per src/search.rs:54-59.
    """
    T, S, A1 = probs.shape
    A = A1 - 1
    K = beam_size

    carry = _init_fast_carry(
        K, jnp.max(init_state), init_state[0], jnp.argmax(init_state)
    )
    xs = (probs, jnp.arange(T, dtype=jnp.int32))
    step = functools.partial(
        _crf_fast_step,
        A=A,
        S=S,
        K=K,
        length=jnp.asarray(length, jnp.int32),
        threshold=jnp.asarray(beam_cut_threshold, jnp.float32),
    )
    carry, beam_ids = jax.lax.scan(step, carry, xs, unroll=4)

    labels_rev, times_rev, count = _traceback_positional(
        carry.id[0], beam_ids, T, K, A
    )
    return {
        "labels_rev": labels_rev,
        "times_rev": times_rev,
        "count": count,
        "err": carry.err,
    }


@functools.partial(jax.jit, static_argnames=("beam_size",))
def crf_beam_search_fast_batch(probs, init_states, lengths, beam_cut_threshold, *, beam_size: int):
    """Batched CRF beam over [B, T, S, A+1] + [B, S] init states + [B] lengths.

    Structured scan-outside/vmap-inside: CRF posteriors are enormous
    (B*T*S*(A+1) floats), and vmapping a scan makes XLA re-lay the whole
    tensor time-major plus working copies — OOM territory.  Transposing
    once to [T, B, S, A+1] and scanning the leading axis keeps memory at
    input + one copy."""
    B, T, S, A1 = probs.shape
    A = A1 - 1
    K = beam_size
    thr = jnp.asarray(beam_cut_threshold, jnp.float32)
    lengths = jnp.asarray(lengths, jnp.int32)

    # flatten (S, A+1) before transposing: the minor dim must stay wide
    # enough to avoid lane-padding blowup on the big CRF tensor
    probs_t = jnp.transpose(probs.reshape(B, T, S * A1), (1, 0, 2))
    carry0 = jax.vmap(
        lambda i: _init_fast_carry(
            K, jnp.max(i), i[0], jnp.argmax(i).astype(jnp.int32)
        )
    )(jnp.asarray(init_states, jnp.float32))

    def step(carry, xs):
        p, t = xs  # p: [B, S, A+1]
        fn = lambda c, pp, ln: _crf_fast_step(
            c, (pp, t), A=A, S=S, K=K, length=ln, threshold=thr
        )
        return jax.vmap(fn)(carry, p, lengths)

    carry, beam_ids = jax.lax.scan(
        step, carry0, (probs_t, jnp.arange(T, dtype=jnp.int32))
    )  # beam_ids: [T, B, K]

    labels_rev, times_rev, count = _traceback_scan_batch_tbk(
        carry.id[:, 0], beam_ids, T, K, A
    )
    return {
        "labels_rev": labels_rev,
        "times_rev": times_rev,
        "count": count,
        "err": carry.err,
    }


def _traceback_scan_batch(fin, ids_log, T, K, A, *, tips_major=True):
    """Batched traceback over the id log without gathers.

    ``_traceback_positional`` walks parent pointers with a per-iteration
    ``jnp.take`` — under vmap that is a batched gather per step.  This
    version exploits that parents have strictly smaller creation steps
    than children: ONE backward scan over t visits every chain node in
    leaf-to-root order.  Per step the parent read is a K-way one-hot
    select over the step's tip ids (no gather) and the step's emit is the
    scan's stacked ``ys`` row — contiguous [T, B] writes, not [B, 1]
    columns scattered into a [B, T] carry.

    Compaction packs (no-emit flag, scan step i, label+1) into ONE i32
    key per cell — the scan visits t descending, so ascending-key order
    is exactly "emits leaf-first, gaps last" — and runs a single-operand
    unstable sort (keys are unique: i is) instead of a 3-operand stable
    sort.  Labels and times are recovered from the key bits (time =
    T-1-i), so the result is bit-identical to the buffer-and-stable-sort
    form.

    Args:
      fin: [B] i32 final beam-head ids.
      ids_log: per-step entry-tip ids — [T, K, B] (the Triton kernel's
        layout, ``tips_major=True``) or [T, B, K] (the scan engines',
        ``tips_major=False``); neither needs a transpose.
      T, K, A: static dims.

    Returns (labels_rev [B, T], times_rev [B, T], count [B]).
    """
    B = fin.shape[0]
    KA = np.int32(K * A)

    def step(cur, xs):
        ids_t, t = xs  # [KP, B] or [B, K], scalar
        ok = cur >= 0
        safe = jnp.maximum(cur, 0)
        tt = safe // KA
        r = safe % KA
        k = r // np.int32(A)
        a = r % np.int32(A)
        hit = ok & (tt == t)
        par = jnp.full_like(cur, -2)
        for kk in range(K):
            tip = ids_t[kk] if tips_major else ids_t[:, kk]
            par = jnp.where(k == kk, tip, par)
        cur = jnp.where(hit, par, cur)
        lab1 = jnp.where(hit, a + 1, 0)  # 0 = no emit
        return cur, lab1

    ts = jnp.arange(T - 1, -1, -1, dtype=jnp.int32)
    _, lab1 = jax.lax.scan(
        step, fin.astype(jnp.int32), (ids_log[::-1], ts)
    )  # lab1: [T, B], row i is t = T-1-i (descending t = leaf-first)

    lab_bits, t_bits = _key_bits(T, A)
    if lab_bits + t_bits <= 30:
        i_col = jnp.arange(T, dtype=jnp.int32)[:, None] << lab_bits
        gap = jnp.int32(1) << (lab_bits + t_bits)
        key = jnp.where(lab1 == 0, gap, 0) | i_col | lab1
        labels_rev, times_rev = _sort_unpack_keys(key.T, T, lab_bits, t_bits)
    else:  # T too long for the packed key: 3-operand stable sort
        i_col = jnp.arange(T, dtype=jnp.int32)[:, None]
        labs = jnp.where(lab1 == 0, -1, lab1 - 1).T
        tvs = jnp.where(lab1 == 0, -1, np.int32(T - 1) - i_col).T
        k1 = (labs < 0).astype(jnp.int32)
        _, labels_rev, times_rev = jax.lax.sort(
            (k1, labs, tvs), dimension=-1, is_stable=True, num_keys=1
        )
    count = jnp.sum((labels_rev >= 0).astype(jnp.int32), axis=-1)
    return labels_rev, times_rev, count


def _traceback_scan_batch_tbk(fin, ids_log_tbk, T, K, A):
    """_traceback_scan_batch for the scan engines' [T, B, K] id-log layout."""
    return _traceback_scan_batch(fin, ids_log_tbk, T, K, A, tips_major=False)


def _key_bits(T, A):
    """(lab_bits, t_bits) of the packed compaction key (see above)."""
    lab_bits = max(int(A).bit_length(), 1)  # holds lab+1 in [0, A]
    t_bits = max(int(max(T, 1) - 1).bit_length(), 1)
    return lab_bits, t_bits


def _sort_unpack_keys(key_bt, T, lab_bits, t_bits):
    """Sort [B, T] packed keys and unpack (labels_rev, times_rev).

    Key layout (built by _traceback_scan_batch's scan):
    ``no_emit_gap | (i << lab_bits) | (label + 1)``
    with i the backward scan step (t = T - 1 - i), so ascending order is
    emits leaf-first, padding last.  Keys are unique per row (i is).
    """
    gap = jnp.int32(1) << (lab_bits + t_bits)
    key = jax.lax.sort(key_bt, dimension=-1, is_stable=False)
    valid = key < gap
    labels_rev = jnp.where(valid, (key & ((1 << lab_bits) - 1)) - 1, -1)
    i_of = (key >> lab_bits) & ((1 << t_bits) - 1)
    times_rev = jnp.where(valid, np.int32(T - 1) - i_of, -1)
    return labels_rev, times_rev
