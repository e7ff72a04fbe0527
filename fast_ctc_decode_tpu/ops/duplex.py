"""2-D duplex pair-consensus beam search (plain + CRF) on device arrays.

Reference semantics: /root/reference/src/duplex.rs (beam_search 443-650,
crf_beam_search 652-834).  The algorithm (Silvestre-Ryan & Holmes pair
consensus) runs a prefix beam search over network_1 time; every suffix-tree
node additionally carries a *banded forward-DP vector over network_2 time*
("SecondaryProbs", duplex.rs:151-210) for its prefix, windowed by a caller
envelope ``[T1, 2]``.  A hypothesis scores as
``prob_1.probability() * max(band totals)`` — all in log-space f32
(duplex.rs:144-149).

Accelerator-first redesign:

 - Bands are fixed-width rows ``band_label/band_gap [max_nodes, W]`` with a
   per-node ``offset/len`` window, where the static width
   ``W = max(hi) - min(lo) + 1`` is derived from the envelope on the host.
   The reference's ``discard_until`` becomes a dynamic roll + window shrink.

 - Building a new child's band (duplex.rs:212-249) is vectorized over ALL
   candidate children of the step at once: one ``lax.scan`` over the t2
   window with ``[K, A]`` lanes; only the children actually allocated are
   scattered into the band arrays.

 - Band *extension* (duplex.rs:338-387, triggered only when the envelope's
   upper bound grows, parents before children) runs as a statically-unrolled
   loop over the node-sorted beam slots.  The host inspects the envelope:
   with a non-growing upper bound (including the default full-range
   envelope) the entire extension phase is compiled out.

 - log-space arithmetic uses exact exp/log1p on the VPU — the reference's
   ``fastexp`` polynomial (src/fastexp.rs) is a scalar-CPU trick with no
   reason to exist on vector hardware; this matches the reference built without the ``fastexp``
   feature.  The logsumexp orders operands by magnitude exactly like
   LogSpace::Add (duplex.rs:42-63), including NaN propagation, and
   LogSpace::max never admits NaN (duplex.rs:33-39).

 - The reference quirk that the expansion loop iterates a *node-sorted* beam
   on steps where the upper bound grew (the in-place sort at duplex.rs:493)
   is reproduced: the beam is re-ordered by node id on exactly those steps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .. import errors
from .beam import _allocate_nodes_core, _traceback

NEG = jnp.float32(-jnp.inf)
POS_INF = jnp.float32(jnp.inf)
_I32_MAX = np.iinfo(np.int32).max

# the reference-ordering log-space primitives are shared with the fast
# engine so the two duplex engines can never drift apart
from .duplex_fast import ls_add, ls_max  # noqa: E402


class DuplexCarry(NamedTuple):
    node: jnp.ndarray  # [K] i32
    state: jnp.ndarray  # [K] i32 (CRF)
    p1l: jnp.ndarray  # [K] f32 log label prob
    p1g: jnp.ndarray  # [K] f32 log gap prob
    p2m: jnp.ndarray  # [K] f32 log max band prob
    valid: jnp.ndarray  # [K] bool
    parent: jnp.ndarray  # [N] i32
    label: jnp.ndarray  # [N] i32
    child: jnp.ndarray  # [N+1, A] i32
    blab: jnp.ndarray  # [N, W] f32 band label probs
    bgap: jnp.ndarray  # [N, W] f32 band gap probs
    boff: jnp.ndarray  # [N] i32 band offset (t2 of slot 0)
    blen: jnp.ndarray  # [N] i32 band valid length
    bmax: jnp.ndarray  # [N] f32 band max total
    n_nodes: jnp.ndarray  # scalar i32
    last_upper: jnp.ndarray  # scalar i32
    err: jnp.ndarray  # scalar i32


def _band_get(carry: DuplexCarry, root_gap, nodes, t2_idx, N, W, Wr):
    """Fetch (label, gap) band values for `nodes [K]` at `t2_idx [K, J]`,
    where each row of ``t2_idx`` is consecutive (t2_idx[k, j] = start_k + j).

    Virtual root (node < 0) reads the precomputed root band (offset -1,
    gap-only — duplex.rs:389-409); out-of-window reads are ProbPair::zero.

    Implementation note: a 2-D ``arr[rows, cols]`` gather inside a scan
    lowers to a general gather.  Because the column index is consecutive
    per row, each row is one ``dynamic_slice`` of width W from the band
    table plus a roll — K tiny slices instead of a K*W gather.
    """
    K = nodes.shape[0]
    is_root = nodes < 0
    safe = jnp.clip(nodes, 0, N - 1)
    off = jnp.where(is_root, -1, jnp.take(carry.boff, safe))
    ln = jnp.where(is_root, Wr, jnp.take(carry.blen, safe))
    idx = t2_idx - off[:, None]
    ok = (idx >= 0) & (idx < ln[:, None])
    rows_l = []
    rows_g = []
    for k in range(K):
        row_l = jax.lax.dynamic_slice(carry.blab, (safe[k], 0), (1, W))[0]
        row_g = jax.lax.dynamic_slice(carry.bgap, (safe[k], 0), (1, W))[0]
        # row column j must read band slot idx[k, j] = j + (idx[k, 0]);
        # a roll by idx[k, 0] aligns it (out-of-range lanes are masked)
        shift = idx[k, 0]
        rows_l.append(jnp.roll(row_l, -shift))
        rows_g.append(jnp.roll(row_g, -shift))
    l_band = jnp.stack(rows_l)
    g_band = jnp.stack(rows_g)
    J = t2_idx.shape[1]
    if J != W:
        l_band = l_band[:, :J]
        g_band = g_band[:, :J]
    # root reads are consecutive too (idx[k, 0] >= 0 for root rows): one
    # dynamic_slice per row instead of a [K, J] gather
    rg_pad = jnp.pad(root_gap, (0, J))
    g_root = jnp.stack(
        [
            jax.lax.dynamic_slice(
                rg_pad, (jnp.clip(idx[k, 0], 0, Wr - 1),), (J,)
            )
            for k in range(K)
        ]
    )
    lab = jnp.where(ok & ~is_root[:, None], l_band, NEG)
    gap = jnp.where(ok, jnp.where(is_root[:, None], g_root, g_band), NEG)
    return lab, gap


def _build_bands(carry, l2_rows_fn, root_gap, lo, hi, is_rep, tstate, N, A, K, W, Wr):
    """Vectorized build_secondary_probs (duplex.rs:212-249) for all [K, A]
    candidate children at once.  `l2_rows_fn(t2, tstate)` returns the [K, A+1]
    log-prob rows of network_2 at time t2 (handles the CRF state gather).
    Returns (blab [K,A,W], bgap [K,A,W], bmax [K,A])."""
    t2_idx = lo + jnp.arange(W, dtype=jnp.int32)[None, :] - 1  # [1, W] -> broadcast
    pv_lab, pv_gap = _band_get(
        carry, root_gap, carry.node, jnp.broadcast_to(t2_idx, (K, W)), N, W, Wr
    )
    pv_tot = ls_add(pv_lab, pv_gap)  # [K, W]

    def step(last, j):
        last_lab, last_gap = last  # [K, A]
        t2 = lo + j
        rows = l2_rows_fn(t2, tstate)  # [K, A+1]
        p0 = rows[:, 0]  # [K]
        pl = rows[:, 1:]  # [K, A]
        tot_last = ls_add(last_lab, last_gap)
        gap_new = tot_last + p0[:, None]
        base = jnp.where(is_rep, pv_gap[:, j][:, None], pv_tot[:, j][:, None])
        lab_new = pl + ls_add(last_lab, base)
        return (lab_new, gap_new), (lab_new, gap_new)

    init = (jnp.full((K, A), NEG), jnp.full((K, A), NEG))
    # the per-cell work is tiny ([K, A] elementwise), so the sequential
    # band scan is dominated by per-step scan overhead — unroll amortizes it
    _, (labs, gaps) = jax.lax.scan(
        step, init, jnp.arange(W, dtype=jnp.int32), unroll=8
    )
    blab = jnp.moveaxis(labs, 0, -1)  # [K, A, W]
    bgap = jnp.moveaxis(gaps, 0, -1)
    tot = ls_add(blab, bgap)
    jmask = (jnp.arange(W, dtype=jnp.int32)[None, None, :] < (hi - lo))
    tot = jnp.where(jmask & ~jnp.isnan(tot), tot, NEG)
    bmax = jnp.max(tot, axis=-1)
    return blab, bgap, bmax


def _extend_bands(
    carry, l2_row_fn, root_gap, lo, hi, ext_flag, N, A, K, W, Wr, Wext, crf
):
    """Band extension for live beam nodes, parents before children
    (duplex.rs:490-522 + extend_secondary_probs 338-387).  The beam in
    `carry` must already be node-sorted.  Statically unrolled over the K
    slots; each slot runs a masked fori over at most Wext new t2 entries.
    `l2_row_fn(t2, state)` returns the [A+1] log-prob row."""
    blab, bgap, boff, blen, bmax = (
        carry.blab,
        carry.bgap,
        carry.boff,
        carry.blen,
        carry.bmax,
    )
    jidx = jnp.arange(W, dtype=jnp.int32)

    for s in range(K):
        n = carry.node[s]
        act = ext_flag & (n >= 0) & carry.valid[s]
        n0 = jnp.clip(n, 0, N - 1)
        off = jnp.take(boff, n0)
        ln = jnp.take(blen, n0)
        row_lab = blab[n0]
        row_gap = bgap[n0]

        # discard_until(lo - 1) + update_max(lo, hi)  (duplex.rs:350-359)
        do_discard = act & (lo > off)
        shift = (lo - 1) - off
        sh_lab = jnp.roll(row_lab, -shift)
        sh_gap = jnp.roll(row_gap, -shift)
        emptied = (ln - shift) <= 0
        newL = jnp.where(emptied, 0, ln - shift)
        newoff = jnp.where(emptied, lo, lo - 1)
        off2 = jnp.where(do_discard, newoff, off)
        L2 = jnp.where(do_discard, newL, ln)
        row_lab = jnp.where(do_discard, sh_lab, row_lab)
        row_gap = jnp.where(do_discard, sh_gap, row_gap)
        t2s = off2 + jidx
        win = (jidx < L2) & (t2s >= lo) & (t2s < hi)
        tots = ls_add(row_lab, row_gap)
        tots = jnp.where(win & ~jnp.isnan(tots), tots, NEG)
        m2 = jnp.max(tots)
        mx = jnp.where(do_discard, m2, jnp.take(bmax, n0))

        # extend from current end to hi
        par = jnp.take(carry.parent, n0)
        lbl = jnp.take(carry.label, n0)
        par_lbl = jnp.where(
            par >= 0, jnp.take(carry.label, jnp.clip(par, 0, N - 1)), -1
        )
        # the CRF extension recurrence has no repeat branch (duplex.rs:
        # 323-328); only the plain variant distinguishes repeats (366-377)
        prep = (par_lbl == lbl) if not crf else jnp.asarray(False)
        st = carry.state[s]
        cur_end = off2 + L2
        n_new = hi - cur_end
        last_lab = jnp.where(L2 > 0, row_lab[jnp.clip(L2 - 1, 0, W - 1)], NEG)
        last_gap = jnp.where(L2 > 0, row_gap[jnp.clip(L2 - 1, 0, W - 1)], NEG)

        # data-dependent trip count: ``Wext`` only bounds the worst case (a
        # pruned node re-derived after many steps catches up over the whole
        # missed range), but the typical extension is the per-step envelope
        # growth of 1-2 cells — a fori over the global bound made every
        # step pay for the catch-up case (~460 masked iterations on a
        # diagonal envelope)
        def jcond(stt):
            j = stt[0]
            return act & (j < n_new) & (j < Wext)

        def jbody(stt):
            j, row_lab, row_gap, last_lab, last_gap, mx = stt
            t2 = cur_end + j
            row = l2_row_fn(t2, st)  # [A+1]
            gap_n = ls_add(last_lab, last_gap) + row[0]
            # parent band read from the *updated* arrays (parents were
            # extended in an earlier slot iteration — duplex.rs:493)
            pvl, pvg = _parent_get_scalar(
                blab, bgap, boff, blen, root_gap, par, t2 - 1, N, W, Wr
            )
            base = jnp.where(prep, pvg, ls_add(pvl, pvg))
            lab_n = jnp.take(row, lbl + 1) + ls_add(last_lab, base)
            widx = jnp.clip(t2 - off2, 0, W - 1)
            row_lab = row_lab.at[widx].set(lab_n)
            row_gap = row_gap.at[widx].set(gap_n)
            tot_n = ls_add(lab_n, gap_n)
            mx2 = ls_max(mx, tot_n)
            return (j + 1, row_lab, row_gap, lab_n, gap_n, mx2)

        _, row_lab, row_gap, last_lab, last_gap, mx = jax.lax.while_loop(
            jcond,
            jbody,
            (jnp.int32(0), row_lab, row_gap, last_lab, last_gap, mx),
        )

        wrow = jnp.where(act, n0, N)  # row N is OOB -> dropped
        blab = blab.at[wrow].set(row_lab, mode="drop")
        bgap = bgap.at[wrow].set(row_gap, mode="drop")
        boff = boff.at[wrow].set(off2, mode="drop")
        blen = blen.at[wrow].set(jnp.maximum(L2, hi - off2), mode="drop")
        bmax = bmax.at[wrow].set(mx, mode="drop")

    return carry._replace(blab=blab, bgap=bgap, boff=boff, blen=blen, bmax=bmax)


def _parent_get_scalar(blab, bgap, boff, blen, root_gap, node, t2, N, W, Wr):
    """Scalar band fetch against explicit (possibly updated) band arrays."""
    is_root = node < 0
    safe = jnp.clip(node, 0, N - 1)
    off = jnp.where(is_root, -1, jnp.take(boff, safe))
    ln = jnp.where(is_root, Wr, jnp.take(blen, safe))
    idx = t2 - off
    ok = (idx >= 0) & (idx < ln)
    lab = jnp.where(
        ok & ~is_root, blab[safe, jnp.clip(idx, 0, W - 1)], NEG
    )
    gap = jnp.where(
        ok,
        jnp.where(
            is_root,
            jnp.take(root_gap, jnp.clip(idx, 0, Wr - 1)),
            bgap[safe, jnp.clip(idx, 0, W - 1)],
        ),
        NEG,
    )
    return lab, gap


# valid candidates with a true -inf log score must stay selectable (the
# reference keeps them in the beam; only the *absence* of a push empties
# a slot), so selection maps them to a finite key strictly below any real
# log score (|log p| is bounded by ~T * 103 in f32) and keeps -inf as the
# invalid fill.
_NEG_VALID = np.float32(-3.0e38)


def _duplex_merge_select(node, lv, gv, p2m, state, valid, bmax, K, N):
    """Top-K selection over an already-merged duplex candidate plane.

    The step functions merge analytically — a node receives at most blank
    (gap field) + stay + one arrival (label field, ls_add is commutative
    and NEG is its exact identity) — so ``node`` is duplicate-free among
    ``valid`` rows and the reference's sort-based dedup (duplex.rs:595-618)
    is unnecessary.  prob_2_max refreshes from tree data for real nodes
    (duplex.rs:613-618); selection is K rounds of (max score, tie -> min
    node id), the same order as the reference's sort (duplex.rs:619-635).
    """
    is_node = node >= 0
    p2m_r = jnp.where(
        valid & is_node, jnp.take(bmax, jnp.clip(node, 0, N - 1)), p2m
    )
    score = ls_add(lv, gv) + p2m_r

    cnt = jnp.sum(valid.astype(jnp.int32))
    nan_flag = (cnt >= 2) & jnp.any(valid & jnp.isnan(score))
    empty_flag = cnt == 0

    key = jnp.where(
        valid,
        jnp.where(
            jnp.isnan(score),
            POS_INF,
            jnp.where(score == NEG, _NEG_VALID, score + jnp.float32(0.0)),
        ),
        NEG,
    )

    sel = []
    for _ in range(K):
        mx = jnp.max(key)
        ok = mx > NEG
        at = key == mx
        sid = jnp.min(jnp.where(at, node, _I32_MAX))
        chosen = at & (node == sid)

        def pick_f(arr):
            return jnp.max(jnp.where(chosen, arr, NEG))

        def pick_i(arr):
            return jnp.sum(jnp.where(chosen, arr, 0))

        sel.append(
            (
                jnp.where(ok, sid, -2),
                pick_f(lv),
                pick_f(gv),
                pick_f(p2m_r),
                pick_i(state),
                ok,
            )
        )
        key = jnp.where(chosen, NEG, key)

    node_f, l_f, g_f, p2_f, st_f, ok_f = (
        jnp.stack([s[i] for s in sel]) for i in range(6)
    )
    return node_f, l_f, g_f, p2_f, st_f, ok_f, nan_flag, empty_flag


def _alloc_nodes_duplex(carry, needs_new, N, A, K, active):
    """Node allocation in add_node order (shared core with the 1D engine;
    the duplex tree carries no emit times)."""
    new_id, parent, label, _, child, n_nodes, overflow = _allocate_nodes_core(
        carry.node, carry.parent, carry.label, carry.child, carry.n_nodes,
        needs_new, active, N, A, K,
    )
    return new_id, parent, label, child, n_nodes, overflow


def _sort_beam_by_node(carry: DuplexCarry):
    """Node-ascending beam order (invalid slots last), as the reference's
    in-place sort before extension (duplex.rs:493)."""
    key = jnp.where(carry.valid, carry.node, _I32_MAX)
    _, node, state, p1l, p1g, p2m, valid = jax.lax.sort(
        (key, carry.node, carry.state, carry.p1l, carry.p1g, carry.p2m, carry.valid),
        dimension=-1,
        is_stable=True,
        num_keys=1,
    )
    return carry._replace(
        node=node, state=state, p1l=p1l, p1g=p1g, p2m=p2m, valid=valid
    )


def _make_duplex_step(
    *, A, S, K, N, W, Wr, Wext, collapse, crf, needs_ext, threshold_log, T2
):
    """Build the per-t1 scan step for plain (crf=False) or CRF (crf=True)
    duplex search."""

    def l2_row_fn_factory(l2):
        if crf:
            T2_, S_, A1 = l2.shape
            flat = l2.reshape(T2_ * S_, A1)

            def row_fn(t2, state):
                i = jnp.clip(t2, 0, T2_ - 1) * S_ + jnp.clip(state, 0, S_ - 1)
                return jnp.take(flat, i, axis=0)

            def rows_fn(t2, tstate):  # [K] states -> [K, A+1]
                i = jnp.clip(t2, 0, T2_ - 1) * S_ + jnp.clip(tstate, 0, S_ - 1)
                return jnp.take(flat, i, axis=0)

        else:

            def row_fn(t2, state):
                return jnp.take(l2, jnp.clip(t2, 0, l2.shape[0] - 1), axis=0)

            def rows_fn(t2, tstate):
                row = jnp.take(l2, jnp.clip(t2, 0, l2.shape[0] - 1), axis=0)
                return jnp.broadcast_to(row[None, :], (K, row.shape[0]))

        return row_fn, rows_fn

    def step(carry_l2, xs):
        carry, l2, root_gap, length = carry_l2
        p1row, lo, hi, t = xs
        row_fn, rows_fn = l2_row_fn_factory(l2)

        in_range = t < length
        env_bad = in_range & ((lo >= hi) | (lo > carry.last_upper))
        alive = carry.err == errors.OK
        active = alive & in_range & ~env_bad
        err0 = jnp.where(
            alive & env_bad, errors.INVALID_ENVELOPE, carry.err
        ).astype(jnp.int32)
        carry = carry._replace(err=err0)

        ext_flag = active & (hi > carry.last_upper)
        if needs_ext:
            # the reference node-sorts the beam in place before extension,
            # so expansion order changes on exactly those steps (duplex.rs:493)
            sorted_c = _sort_beam_by_node(carry)
            beam_c = jax.tree_util.tree_map(
                lambda x, y: jnp.where(ext_flag, x, y), sorted_c, carry
            )
            carry = _extend_bands(
                beam_c, row_fn, root_gap, lo, hi, ext_flag, N, A, K, W, Wr,
                Wext, crf
            )
        carry = carry._replace(
            last_upper=jnp.where(active, hi, carry.last_upper)
        )

        # ---------------- expansion ----------------
        if crf:
            # CRF network_1 row gather by per-tip state: p1row is [S, A+1]
            prow = jnp.take(p1row, jnp.clip(carry.state, 0, S - 1), axis=0)
        else:
            prow = jnp.broadcast_to(p1row[None, :], (K, A + 1))
        p0 = prow[:, 0]
        plab = prow[:, 1:]

        tip_label = jnp.where(
            carry.node >= 0, jnp.take(carry.label, jnp.maximum(carry.node, 0)), -1
        )
        rows_idx = jnp.clip(carry.node + 1, 0, N)
        c = jnp.take(carry.child, rows_idx, axis=0)  # [K, A]

        lbl_idx = jnp.arange(A, dtype=jnp.int32)
        if collapse and not crf:
            is_rep = tip_label[:, None] == lbl_idx[None, :]
        else:
            is_rep = jnp.zeros((K, A), bool)

        pushed_lab = carry.valid[:, None] & ~(plab < threshold_log)
        gap_pos = carry.p1g > NEG
        needs_new = pushed_lab & (c < 0) & (~is_rep | gap_pos[:, None])

        new_id, parent, label, child, n_nodes, overflow = _alloc_nodes_duplex(
            carry, needs_new, N, A, K, active
        )
        nid = jnp.where(c >= 0, c, new_id)

        # build bands for candidate children; scatter only allocated ones
        blab_c, bgap_c, bmax_c = _build_bands(
            carry, rows_fn, root_gap, lo, hi, is_rep, carry.state, N, A, K, W, Wr
        )
        flat_ids = jnp.where(
            (new_id >= 0) & active, new_id, N
        ).reshape(-1)  # N -> dropped
        blab = carry.blab.at[flat_ids].set(
            blab_c.reshape(K * A, W), mode="drop"
        )
        bgap = carry.bgap.at[flat_ids].set(
            bgap_c.reshape(K * A, W), mode="drop"
        )
        boff = carry.boff.at[flat_ids].set(lo, mode="drop")
        blen = carry.blen.at[flat_ids].set(hi - lo, mode="drop")
        bmax = carry.bmax.at[flat_ids].set(bmax_c.reshape(-1), mode="drop")

        p1tot = ls_add(carry.p1l, carry.p1g)

        # ---- analytic merge (duplex.rs:530-618): a node receives at most
        # blank from the tip on it (gap field), stay from that tip on a
        # collapsed repeat, and ONE nid-targeted mass (arrival or fork) —
        # ls_add is commutative with NEG as exact identity, so the two
        # label-field contributions fold in any order.  nid-targeted
        # masses landing on live tips route into the tip rows; the rest
        # (children unique per (parent, label)) are duplicate-free.
        push_b = carry.valid & (p0 > threshold_log)
        g_tip = jnp.where(push_b, p1tot + p0, NEG)

        if crf:
            # arrivals only (duplex.rs:754-779)
            m_nid = p1tot[:, None] + plab
            push_nid = pushed_lab & (nid >= 0)
            stay_l = jnp.full((K,), NEG)
            stay_any = jnp.zeros((K,), bool)
            state_l = ((carry.state[:, None] * A) % S + lbl_idx[None, :]).astype(
                jnp.int32
            )
            state_f = state_l.reshape(-1)
        else:
            # stay/fork interleave like 1D (duplex.rs:536-592)
            m_nid = jnp.where(
                is_rep, carry.p1g[:, None] + plab, p1tot[:, None] + plab
            )
            push_nid = pushed_lab & (nid >= 0)
            push_stay = pushed_lab & is_rep
            stay_l = jnp.max(
                jnp.where(push_stay, carry.p1l[:, None] + plab, NEG), axis=1
            )  # at most one label per tip (a == tip label)
            stay_any = jnp.any(push_stay, axis=1)
            state_f = jnp.zeros((K * A,), jnp.int32)

        tgt = jnp.where(push_nid, nid, -9)
        eq = (tgt[None, :, :] == carry.node[:, None, None]) & carry.valid[
            :, None, None
        ]  # [K tips, K, A]
        recv = jnp.max(
            jnp.where(eq, m_nid[None, :, :], NEG), axis=(1, 2)
        )  # one arrival max per node
        recv_any = jnp.any(eq, axis=(1, 2))
        matched = jnp.any(eq, axis=0)

        l_tip = ls_add(stay_l, recv)
        tip_valid = push_b | stay_any | recv_any

        node_all = jnp.concatenate([carry.node, nid.reshape(-1)])
        l_all = jnp.concatenate([l_tip, m_nid.reshape(-1)])
        g_all = jnp.concatenate([g_tip, jnp.full((K * A,), NEG)])
        p2_all = jnp.concatenate([carry.p2m, jnp.full((K * A,), NEG)])
        valid_all = jnp.concatenate(
            [tip_valid, (push_nid & ~matched).reshape(-1)]
        )
        state_all = jnp.concatenate([carry.state, state_f])

        node_n, l_n, g_n, p2_n, st_n, valid_n, nan_flag, empty_flag = (
            _duplex_merge_select(
                node_all, l_all, g_all, p2_all, state_all, valid_all, bmax,
                K, N,
            )
        )

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

        node_n = jnp.where(valid_n, node_n, -2)
        new_carry = carry._replace(
            node=jnp.where(active, node_n, carry.node),
            state=jnp.where(active, st_n, carry.state),
            p1l=jnp.where(active, jnp.where(valid_n, l_n, NEG), carry.p1l),
            p1g=jnp.where(active, jnp.where(valid_n, g_n, NEG), carry.p1g),
            p2m=jnp.where(active, jnp.where(valid_n, p2_n, NEG), carry.p2m),
            valid=jnp.where(active, valid_n, carry.valid),
            parent=parent,
            label=label,
            child=child,
            blab=blab,
            bgap=bgap,
            boff=boff,
            blen=blen,
            bmax=bmax,
            n_nodes=n_nodes,
            err=err,
        )
        return (new_carry, l2, root_gap, length), None

    return step


def _init_duplex_carry(K, N, A, W, init_state):
    slot = jnp.arange(K, dtype=jnp.int32)
    return DuplexCarry(
        node=jnp.where(slot == 0, jnp.int32(-1), jnp.int32(-2)),
        state=jnp.where(slot == 0, jnp.asarray(init_state, jnp.int32), 0),
        p1l=jnp.full((K,), NEG),
        p1g=jnp.where(slot == 0, jnp.float32(0.0), NEG),
        p2m=jnp.where(slot == 0, jnp.float32(0.0), NEG),
        valid=slot == 0,
        parent=jnp.full((N,), -2, jnp.int32),
        label=jnp.full((N,), -1, jnp.int32),
        child=jnp.full((N + 1, A), -1, jnp.int32),
        blab=jnp.full((N, W), NEG),
        bgap=jnp.full((N, W), NEG),
        boff=jnp.zeros((N,), jnp.int32),
        blen=jnp.zeros((N,), jnp.int32),
        bmax=jnp.full((N,), NEG),
        n_nodes=jnp.int32(0),
        last_upper=jnp.int32(0),
        err=jnp.int32(0),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "beam_size",
        "collapse_repeats",
        "max_nodes",
        "W",
        "Wr",
        "Wext",
        "needs_ext",
        "crf",
    ),
)
def duplex_device(
    l1: jnp.ndarray,  # [T1, A+1] (or [T1, S, A+1] for crf) log probs
    l2: jnp.ndarray,  # [T2, A+1] (or [T2, S, A+1]) log probs
    root_gap: jnp.ndarray,  # [Wr] root band gap log probs
    lo: jnp.ndarray,  # [T1] i32 clamped lower bounds
    hi: jnp.ndarray,  # [T1] i32 clamped upper bounds
    threshold_log: jnp.ndarray,
    init_state: jnp.ndarray,  # scalar i32 (CRF; 0 otherwise)
    length: Optional[jnp.ndarray] = None,  # scalar i32 valid t1 steps
    *,
    beam_size: int,
    collapse_repeats: bool,
    max_nodes: int,
    W: int,
    Wr: int,
    Wext: int,
    needs_ext: bool,
    crf: bool,
):
    T1 = l1.shape[0]
    if length is None:
        length = jnp.int32(T1)
    A1 = l1.shape[-1]
    A = A1 - 1
    S = l1.shape[1] if crf else 1
    K = beam_size
    N = max_nodes

    carry = _init_duplex_carry(K, N, A, W, init_state)
    step = _make_duplex_step(
        A=A,
        S=S,
        K=K,
        N=N,
        W=W,
        Wr=Wr,
        Wext=Wext,
        collapse=collapse_repeats,
        crf=crf,
        needs_ext=needs_ext,
        threshold_log=jnp.asarray(threshold_log, jnp.float32),
        T2=l2.shape[0],
    )
    xs = (l1, lo, hi, jnp.arange(T1, dtype=jnp.int32))
    (carry, _, _, _), _ = jax.lax.scan(
        step, (carry, l2, root_gap, jnp.asarray(length, jnp.int32)), xs
    )

    times = jnp.zeros_like(carry.label)  # duplex returns no path
    labels_rev, _, count = _traceback(
        carry.node[0], carry.parent, carry.label, times, T1
    )
    return {"labels_rev": labels_rev, "count": count, "err": carry.err}


@functools.partial(
    jax.jit,
    static_argnames=(
        "beam_size", "collapse_repeats", "max_nodes", "W", "Wr", "Wext",
        "needs_ext", "crf",
    ),
)
def duplex_exact_batch(
    l1,  # [B, T1, A+1] log probs ([B, T1, S, A+1] for crf)
    l2,  # [B, T2, A+1]
    root_gap,  # [B, Wr]
    lo,  # [B, T1] i32 per-pair envelopes
    hi,  # [B, T1] i32
    threshold_log,
    init_states,  # [B] i32
    lengths,  # [B] i32 valid t1 steps per read
    *,
    beam_size: int,
    collapse_repeats: bool,
    max_nodes: int,
    W: int,
    Wr: int,
    Wext: int,
    needs_ext: bool,
    crf: bool,
):
    """vmap of the bit-exact tree engine over a batch of pairs.

    Batching amortizes the sequential band DP across reads (XLA vectorizes
    every inner step over B); memory is B x max_nodes x W x 8 bytes of
    band tables."""
    fn = lambda a, b, rg, l, h, s, n: duplex_device(
        a, b, rg, l, h, threshold_log, s, n,
        beam_size=beam_size, collapse_repeats=collapse_repeats,
        max_nodes=max_nodes, W=W, Wr=Wr, Wext=Wext, needs_ext=needs_ext,
        crf=crf,
    )
    return jax.vmap(fn)(l1, l2, root_gap, lo, hi, init_states, lengths)


# ------------------------------------------------------------- host wrappers


def _prep_envelope(envelope: np.ndarray, T2: int):
    lo = np.maximum(envelope[:, 0], 0).astype(np.int32)
    hi = np.minimum(envelope[:, 1], T2).astype(np.int32)
    # tight band width: replay the offset/upper evolution exactly like the
    # fast engine's EnvPrep — discard_until only fires at extension steps,
    # so the widest window any band ever holds is far below the loose
    # hi.max()-lo.min()+1 span for moving envelopes (6x smaller tables on a
    # diagonal alignment envelope)
    from .duplex_fast import _prep_envelope_fast

    ep = _prep_envelope_fast(envelope, T2)
    W = ep.W
    Wr = int(min(max(envelope[0, 1], 0), T2)) + 1 if len(hi) else 1
    needs_ext = bool(np.any(hi[1:] > hi[:-1]))
    Wext = int(max(hi.max() - hi.min(), 0)) if needs_ext else 0
    return lo, hi, W, Wr, needs_ext, Wext


def _duplex_max_nodes(T1, K, A, W, cap_bytes=2_000_000_000):
    worst = T1 * K * A + 8
    by_mem = max(cap_bytes // max(W * 8, 1), 1024)
    return int(min(worst, by_mem))


def beam_search_duplex_host(
    net1: np.ndarray,
    net2: np.ndarray,
    alphabet,
    envelope: np.ndarray,
    beam_size: int,
    beam_cut_threshold: float,
    collapse_repeats: bool,
    max_nodes: Optional[int] = None,
) -> str:
    """Host wrapper: log-convert, envelope prep, kernel, string assembly."""
    T1, A1 = net1.shape
    T2 = net2.shape[0]
    lo, hi, W, Wr, needs_ext, Wext = _prep_envelope(envelope, T2)
    if max_nodes is None:
        max_nodes = _duplex_max_nodes(T1, beam_size, A1 - 1, W)

    with np.errstate(divide="ignore", invalid="ignore"):
        l1 = np.log(net1, dtype=np.float32)
        l2 = np.log(net2, dtype=np.float32)
        thr = np.float32(np.log(np.float32(beam_cut_threshold)))
        # root band: cumulative blank run over net2 (duplex.rs:389-409)
        root_gap = np.concatenate(
            [[np.float32(0.0)], np.cumsum(l2[: Wr - 1, 0], dtype=np.float32)]
        ).astype(np.float32)

    out = duplex_device(
        l1,
        l2,
        root_gap,
        lo,
        hi,
        thr,
        np.int32(0),
        beam_size=int(beam_size),
        collapse_repeats=bool(collapse_repeats),
        max_nodes=int(max_nodes),
        W=W,
        Wr=Wr,
        Wext=Wext,
        needs_ext=needs_ext,
        crf=False,
    )
    errors.raise_for_status(int(out["err"]))
    n = int(out["count"])
    labels_rev = np.asarray(out["labels_rev"])[:n]
    return "".join(alphabet[int(l) + 1] for l in labels_rev[::-1])


def crf_beam_search_duplex_host(
    net1: np.ndarray,
    init1: np.ndarray,
    net2: np.ndarray,
    init2: np.ndarray,
    alphabet,
    envelope: np.ndarray,
    beam_size: int,
    beam_cut_threshold: float,
    max_nodes: Optional[int] = None,
) -> str:
    T1, S, A1 = net1.shape
    T2 = net2.shape[0]
    n_base = A1 - 1
    lo, hi, W, Wr, needs_ext, Wext = _prep_envelope(envelope, T2)
    if max_nodes is None:
        max_nodes = _duplex_max_nodes(T1, beam_size, n_base, W)

    with np.errstate(divide="ignore", invalid="ignore"):
        l1 = np.log(net1, dtype=np.float32)
        l2 = np.log(net2, dtype=np.float32)
        thr = np.float32(np.log(np.float32(beam_cut_threshold)))

    # crf root band walks the blank state trajectory (duplex.rs:411-441)
    state = int(np.argmax(init2))
    root_gap = np.empty((Wr,), np.float32)
    cur = np.float32(0.0)
    root_gap[0] = cur
    for i in range(Wr - 1):
        cur = np.float32(cur + l2[i, state, 0])
        root_gap[i + 1] = cur
        state = (state * n_base) % S

    out = duplex_device(
        l1,
        l2,
        root_gap,
        lo,
        hi,
        thr,
        np.int32(np.argmax(init1)),
        beam_size=int(beam_size),
        collapse_repeats=False,
        max_nodes=int(max_nodes),
        W=W,
        Wr=Wr,
        Wext=Wext,
        needs_ext=needs_ext,
        crf=True,
    )
    errors.raise_for_status(int(out["err"]))
    n = int(out["count"])
    labels_rev = np.asarray(out["labels_rev"])[:n]
    return "".join(alphabet[int(l) + 1] for l in labels_rev[::-1])
