"""Fast 2-D duplex pair-consensus beam search: per-slot bands, no tree.

Throughput engine for duplex decoding (plain + CRF), built on the same
hash-identity design as ops/beam_fast.py.  The exact-tree engine
(ops/duplex.py) carries O(max_nodes x W) band tables through the t1 scan and
runs the band DP as a *sequential* inner scan, giving O(T1 * W) sequential
steps; this engine removes both:

 - **Bands live in beam slots.**  A prefix's banded forward DP over
   network_2 ("SecondaryProbs", /root/reference/src/duplex.rs:151-210) is a
   pure function of the prefix, so the K live hypotheses carry their own
   ``[K, W]`` band rows (circular-buffered by ``t2 % W`` with an
   offset/end window) instead of scattering into a global node table.
   Each slot also carries a copy of its *parent's* band (needed by the
   banded-envelope extension recurrence, duplex.rs:338-387), refreshed
   from the parent's live slot whenever the parent is still in the beam —
   reproducing the reference's behavior that a node's band freezes when it
   leaves the beam.

 - **Band builds are associative scans.**  The per-cell recurrence
   (duplex.rs:212-249)::

       gap(i)   = p0(i) * (label(i-1) + gap(i-1))
       label(i) = pl(i) * (label(i-1) + base(i-1))     # base from parent

   is a first-order affine recurrence on (label, gap) — a 2x2 matrix
   transform per cell — so all W cells are computed in O(log W) depth with
   ``lax.associative_scan`` over log-space (m11, m21, m22, b1, b2)
   coefficients, for all K*A candidate children of a step at once.  The
   reference's fastexp polynomial (src/fastexp.rs) is replaced by exact
   exp/log1p on the VPU.

 - **Merging and selection** reuse the beam_fast machinery: prefix identity
   by 64-bit rolling hash, analytic merge (a node receives at most blank +
   stay + one arrival; ls_add is commutative by its operand ordering, so
   two-term accumulation is order-exact), and K rounds of (max score,
   tie -> min position-coded id) selection.  No renormalization — log space
   needs none, like the reference (duplex.rs:595-635).

Exactness vs the reference ``duplex::beam_search``/``crf_beam_search``:

 - With the **default full-range envelope** the band of a prefix never
   changes after it is built (extension only triggers when the envelope's
   upper bound grows, duplex.rs:490-522), so a re-derived prefix's rebuilt
   band is value-identical to the reference's reused one: sequences match
   exactly up to float ties and the logsumexp regrouping of the associative
   scan (validated against the oracle by tests/test_fast_duplex.py).

 - With a **banded envelope**, a prefix that was pruned from the beam and
   later re-derived gets a fresh band built over the *current* window,
   whereas the reference reuses the old node's band (values computed over
   earlier windows, caught up on extension).  The two differ by the DP mass
   that crossed the moved window edge; the exact-tree engine remains the
   bit-exact reference implementation for banded envelopes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .. import errors
from .beam_fast import (
    _I32_MAX,
    _SEED1,
    _SEED2,
    _mix1,
    _mix2,
    _traceback_positional,
)

NEG = jnp.float32(-jnp.inf)


def ls_add(a, b):
    """LogSpace + (logsumexp) with reference operand ordering (duplex.rs:42-63).

    Ordering by value makes it commutative; ``small == -inf`` short-circuits
    so zero never perturbs the other operand."""
    cond = a <= b
    big = jnp.where(cond, b, a)
    small = jnp.where(cond, a, b)
    return jnp.where(small == NEG, big, big + jnp.log1p(jnp.exp(small - big)))


def ls_max(m, t):
    """LogSpace::max — NaN in ``t`` never replaces ``m`` (duplex.rs:33-39)."""
    return jnp.where(m < t, t, m)


def _nan_clean_max(tot, mask):
    """Masked max that skips NaN entries, as the reference's ls_max fold."""
    v = jnp.where(mask & ~jnp.isnan(tot), tot, NEG)
    return jnp.max(v, axis=-1)


class DuplexFastCarry(NamedTuple):
    # beam identity (as beam_fast)
    id: jnp.ndarray  # [K] i32 position-coded node id; -1 root, -2 empty
    h1: jnp.ndarray  # [K] u32 prefix hash
    h2: jnp.ndarray  # [K] u32
    ph1: jnp.ndarray  # [K] u32 parent prefix hash (for pb refresh)
    ph2: jnp.ndarray  # [K] u32
    lastlab: jnp.ndarray  # [K] i32 last label, -1 root
    plastlab: jnp.ndarray  # [K] i32 parent's last label (repeat flag source)
    state: jnp.ndarray  # [K] i32 CRF tstate used by this node's band
    # probabilities (log space)
    p1l: jnp.ndarray  # [K] f32
    p1g: jnp.ndarray  # [K] f32
    p2m: jnp.ndarray  # [K] f32 band max total
    valid: jnp.ndarray  # [K] bool
    # own band (circular over t2 % W)
    blab: jnp.ndarray  # [K, W] f32
    bgap: jnp.ndarray  # [K, W] f32
    boff: jnp.ndarray  # [K] i32 window start (t2)
    bend: jnp.ndarray  # [K] i32 window end (exclusive t2)
    # parent band copy (frozen unless the parent is live in the beam)
    pblab: jnp.ndarray  # [K, W] f32
    pbgap: jnp.ndarray  # [K, W] f32
    pboff: jnp.ndarray  # [K] i32
    pbend: jnp.ndarray  # [K] i32
    proot: jnp.ndarray  # [K] bool parent is the virtual root
    # scalars
    last_upper: jnp.ndarray  # i32
    err: jnp.ndarray  # i32


def _root_read(root_gap, t2, Wr):
    """Root band gap value at cell t2 (root_gap[i] holds cell t2 = i-1;
    duplex.rs:389-409).  Label part of the root band is always zero."""
    idx = t2 + 1
    ok = (idx >= 0) & (idx < Wr)
    val = jnp.take(root_gap, jnp.clip(idx, 0, Wr - 1))
    return jnp.where(ok, val, NEG)


# ---------------------------------------------------------------- band build


def _affine_combine(c1, c2):
    """Compose two log-space affine maps x -> M x + b on (label, gap):
    first apply ``c1`` (earlier cells), then ``c2`` — the argument order
    ``lax.associative_scan`` uses for an inclusive prefix scan.

    The per-cell map M = [[pl, 0], [p0, p0]] is lower-triangular, and
    lower-triangular structure is closed under composition, so m12 is
    identically zero and the 2x2 composition needs only 4 logsumexps:
    coefficients (m11, m21, m22, b1, b2) with
    (M2, b2) o (M1, b1) = (M2 M1, M2 b1 + b2)."""
    m11a, m21a, m22a, b1a, b2a = c1
    m11b, m21b, m22b, b1b, b2b = c2
    m11 = m11b + m11a
    m21 = ls_add(m21b + m11a, m22b + m21a)
    m22 = m22b + m22a
    b1 = ls_add(m11b + b1a, b1b)
    b2 = ls_add(ls_add(m21b + b1a, m22b + b2a), b2b)
    return (m11, m21, m22, b1, b2)


def _build_band_cells(pl, p0, base, mask):
    """Compute band cells for the recurrence above along the last axis.

    pl/p0/base/mask: [..., W] — label prob, blank prob, parent base at the
    *previous* cell, and cell validity.  Initial (label, gap) is zero, so
    the cell values are the cumulative affine maps' offset parts.
    Returns (lab, gap) [..., W]."""
    zero = jnp.zeros_like(pl)
    negs = jnp.full_like(pl, NEG)
    # per-cell map: lab' = pl*(lab + base); gap' = p0*(lab + gap)
    m11 = jnp.where(mask, pl, zero)  # identity when masked
    m21 = jnp.where(mask, p0, negs)
    m22 = jnp.where(mask, p0, zero)
    b1 = jnp.where(mask, pl + base, negs)
    b2 = negs
    out = jax.lax.associative_scan(
        _affine_combine, (m11, m21, m22, b1, b2), axis=-1
    )
    return out[3], out[4]  # b1, b2 = (label, gap) from zero init


# ---------------------------------------------------------- band extension


def _extend_one_slot(
    carry, rootread, l2r, lo, hi, wb, sel, act, *, K, W, Wext, crf, rel
):
    """Extend the band of the slot picked by one-hot ``sel [K]`` to hi,
    per duplex.rs:338-387 (plain) / 290-336 (CRF): discard below lo-1,
    refresh the window max, then append cells [end, hi) reading the parent
    band copy at the previous cell.  ``l2r(t2, state, lastlab) -> (p0, pl)``
    returns the needed log-prob entries and ``rootread(t2)`` the root band
    gap value.  ``rel`` selects window-relative column addressing (column =
    t2 - wb) instead of the circular t2 %% W layout."""

    def pick(x):
        return jnp.sum(jnp.where(sel, x, 0), axis=0)

    def pickf(x):
        return jnp.sum(jnp.where(sel, x, jnp.float32(0)), axis=0)

    off = pick(carry.boff)
    end = pick(carry.bend)
    lastlab = pick(carry.lastlab)
    plastlab = pick(carry.plastlab)
    state = pick(carry.state)
    proot = jnp.any(sel & carry.proot)
    pboff = pick(carry.pboff)
    pbend = pick(carry.pbend)
    row_lab = jnp.sum(jnp.where(sel[:, None], carry.blab, jnp.float32(0)), axis=0)
    row_gap = jnp.sum(jnp.where(sel[:, None], carry.bgap, jnp.float32(0)), axis=0)
    pb_lab = jnp.sum(jnp.where(sel[:, None], carry.pblab, jnp.float32(0)), axis=0)
    pb_gap = jnp.sum(jnp.where(sel[:, None], carry.pbgap, jnp.float32(0)), axis=0)
    p2m = pickf(carry.p2m)

    # discard_until(lo - 1) + update_max(lo, hi) when the window must slide
    do_discard = act & (lo > off)
    emptied = end <= (lo - 1)
    off2 = jnp.where(do_discard, jnp.where(emptied, lo, lo - 1), off)
    end2 = jnp.where(do_discard & emptied, lo, end)
    t2s = jnp.arange(W, dtype=jnp.int32)
    if rel:
        abs_t2 = wb + t2s
    else:
        # window cells in absolute t2: the circular row holds [off2, end2)
        abs_t2 = off2 + jnp.mod(t2s - jnp.mod(off2, W), W)
    in_win = (abs_t2 >= jnp.maximum(lo, off2)) & (abs_t2 < jnp.minimum(hi, end2))
    tot_row = ls_add(row_lab, row_gap)
    m_new = _nan_clean_max(tot_row, in_win)
    p2m = jnp.where(do_discard, m_new, p2m)

    # the CRF extension recurrence has no repeat branch — base is always
    # the parent's total (duplex.rs:323-328 vs plain duplex.rs:366-377)
    is_rep = (plastlab == lastlab) if not crf else jnp.asarray(False)

    if rel:
        last_col = jnp.clip(end2 - 1 - wb, 0, W - 1)
    else:
        last_col = jnp.mod(jnp.maximum(end2 - 1, 0), W)
    has_last = end2 > off2
    last_lab = jnp.where(has_last, row_lab[last_col], NEG)
    last_gap = jnp.where(has_last, row_gap[last_col], NEG)

    def jbody(j, st):
        row_lab, row_gap, last_lab, last_gap, p2m = st
        t2 = end2 + j
        a = act & (t2 < hi)
        p0, pl = l2r(t2, state, lastlab)
        # parent base at t2 - 1 from the (possibly frozen) parent copy
        pv = t2 - 1
        if rel:
            pcol = jnp.clip(pv - wb, 0, W - 1)
        else:
            pcol = jnp.mod(jnp.maximum(pv, 0), W)
        p_ok = (pv >= pboff) & (pv < pbend) & ~proot
        ppl = jnp.where(p_ok, pb_lab[pcol], NEG)
        ppg = jnp.where(
            proot, rootread(pv), jnp.where(p_ok, pb_gap[pcol], NEG)
        )
        base = jnp.where(is_rep, ppg, ls_add(ppl, ppg))
        gap_n = ls_add(last_lab, last_gap) + p0
        lab_n = pl + ls_add(last_lab, base)
        col = (t2 - wb) if rel else jnp.mod(t2, W)
        wcol = jnp.where(a & (col >= 0) & (col < W), col, W)  # W -> dropped
        row_lab = row_lab.at[wcol].set(lab_n, mode="drop")
        row_gap = row_gap.at[wcol].set(gap_n, mode="drop")
        tot_n = ls_add(lab_n, gap_n)
        p2m = jnp.where(a, ls_max(p2m, tot_n), p2m)
        last_lab = jnp.where(a, lab_n, last_lab)
        last_gap = jnp.where(a, gap_n, last_gap)
        return (row_lab, row_gap, last_lab, last_gap, p2m)

    row_lab, row_gap, last_lab, last_gap, p2m = jax.lax.fori_loop(
        0, Wext, jbody, (row_lab, row_gap, last_lab, last_gap, p2m)
    )
    end3 = jnp.where(act, hi, end2)

    g = lambda new, old: jnp.where(act & sel, new, old)
    g2 = lambda new, old: jnp.where((act & sel)[:, None], new, old)
    carry = carry._replace(
        blab=g2(row_lab[None, :], carry.blab),
        bgap=g2(row_gap[None, :], carry.bgap),
        boff=g(jnp.where(lo > off, off2, off), carry.boff),
        bend=g(end3, carry.bend),
        p2m=g(p2m, carry.p2m),
    )

    # refresh parent copies of slots whose parent is this (just-extended)
    # slot: the reference reads the parent's live tree band (duplex.rs:493)
    h1s = pick(carry.h1).astype(jnp.uint32)
    h2s = pick(carry.h2).astype(jnp.uint32)
    child = (
        act
        & carry.valid
        & (carry.ph1 == h1s)
        & (carry.ph2 == h2s)
        & ~carry.proot
    )
    carry = carry._replace(
        pblab=jnp.where(child[:, None], row_lab[None, :], carry.pblab),
        pbgap=jnp.where(child[:, None], row_gap[None, :], carry.pbgap),
        pboff=jnp.where(child, jnp.where(lo > off, off2, off), carry.pboff),
        pbend=jnp.where(child, end3, carry.pbend),
    )
    return carry


# ------------------------------------------------------------------ the step


def _make_step(
    l2, root_gap, length, *, A, S, K, W, Wr, Wext, collapse, crf, needs_ext,
    static_window, rel_window, D, thr, T2, l2T=None, l2pad=None
):
    KA = K * A
    lbl = jnp.arange(A, dtype=jnp.int32)
    assert not (static_window and rel_window)

    def step(carry, xs):
        if rel_window:
            # window-relative mode (monotone lower bounds): all band
            # columns are t2 - wb with wb = cummax(lo) - 1 == lo - 1, so
            # window indexing is static; the only data movement is a
            # per-read slide by d = wb_t - wb_{t-1} in [0, D]
            p1row, lo, hi, t, l2win, rootwin, d = xs
            wb = lo - 1
        else:
            p1row, lo, hi, t = xs
            wb = jnp.int32(0)  # unused

        in_range = t < length
        env_bad = in_range & ((lo >= hi) | (lo > carry.last_upper))
        alive = carry.err == errors.OK
        active = alive & in_range & ~env_bad
        err0 = jnp.where(alive & env_bad, errors.INVALID_ENVELOPE, carry.err)
        carry = carry._replace(err=err0.astype(jnp.int32))

        if rel_window and D > 0:
            # slide band storage left by d (vacated right columns = zero);
            # dropped cells are below lo-1 and can never be read again
            def slide(x):
                out = x
                for sft in range(1, D + 1):
                    sh = jnp.concatenate(
                        [x[:, sft:], jnp.full((K, sft), NEG)], axis=1
                    )
                    out = jnp.where(d == sft, sh, out)
                return out

            carry = carry._replace(
                blab=slide(carry.blab), bgap=slide(carry.bgap),
                pblab=slide(carry.pblab), pbgap=slide(carry.pbgap),
            )

        if crf:

            def l2r(t2, state, lastlab):
                # single-row dynamic_slice from the state-major copy — a
                # flat (t2*S + state) take is a general gather inside
                # the scan
                r = jax.lax.dynamic_slice(
                    l2T,
                    (jnp.clip(state, 0, S - 1), jnp.clip(t2, 0, T2 - 1), 0),
                    (1, 1, A + 1),
                )[0, 0]
                return r[0], jnp.take(r, jnp.clip(lastlab, 0, A - 1) + 1)

        elif rel_window:

            def l2r(t2, state, lastlab):
                # masked-reduction extraction from the step's l2 window —
                # no gather (col is a per-read scalar)
                col = t2 - wb
                hit = jnp.arange(W, dtype=jnp.int32) == col
                r = jnp.sum(
                    jnp.where(hit[:, None], l2win, jnp.float32(0)), axis=0
                )
                return r[0], jnp.take(r, jnp.clip(lastlab, 0, A - 1) + 1)

        else:

            def l2r(t2, state, lastlab):
                r = jnp.take(l2, jnp.clip(t2, 0, T2 - 1), axis=0)
                return r[0], jnp.take(r, jnp.clip(lastlab, 0, A - 1) + 1)

        if rel_window:

            def rootread(t2):
                hit = jnp.arange(W, dtype=jnp.int32) == (t2 - wb)
                return jnp.sum(jnp.where(hit, rootwin, jnp.float32(0)))

        else:

            def rootread(t2):
                return _root_read(root_gap, t2, Wr)

        # ---- band extension (banded envelopes only), parents before
        # children in node-id order (duplex.rs:490-522)
        if needs_ext:
            ext_flag = active & (hi > carry.last_upper)
            order = jnp.argsort(
                jnp.where(carry.valid & (carry.id >= 0), carry.id, _I32_MAX)
            )
            for r in range(K):
                s_idx = order[r]
                sel = jnp.arange(K) == s_idx
                act = (
                    ext_flag
                    & jnp.any(sel & carry.valid & (carry.id >= 0))
                    & (jnp.sum(jnp.where(sel, carry.bend, 0)) < hi)
                )
                carry = _extend_one_slot(
                    carry, rootread, l2r, lo, hi, wb, sel, act,
                    K=K, W=W, Wext=Wext, crf=crf, rel=rel_window,
                )
        carry = carry._replace(
            last_upper=jnp.where(active, hi, carry.last_upper)
        )

        # ---- expansion (duplex.rs:526-592 / 740-779) ----
        if crf:
            prow = jnp.take(p1row, jnp.clip(carry.state, 0, S - 1), axis=0)
        else:
            prow = jnp.broadcast_to(p1row[None, :], (K, A + 1))
        p0 = prow[:, 0]
        plab = prow[:, 1:]

        pushed_lab = carry.valid[:, None] & ~(plab < thr)
        gap_pos = carry.p1g > NEG
        if collapse and not crf:
            is_rep = carry.lastlab[:, None] == lbl[None, :]
        else:
            is_rep = jnp.zeros((K, A), bool)

        th1 = _mix1(carry.h1[:, None], lbl[None, :])
        th2 = _mix2(carry.h2[:, None], lbl[None, :])
        m = (
            (th1[:, :, None] == carry.h1[None, None, :])
            & (th2[:, :, None] == carry.h2[None, None, :])
            & (lbl[None, :, None] == carry.lastlab[None, None, :])
            & carry.valid[None, None, :]
        )
        matched = jnp.any(m, axis=-1)

        p1tot = ls_add(carry.p1l, carry.p1g)
        m_ext = jnp.where(is_rep, carry.p1g[:, None], p1tot[:, None]) + plab
        push_ext = pushed_lab & (~is_rep | matched | gap_pos[:, None])

        # analytic merge: tips receive blank + stay + at most one arrival
        recv = jnp.full((K,), NEG)
        recv_any = jnp.zeros((K,), bool)
        arr = jnp.where(m & push_ext[:, :, None], m_ext[:, :, None], NEG)
        recv = jnp.max(arr, axis=(0, 1))  # at most one finite entry
        recv_any = jnp.any(m & push_ext[:, :, None], axis=(0, 1))
        recv = jnp.where(recv_any, recv, NEG)
        # propagate a NaN arrival exactly (max would drop it)
        nan_arr = jnp.any(
            (m & push_ext[:, :, None]) & jnp.isnan(m_ext)[:, :, None], axis=(0, 1)
        )
        recv = jnp.where(nan_arr, jnp.float32(np.nan), recv)

        if collapse and not crf:
            safe_last = jnp.clip(carry.lastlab, 0, A - 1)
            p_stay = jnp.take_along_axis(plab, safe_last[:, None], axis=1)[:, 0]
            stay_push = carry.valid & (carry.lastlab >= 0) & ~(p_stay < thr)
            stay_lab = jnp.where(stay_push, carry.p1l + p_stay, NEG)
        else:
            stay_push = jnp.zeros((K,), bool)
            stay_lab = jnp.full((K,), NEG)

        blank_push = carry.valid & (p0 > thr)
        blank_gap = jnp.where(blank_push, p1tot + p0, NEG)

        tip_lab = ls_add(stay_lab, recv)
        tip_gap = blank_gap
        tip_valid = blank_push | stay_push | recv_any

        fresh_valid = push_ext & ~matched
        fresh_id = t * np.int32(KA) + (
            jnp.arange(K, dtype=jnp.int32)[:, None] * np.int32(A) + lbl[None, :]
        )

        # ---- fresh candidates' bands, all [K, A] at once ----
        if static_window:
            # default full-range envelope: lo = 0, hi = T2 every step, so
            # all the window indexing is static — no gathers anywhere
            cells = jnp.arange(W, dtype=jnp.int32)
        else:
            cells = lo + jnp.arange(W, dtype=jnp.int32)  # absolute t2
        cmask = cells < hi
        if crf:
            l2w = jax.lax.dynamic_slice(
                l2pad, (cells[0], 0, 0), (W, l2pad.shape[1], A + 1)
            )  # [W, S2, A1]; l2pad is padded so the start never clamps

            def tip_rows(s_k):
                cur, size = l2w, l2pad.shape[1]
                while size > 1:
                    half = size // 2
                    hi_sel = (s_k & half) != 0
                    cur = jnp.where(hi_sel, cur[:, half:, :], cur[:, :half, :])
                    size = half
                return cur[:, 0, :]

            rows = jnp.stack(
                [tip_rows(jnp.clip(carry.state[k], 0, S - 1)) for k in range(K)]
            )  # [K, W, A+1]
        elif static_window:
            pad = jnp.broadcast_to(l2[-1:], (W - T2, A + 1)) if W > T2 else l2[:0]
            rows = jnp.concatenate([l2, pad], axis=0)  # [W, A+1], no gather
            rows = jnp.broadcast_to(rows[None], (K, W, A + 1))
        elif rel_window:
            # l2win column j holds the row at t2 = wb + j; cells start at
            # col 1, so this is a static one-column shift
            rows = jnp.concatenate([l2win[1:], l2win[-1:]], axis=0)
            rows = jnp.broadcast_to(rows[None], (K, W, A + 1))
        else:
            rows = jnp.take(l2, jnp.clip(cells, 0, T2 - 1), axis=0)  # [W, A+1]
            rows = jnp.broadcast_to(rows[None], (K, W, A + 1))
        p0_cells = rows[:, :, 0]  # [K, W]
        pl_cells = jnp.moveaxis(rows[:, :, 1:], -1, 1)  # [K, A, W]

        # parent (tip) band values at cells - 1
        pv = cells - 1  # [W]
        if static_window:
            # cells - 1 with lo = 0 is just a one-column shift: pad + slice
            negcol = jnp.full((K, 1), NEG)
            t_lab = jnp.concatenate([negcol, carry.blab[:, : W - 1]], axis=1)
            t_gap = jnp.concatenate([negcol, carry.bgap[:, : W - 1]], axis=1)
        elif rel_window:
            # pv = wb + arange(W): exactly the storage columns — no movement
            t_lab = carry.blab
            t_gap = carry.bgap
        else:
            pcols = jnp.mod(jnp.maximum(pv, 0), W)
            t_lab = jnp.take_along_axis(
                carry.blab, jnp.broadcast_to(pcols[None, :], (K, W)), axis=1
            )
            t_gap = jnp.take_along_axis(
                carry.bgap, jnp.broadcast_to(pcols[None, :], (K, W)), axis=1
            )
        t_ok = (pv[None, :] >= carry.boff[:, None]) & (
            pv[None, :] < carry.bend[:, None]
        )
        tip_is_root = carry.id == -1
        par_lab = jnp.where(t_ok & ~tip_is_root[:, None], t_lab, NEG)
        if rel_window:
            root_g = rootwin[None, :]  # aligned with pv by construction
        else:
            root_g = _root_read(root_gap, pv, Wr)[None, :]
        par_gap = jnp.where(
            tip_is_root[:, None],
            root_g,
            jnp.where(t_ok, t_gap, NEG),
        )
        base_tot = ls_add(par_lab, par_gap)  # [K, W]
        base = jnp.where(
            is_rep[:, :, None], par_gap[:, None, :], base_tot[:, None, :]
        )  # [K, A, W]

        bl_new, bg_new = _build_band_cells(
            pl_cells,
            jnp.broadcast_to(p0_cells[:, None, :], (K, A, W)),
            base,
            jnp.broadcast_to(cmask[None, None, :], (K, A, W)),
        )  # [K, A, W]
        tot_new = ls_add(bl_new, bg_new)
        p2m_new = _nan_clean_max(tot_new, cmask[None, None, :])  # [K, A]

        # circularize: built cell i is absolute t2 = lo + i -> column t2 % W
        if static_window:
            # shift = 0: columns are already in place
            valid_col = jnp.arange(W, dtype=jnp.int32)[None, None, :] < (hi - lo)
            bl_c = jnp.where(valid_col, bl_new, NEG)
            bg_c = jnp.where(valid_col, bg_new, NEG)
        elif rel_window:
            # built cell i (t2 = lo + i) lives at column i + 1: static shift
            wcol = jnp.arange(W, dtype=jnp.int32)[None, None, :]
            valid_col = (wcol >= 1) & (wcol < 1 + (hi - lo))
            negpad = jnp.full((K, A, 1), NEG)
            bl_c = jnp.where(
                valid_col, jnp.concatenate([negpad, bl_new[:, :, : W - 1]], -1), NEG
            )
            bg_c = jnp.where(
                valid_col, jnp.concatenate([negpad, bg_new[:, :, : W - 1]], -1), NEG
            )
        else:
            shift = jnp.mod(lo, W)
            src = jnp.mod(jnp.arange(W, dtype=jnp.int32)[None, None, :] - shift, W)
            bl_c = jnp.take_along_axis(bl_new, jnp.broadcast_to(src, (K, A, W)), axis=-1)
            bg_c = jnp.take_along_axis(bg_new, jnp.broadcast_to(src, (K, A, W)), axis=-1)
            valid_col = jnp.mod(
                jnp.arange(W, dtype=jnp.int32)[None, None, :] - shift, W
            ) < (hi - lo)
            bl_c = jnp.where(valid_col, bl_c, NEG)
            bg_c = jnp.where(valid_col, bg_c, NEG)

        # ---- candidate table: K tips then K*A fresh ----
        def cat(a_tip, a_fresh):
            return jnp.concatenate([a_tip, a_fresh.reshape(KA)])

        c_valid = cat(tip_valid, fresh_valid)
        c_p1l = cat(tip_lab, jnp.where(fresh_valid, m_ext, NEG))
        c_p1g = cat(tip_gap, jnp.full((K, A), NEG))
        c_p2m = cat(carry.p2m, p2m_new)
        c_id = cat(carry.id, fresh_id)
        c_h1 = cat(carry.h1, th1)
        c_h2 = cat(carry.h2, th2)
        c_ph1 = cat(carry.ph1, jnp.broadcast_to(carry.h1[:, None], (K, A)))
        c_ph2 = cat(carry.ph2, jnp.broadcast_to(carry.h2[:, None], (K, A)))
        c_lastlab = cat(carry.lastlab, jnp.broadcast_to(lbl[None, :], (K, A)))
        c_plastlab = cat(
            carry.plastlab, jnp.broadcast_to(carry.lastlab[:, None], (K, A))
        )
        if crf:
            new_state = (
                (carry.state[:, None] * np.int32(A)) % np.int32(S) + lbl[None, :]
            ).astype(jnp.int32)
        else:
            new_state = jnp.zeros((K, A), jnp.int32)
        c_state = cat(carry.state, new_state)
        c_proot = jnp.concatenate(
            [carry.proot, jnp.broadcast_to(tip_is_root[:, None], (K, A)).reshape(KA)]
        )

        # band rows per candidate
        c_blab = jnp.concatenate([carry.blab, bl_c.reshape(KA, W)])
        c_bgap = jnp.concatenate([carry.bgap, bg_c.reshape(KA, W)])
        c_boff = cat(carry.boff, jnp.full((K, A), 1, jnp.int32) * lo)
        c_bend = cat(carry.bend, jnp.full((K, A), 1, jnp.int32) * hi)
        # fresh candidates' parent copy = the tip's current band
        c_pblab = jnp.concatenate(
            [carry.pblab, jnp.broadcast_to(carry.blab[:, None], (K, A, W)).reshape(KA, W)]
        )
        c_pbgap = jnp.concatenate(
            [carry.pbgap, jnp.broadcast_to(carry.bgap[:, None], (K, A, W)).reshape(KA, W)]
        )
        c_pboff = cat(carry.pboff, jnp.broadcast_to(carry.boff[:, None], (K, A)))
        c_pbend = cat(carry.pbend, jnp.broadcast_to(carry.bend[:, None], (K, A)))

        score = ls_add(c_p1l, c_p1g) + c_p2m
        cnt = jnp.sum(c_valid.astype(jnp.int32))
        nan_flag = (cnt >= 2) & jnp.any(c_valid & jnp.isnan(score))
        empty_flag = cnt == 0

        key = jnp.where(
            c_valid,
            jnp.where(jnp.isnan(score), jnp.float32(np.inf), score + jnp.float32(0.0)),
            NEG,
        )

        sel_scalars = {
            "id": (c_id, 0),
            "h1": (c_h1, jnp.uint32(0)),
            "h2": (c_h2, jnp.uint32(0)),
            "ph1": (c_ph1, jnp.uint32(0)),
            "ph2": (c_ph2, jnp.uint32(0)),
            "lastlab": (c_lastlab, 0),
            "plastlab": (c_plastlab, 0),
            "state": (c_state, 0),
            "p1l": (c_p1l, jnp.float32(0)),
            "p1g": (c_p1g, jnp.float32(0)),
            "p2m": (c_p2m, jnp.float32(0)),
            "boff": (c_boff, 0),
            "bend": (c_bend, 0),
            "pboff": (c_pboff, 0),
            "pbend": (c_pbend, 0),
        }
        picked = {k: [] for k in sel_scalars}
        picked_proot = []
        picked_valid = []
        rows_blab, rows_bgap, rows_pblab, rows_pbgap = [], [], [], []
        # validity is tracked explicitly, NOT via key > -inf: a -inf score
        # is a legitimate zero-probability hypothesis in log space (e.g. an
        # all-zero posterior row) and the reference keeps it in the beam
        remaining = c_valid
        for _ in range(K):
            mx = jnp.max(jnp.where(remaining, key, NEG))
            slot_valid = jnp.any(remaining)
            at_mx = remaining & (key == mx)
            sid = jnp.min(jnp.where(at_mx, c_id, _I32_MAX))
            chosen = at_mx & (c_id == sid)
            for name, (arr, zero) in sel_scalars.items():
                picked[name].append(jnp.sum(jnp.where(chosen, arr, zero)))
            picked_proot.append(jnp.any(chosen & c_proot))
            picked_valid.append(slot_valid)
            ch = chosen[:, None]
            rows_blab.append(jnp.sum(jnp.where(ch, c_blab, jnp.float32(0)), axis=0))
            rows_bgap.append(jnp.sum(jnp.where(ch, c_bgap, jnp.float32(0)), axis=0))
            rows_pblab.append(jnp.sum(jnp.where(ch, c_pblab, jnp.float32(0)), axis=0))
            rows_pbgap.append(jnp.sum(jnp.where(ch, c_pbgap, jnp.float32(0)), axis=0))
            remaining = remaining & ~chosen

        v_k = jnp.stack(picked_valid)
        sv = {k: jnp.stack(vs) for k, vs in picked.items()}

        def g(new, old):
            return jnp.where(active, new, old)

        def g2(new, old):
            return jnp.where(active, new, old)

        step_err = jnp.where(
            nan_flag,
            errors.INCOMPARABLE_VALUES,
            jnp.where(empty_flag, errors.RAN_OUT_OF_BEAM, errors.OK),
        )
        err = jnp.where(
            carry.err > 0, carry.err, jnp.where(active, step_err, errors.OK)
        ).astype(jnp.int32)

        new_carry = DuplexFastCarry(
            id=g(jnp.where(v_k, sv["id"].astype(jnp.int32), -2), carry.id),
            h1=g(sv["h1"].astype(jnp.uint32), carry.h1),
            h2=g(sv["h2"].astype(jnp.uint32), carry.h2),
            ph1=g(sv["ph1"].astype(jnp.uint32), carry.ph1),
            ph2=g(sv["ph2"].astype(jnp.uint32), carry.ph2),
            lastlab=g(sv["lastlab"].astype(jnp.int32), carry.lastlab),
            plastlab=g(sv["plastlab"].astype(jnp.int32), carry.plastlab),
            state=g(sv["state"].astype(jnp.int32), carry.state),
            p1l=g(jnp.where(v_k, sv["p1l"], NEG), carry.p1l),
            p1g=g(jnp.where(v_k, sv["p1g"], NEG), carry.p1g),
            p2m=g(jnp.where(v_k, sv["p2m"], NEG), carry.p2m),
            valid=g(v_k, carry.valid),
            blab=g2(jnp.stack(rows_blab), carry.blab),
            bgap=g2(jnp.stack(rows_bgap), carry.bgap),
            boff=g(sv["boff"].astype(jnp.int32), carry.boff),
            bend=g(sv["bend"].astype(jnp.int32), carry.bend),
            pblab=g2(jnp.stack(rows_pblab), carry.pblab),
            pbgap=g2(jnp.stack(rows_pbgap), carry.pbgap),
            pboff=g(sv["pboff"].astype(jnp.int32), carry.pboff),
            pbend=g(sv["pbend"].astype(jnp.int32), carry.pbend),
            proot=g(jnp.stack(picked_proot), carry.proot),
            last_upper=carry.last_upper,
            err=err,
        )
        return new_carry, carry.id

    return step


def _init_carry(K, W, init_state):
    slot = jnp.arange(K, dtype=jnp.int32)
    is0 = slot == 0
    return DuplexFastCarry(
        id=jnp.where(is0, jnp.int32(-1), jnp.int32(-2)),
        h1=jnp.where(is0, _SEED1, np.uint32(0)).astype(jnp.uint32),
        h2=jnp.where(is0, _SEED2, np.uint32(0)).astype(jnp.uint32),
        ph1=jnp.zeros((K,), jnp.uint32),
        ph2=jnp.zeros((K,), jnp.uint32),
        lastlab=jnp.full((K,), -1, jnp.int32),
        plastlab=jnp.full((K,), -2, jnp.int32),
        state=jnp.where(is0, jnp.asarray(init_state, jnp.int32), 0),
        p1l=jnp.full((K,), NEG),
        p1g=jnp.where(is0, jnp.float32(0.0), NEG),
        p2m=jnp.where(is0, jnp.float32(0.0), NEG),
        valid=is0,
        blab=jnp.full((K, W), NEG),
        bgap=jnp.full((K, W), NEG),
        boff=jnp.zeros((K,), jnp.int32),
        bend=jnp.zeros((K,), jnp.int32),
        pblab=jnp.full((K, W), NEG),
        pbgap=jnp.full((K, W), NEG),
        pboff=jnp.zeros((K,), jnp.int32),
        pbend=jnp.zeros((K,), jnp.int32),
        proot=jnp.zeros((K,), bool),
        last_upper=jnp.int32(0),
        err=jnp.int32(0),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "beam_size", "collapse_repeats", "W", "Wr", "Wext", "needs_ext",
        "crf", "static_window", "rel_window", "D"
    ),
)
def duplex_fast_device(
    l1: jnp.ndarray,  # [T1, A+1] ([T1, S, A+1] for crf) log probs
    l2: jnp.ndarray,  # [T2, A+1] ([T2, S, A+1]) log probs
    root_gap: jnp.ndarray,  # [Wr]
    lo: jnp.ndarray,  # [T1] i32
    hi: jnp.ndarray,  # [T1] i32
    threshold_log: jnp.ndarray,
    init_state: jnp.ndarray,
    length: Optional[jnp.ndarray] = None,  # scalar i32 valid t1 steps
    *,
    beam_size: int,
    collapse_repeats: bool,
    W: int,
    Wr: int,
    Wext: int,
    needs_ext: bool,
    crf: bool,
    static_window: bool = False,
    rel_window: bool = False,
    D: int = 0,
):
    T1 = l1.shape[0]
    A = l1.shape[-1] - 1
    S = l1.shape[1] if crf else 1
    T2 = l2.shape[0]
    K = beam_size
    if length is None:
        length = jnp.int32(T1)

    carry = _init_carry(K, W, init_state)
    l2T = l2pad = None
    if crf:
        # state-major copy for single-row reads + t2-major copy with the
        # state axis padded to a power of two for the window select tree;
        # both padded past T2 so dynamic slices never clamp-shift
        S2 = 1 << max(S - 1, 1).bit_length() if S & (S - 1) else S
        l2T = jnp.pad(
            jnp.transpose(l2, (1, 0, 2)), ((0, 0), (0, W + 2), (0, 0)),
            mode="edge",
        )
        l2pad = jnp.pad(
            l2, ((0, W + 2), (0, S2 - S), (0, 0)), mode="edge"
        )
    step = _make_step(
        l2, root_gap, jnp.asarray(length, jnp.int32),
        A=A, S=S, K=K, W=W, Wr=Wr, Wext=Wext,
        collapse=collapse_repeats, crf=crf, needs_ext=needs_ext,
        static_window=static_window, rel_window=rel_window, D=D,
        thr=jnp.asarray(threshold_log, jnp.float32), T2=T2,
        l2T=l2T, l2pad=l2pad,
    )
    ts = jnp.arange(T1, dtype=jnp.int32)
    if rel_window:
        # per-step window rows, gathered ONCE outside the scan (per-step
        # gathers of l2/root rows were the entire banded decode cost).
        # CRF reads l2 through the select tree over l2pad instead, so only
        # the root window is pre-gathered there.
        wbs = lo - 1  # monotone lo (host-checked) => wb == cummax(lo) - 1
        cols = wbs[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
        if crf:
            l2win_seq = jnp.zeros((T1, 1, 1), jnp.float32)
        else:
            l2win_seq = jnp.take(l2, jnp.clip(cols, 0, T2 - 1), axis=0)
        ridx = cols + 1
        rootwin_seq = jnp.where(
            (ridx >= 0) & (ridx < Wr),
            jnp.take(root_gap, jnp.clip(ridx, 0, Wr - 1)),
            NEG,
        )
        d_seq = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.diff(wbs)])
        xs = (l1, lo, hi, ts, l2win_seq, rootwin_seq, d_seq)
    else:
        xs = (l1, lo, hi, ts)
    carry, beam_ids = jax.lax.scan(step, carry, xs)

    labels_rev, _, count = _traceback_positional(
        carry.id[0], beam_ids, T1, K, A
    )
    return {"labels_rev": labels_rev, "count": count, "err": carry.err}


# ------------------------------------------------------------- host wrappers


class EnvPrep(NamedTuple):
    lo: np.ndarray
    hi: np.ndarray
    W: int
    Wr: int
    needs_ext: bool
    Wext: int
    static_window: bool
    rel_window: bool  # monotone lower bounds: window-relative (gather-free)
    D: int  # max per-step lower-bound advance (slide bound)


def _prep_envelope_fast(envelope: np.ndarray, T2: int) -> EnvPrep:
    """Clamp the envelope and size the band buffers.

    Three kernel modes, fastest first: ``static_window`` (full range — all
    indexing static), ``rel_window`` (monotone non-decreasing lower bounds
    — window-relative columns, per-step slides bounded by D), and the
    general circular layout (per-step gathers; pathological envelopes).
    W must cover the widest window any band holds: windows only shrink on
    extension steps (discard_until fires when the upper bound grows,
    duplex.rs:490-522), so the host replays the off/upper evolution exactly.
    """
    lo = np.maximum(envelope[:, 0], 0).astype(np.int32)
    hi = np.minimum(envelope[:, 1], T2).astype(np.int32)
    T1 = len(lo)
    static_window = bool(np.all(lo == 0) and np.all(hi == T2))
    monotone = bool(np.all(np.diff(lo) >= 0)) if T1 > 1 else True
    W = 1
    off = 0  # lowest retained band cell across live nodes
    last_upper = 0
    needs_ext = False
    Wext = 0
    for t in range(T1):
        l, h = int(lo[t]), int(hi[t])
        if h <= l or l > last_upper:
            break  # invalid envelope: kernel errors out at this step anyway
        if h > last_upper:
            if t > 0:
                needs_ext = True
                Wext = max(Wext, h - last_upper)
            if l > off:
                off = l - 1
        last_upper = max(last_upper, h)
        W = max(W, last_upper - off, h - l + 1)
    Wr = int(min(max(envelope[0, 1], 0), T2)) + 1 if T1 else 1
    rel = monotone and not static_window
    if rel:
        # floor at 1: an everywhere-invalid envelope (hi <= lo) must still
        # produce legal buffer shapes — the DP flags INVALID_ENVELOPE at
        # the first bad step (reference duplex.rs:485-488)
        W = max(int(max(hi - lo)) + 2, 1)
        D = int(max(np.diff(lo).max(), 0)) if T1 > 1 else 0
    else:
        D = 0
    return EnvPrep(
        lo, hi, int(W), Wr, needs_ext, int(max(Wext, 1)),
        static_window, rel, D,
    )


def beam_search_duplex_fast_host(
    net1: np.ndarray,
    net2: np.ndarray,
    alphabet,
    envelope: np.ndarray,
    beam_size: int,
    beam_cut_threshold: float,
    collapse_repeats: bool,
) -> str:
    """Host wrapper: log-convert, envelope prep, kernel, string assembly."""
    T2 = net2.shape[0]
    ep = _prep_envelope_fast(envelope, T2)

    with np.errstate(divide="ignore", invalid="ignore"):
        l1 = np.log(net1, dtype=np.float32)
        l2 = np.log(net2, dtype=np.float32)
        thr = np.float32(np.log(np.float32(beam_cut_threshold)))
        root_gap = np.concatenate(
            [[np.float32(0.0)], np.cumsum(l2[: ep.Wr - 1, 0], dtype=np.float32)]
        ).astype(np.float32)

    out = duplex_fast_device(
        l1, l2, root_gap, ep.lo, ep.hi, thr, np.int32(0),
        beam_size=int(beam_size),
        collapse_repeats=bool(collapse_repeats),
        W=ep.W, Wr=ep.Wr, Wext=ep.Wext, needs_ext=ep.needs_ext, crf=False,
        static_window=ep.static_window, rel_window=ep.rel_window, D=ep.D,
    )
    errors.raise_for_status(int(out["err"]))
    n = int(out["count"])
    labels_rev = np.asarray(out["labels_rev"])[:n]
    return "".join(alphabet[int(l) + 1] for l in labels_rev[::-1])


def crf_beam_search_duplex_fast_host(
    net1: np.ndarray,
    init1: np.ndarray,
    net2: np.ndarray,
    init2: np.ndarray,
    alphabet,
    envelope: np.ndarray,
    beam_size: int,
    beam_cut_threshold: float,
) -> str:
    T2 = net2.shape[0]
    S = net1.shape[1]
    n_base = net1.shape[2] - 1
    ep = _prep_envelope_fast(envelope, T2)
    lo, hi, W, Wr = ep.lo, ep.hi, ep.W, ep.Wr

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

    out = duplex_fast_device(
        l1, l2, root_gap, lo, hi, thr, np.int32(np.argmax(init1)),
        beam_size=int(beam_size),
        collapse_repeats=False,
        W=W, Wr=Wr, Wext=ep.Wext, needs_ext=ep.needs_ext, crf=True,
        static_window=ep.static_window,
        rel_window=ep.rel_window, D=ep.D,
    )
    errors.raise_for_status(int(out["err"]))
    n = int(out["count"])
    labels_rev = np.asarray(out["labels_rev"])[:n]
    return "".join(alphabet[int(l) + 1] for l in labels_rev[::-1])


@functools.partial(
    jax.jit,
    static_argnames=(
        "beam_size", "collapse_repeats", "W", "Wr", "Wext", "needs_ext",
        "crf", "static_window", "rel_window", "D", "shared_env"
    ),
)
def duplex_fast_batch(
    l1,  # [B, T1, A+1] ([B, T1, S, A+1] for crf) log probs
    l2,  # [B, T2, A+1]
    root_gap,  # [B, Wr] (pad with -inf past each read's root band)
    lo,  # [B, T1] i32
    hi,  # [B, T1] i32
    threshold_log,
    init_states,  # [B] i32
    lengths,  # [B] i32 valid t1 steps per read
    *,
    beam_size: int,
    collapse_repeats: bool,
    W: int,
    Wr: int,
    Wext: int,
    needs_ext: bool,
    crf: bool,
    static_window: bool = False,
    rel_window: bool = False,
    D: int = 0,
    shared_env: bool = False,
):
    """vmap of duplex_fast_device over a batch of read pairs.

    ``shared_env`` broadcasts one [T1] lo/hi pair over the batch
    (in_axes=None): window starts become per-step *scalars* inside the
    vmapped scan, so the CRF engine's window slice stays a dynamic_slice
    instead of re-lowering to a batched gather."""
    fn = lambda a, b, rg, l, h, s, n: duplex_fast_device(
        a, b, rg, l, h, threshold_log, s, n,
        beam_size=beam_size, collapse_repeats=collapse_repeats,
        W=W, Wr=Wr, Wext=Wext, needs_ext=needs_ext, crf=crf,
        static_window=static_window, rel_window=rel_window, D=D,
    )
    env_ax = None if shared_env else 0
    return jax.vmap(fn, in_axes=(0, 0, 0, env_ax, env_ax, 0, 0))(
        l1, l2, root_gap, lo, hi, init_states, lengths
    )
