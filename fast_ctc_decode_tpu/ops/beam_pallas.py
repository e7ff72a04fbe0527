"""Fused CTC prefix beam search for the GPU: Pallas kernels through Triton.

Same algorithm and semantics as ops/beam_fast.py (hash-identity beam,
analytic merge, (max, min-id) top-K, position-coded node ids — see that
module's docstring for the exactness contract vs the reference
search.rs:159-301), but the whole T loop runs inside one kernel:

 - ``beam_fast`` is a ``lax.scan`` whose body is a few hundred XLA ops
   per time step, so its decode pays kernel launches and fusion
   boundaries every step.  Here one program owns ``Bt`` reads, walks all
   T steps in a ``fori_loop`` and keeps the beam as loop carries in
   registers; the only device-memory traffic is the posteriors read once
   and the per-step beam-id log written once.

 - Layout: reads ride the minor axis, one read per lane.  Posteriors come
   in pre-transposed as ``[T, A+1, B]`` and the id log goes out as
   ``[T, K, B]``, so every load and store is contiguous across threads.
   The K beam slots and the K*A extension candidates are separate ``[Bt]``
   vectors unrolled in Python: every per-read operation is lane-local, no
   value crosses threads.

 - Parent-hash bookkeeping: a tip stores its PARENT's hash and its last
   label, and its own hash is recomputed once per step.  Extension
   (k, a) targets tip j iff ``h[k] == hp[j]`` and ``a == ll[j]``; since
   each hash round is a bijection of the hash for a fixed label, this is
   exactly beam_fast's ``mix(h[k], a) == h[j]`` test, at K*K instead of
   K*A*K compares and without per-candidate mixes.

The traceback (``_traceback_kernel``) walks the id log backward per read
and writes each emit straight to its place in the leaf-first
``labels_rev`` / ``times_rev`` rows, so no sort is needed to compact it.

Both kernels take ``interpret=True`` only from tests; on the GPU they
compile through Triton (``backend="triton"``).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .. import errors

_I32_MAX = np.iinfo(np.int32).max
NEG_INF = np.float32(-np.inf)
POS_INF = np.float32(np.inf)

# int32 hashing: bit-identical to beam_fast's uint32 lanes (wrapping mul,
# xor, logical shift)
_SEED1 = np.int32(np.uint32(0x9E3779B9).view(np.int32))
_SEED2 = np.int32(np.uint32(0x85EBCA6B).view(np.int32))
_MIX1 = (0xC2B2AE35, 0x165667B1)
_MIX2 = (0x27D4EB2F, 0x9E3779B1)


def _u(x):
    return np.uint32(x).astype(np.int32)


def _mix(h, lbl, mult_add):
    """beam_fast._mix on int32 lanes: ``lbl`` is a per-lane label."""
    mult, add = _u(mult_add[0]), _u(mult_add[1])
    z = (h ^ (lbl * mult + add)) * mult
    return z ^ jax.lax.shift_right_logical(z, np.int32(16))


def _div_rn(x, y, interpret):
    """IEEE round-to-nearest f32 division.

    Triton lowers ``/`` on f32 to the approximate ``div.full.f32``; the
    renormalization must round like XLA's division (and the reference's)
    or beam scores drift apart over T steps."""
    if interpret:
        return x / y
    (q,) = plt.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;",
        args=[x, y],
        constraints="=r,r,r",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, jnp.float32)],
    )
    return q


def _tree(op, xs):
    """Balanced reduction of a list of [Bt] vectors (short dependency
    chains for the SM's schedulers)."""
    xs = list(xs)
    while len(xs) > 1:
        nxt = [op(xs[i], xs[i + 1]) for i in range(0, len(xs) - 1, 2)]
        if len(xs) % 2:
            nxt.append(xs[-1])
        xs = nxt
    return xs[0]


def _pick(conds, vals, default):
    """``vals[i]`` where ``conds[i]`` (at most one true), else default."""
    out = default
    for c, v in zip(conds, vals):
        out = jnp.where(c, v, out)
    return out


def _beam_kernel(
    thr_ref,  # (1,) f32
    probs_ref,  # (T, A1, Bt) f32 block of [T, A1, B]
    len_ref,  # (Bt,) i32
    ids_ref,  # out (T, K, Bt) i32: entry-tip ids per step
    fin_ref,  # out (Bt,) i32: best tip id after the last step
    err_ref,  # out (Bt,) i32: status code
    *,
    K: int,
    A: int,
    T: int,
    collapse: bool,
    interpret: bool,
):
    Bt = len_ref.shape[0]
    KA = np.int32(K * A)
    thr = thr_ref[0]
    lens = len_ref[...]
    f0 = jnp.zeros((Bt,), jnp.float32)
    i0 = jnp.zeros((Bt,), jnp.int32)
    imax = jnp.full((Bt,), _I32_MAX, jnp.int32)

    # slot 0 is the root (id -1, gap 1); the rest are empty (id -2)
    carry0 = (
        [f0] * K,  # lab
        [f0 + 1.0] + [f0] * (K - 1),  # gap
        [i0] * K,  # hp1: parent hash, lane 1
        [i0] * K,  # hp2
        [i0 - 1] * K,  # ll: last label, -1 at the root
        [i0 - 1] + [i0 - 2] * (K - 1),  # id
        [i0 + 1] + [i0] * (K - 1),  # valid 0/1
        i0,  # err
    )

    def step(t, carry):
        lab, gap, hp1, hp2, ll, idv, va, err = carry
        for k in range(K):
            ids_ref[t, k, :] = idv[k]
        active = (t < lens) & (err == 0)
        p0 = probs_ref[t, 0, :]
        pl_ = [probs_ref[t, 1 + a, :] for a in range(A)]
        valid = [v != 0 for v in va]
        lg = [lab[k] + gap[k] for k in range(K)]
        root = [l < 0 for l in ll]
        h1 = [jnp.where(root[k], _SEED1, _mix(hp1[k], ll[k], _MIX1))
              for k in range(K)]
        h2 = [jnp.where(root[k], _SEED2, _mix(hp2[k], ll[k], _MIX2))
              for k in range(K)]
        # q[k]: posterior of tip k's last label (0 at the root)
        q = [_pick([ll[k] == a for a in range(A)], pl_, f0) for k in range(K)]

        # child[i][j]: tip j extends tip i by label ll[j]
        child = [
            [
                (h1[i] == hp1[j]) & (h2[i] == hp2[j]) & valid[j] & ~root[j]
                for j in range(K)
            ]
            for i in range(K)
        ]
        # labels of tip i that land on a current tip, as a bitmask
        mbits = [
            _tree(jnp.bitwise_or, [
                jnp.where(child[i][j], jnp.left_shift(1, ll[j]), 0)
                for j in range(K)
            ])
            for i in range(K)
        ]
        # arrivals: tip j receives from its unique parent tip i
        recv, recv_any = [], []
        for j in range(K):
            q_ok = ~(q[j] < thr)
            acc, got = f0, None
            for i in range(K):
                sel = child[i][j] & valid[i] & q_ok
                if collapse:
                    base = jnp.where(ll[i] == ll[j], gap[i], lg[i])
                else:
                    base = lg[i]
                acc = acc + jnp.where(sel, base * q[j], 0.0)
                got = sel if got is None else got | sel
            recv.append(acc)
            recv_any.append(got)

        # tips: blank keeps the node via gap, stay (collapse) via label
        tip_lab, tip_gap, tip_tot, tip_ok = [], [], [], []
        for k in range(K):
            blank_push = valid[k] & (p0 > thr)
            tip_gap.append(jnp.where(blank_push, lg[k] * p0, 0.0))
            if collapse:
                stay_push = valid[k] & ~root[k] & ~(q[k] < thr)
                stay_lab = jnp.where(stay_push, lab[k] * q[k], 0.0)
                ok = blank_push | stay_push | recv_any[k]
            else:
                stay_lab = f0
                ok = blank_push | recv_any[k]
            tip_lab.append(stay_lab + recv[k])
            tip_tot.append(tip_lab[k] + tip_gap[k])
            tip_ok.append(ok)

        # fresh extensions: (k, a) that target no current tip
        fr_ok, fr_tot, fr_id = [], [], []
        tKA = t * KA
        for k in range(K):
            for a in range(A):
                ok = valid[k] & ~(pl_[a] < thr)
                ok = ok & ((jax.lax.shift_right_logical(mbits[k], a) & 1) == 0)
                if collapse:
                    rep = ll[k] == a
                    ok = ok & (~rep | (gap[k] > 0.0))
                    m_ext = jnp.where(rep, gap[k], lg[k]) * pl_[a]
                else:
                    m_ext = lg[k] * pl_[a]
                fr_ok.append(ok)
                # total = label mass + zero gap, as beam_fast sums it
                fr_tot.append(jnp.where(ok, m_ext, 0.0) + 0.0)
                fr_id.append(tKA + np.int32(k * A + a))

        def key_of(ok, tot):
            return jnp.where(
                ok, jnp.where(jnp.isnan(tot), POS_INF, tot + 0.0), NEG_INF
            )

        c_ok = tip_ok + fr_ok
        c_tot = tip_tot + fr_tot
        keys = [key_of(o, x) for o, x in zip(c_ok, c_tot)]
        cids = list(idv) + fr_id
        # the reference raises only when a NaN is actually compared, i.e.
        # with >= 2 merged candidates (search.rs:261-272)
        cnt = _tree(jnp.add, [o.astype(jnp.int32) for o in c_ok])
        any_nan = _tree(jnp.bitwise_or,
                        [o & jnp.isnan(x) for o, x in zip(c_ok, c_tot)])
        nan_flag = (cnt >= 2) & any_nan
        empty_flag = cnt == 0

        # ---- top-K: K rounds of (max key, tie -> min id) ----
        new = []
        top = None
        for r in range(K):
            mx = _tree(jnp.maximum, keys)
            sid = _tree(jnp.minimum,
                        [jnp.where(kk == mx, c, imax)
                         for kk, c in zip(keys, cids)])
            ok = mx > NEG_INF
            isf = sid >= tKA
            # a fresh winner (k, a): lab = its key (gap 0), parent tip k;
            # a tip winner j: its own merged fields
            off = jnp.where(isf, sid - tKA, 0)
            kf = jax.lax.div(off, np.int32(A))
            at_tip = [~isf & (idv[j] == sid) for j in range(K)]
            at_k = [kf == k for k in range(K)]
            s_lab = jnp.where(isf, mx, _pick(at_tip, tip_lab, f0))
            s_gap = jnp.where(isf, 0.0, _pick(at_tip, tip_gap, f0))
            s_hp1 = jnp.where(isf, _pick(at_k, h1, i0), _pick(at_tip, hp1, i0))
            s_hp2 = jnp.where(isf, _pick(at_k, h2, i0), _pick(at_tip, hp2, i0))
            s_ll = jnp.where(isf, jax.lax.rem(off, np.int32(A)),
                             _pick(at_tip, ll, i0 - 1))
            if top is None:
                top = s_lab + s_gap
            new.append((ok, s_lab, s_gap, s_hp1, s_hp2, s_ll, sid))
            if r + 1 < K:
                keys = [jnp.where(c == sid, NEG_INF, kk)
                        for kk, c in zip(keys, cids)]

        step_err = jnp.where(
            nan_flag,
            errors.INCOMPARABLE_VALUES,
            jnp.where(empty_flag, errors.RAN_OUT_OF_BEAM, errors.OK),
        ).astype(jnp.int32)
        err = jnp.where(err > 0, err, jnp.where(active, step_err, 0))

        def g(n, o):
            return jnp.where(active, n, o)

        out = ([], [], [], [], [], [], [])
        for r, (ok, s_lab, s_gap, s_hp1, s_hp2, s_ll, sid) in enumerate(new):
            out[0].append(g(jnp.where(ok, _div_rn(s_lab, top, interpret), 0.0),
                            lab[r]))
            out[1].append(g(jnp.where(ok, _div_rn(s_gap, top, interpret), 0.0),
                            gap[r]))
            out[2].append(g(s_hp1, hp1[r]))
            out[3].append(g(s_hp2, hp2[r]))
            out[4].append(g(s_ll, ll[r]))
            out[5].append(g(jnp.where(ok, sid, -2), idv[r]))
            out[6].append(g(ok.astype(jnp.int32), va[r]))
        return (*out, err.astype(jnp.int32))

    res = jax.lax.fori_loop(0, T, step, carry0)
    fin_ref[...] = res[5][0]
    err_ref[...] = res[7]


def _traceback_kernel(
    fin_ref,  # (Bt,) i32
    ids_ref,  # (T, K, Bt) i32 block of the [T, K, B] id log
    lab_in_ref,  # (Bt, T) i32, aliased to lab_ref (pre-filled with -1)
    tim_in_ref,  # (Bt, T) i32, aliased to tim_ref
    lab_ref,  # out (Bt, T) i32 labels_rev
    tim_ref,  # out (Bt, T) i32 times_rev
    cnt_ref,  # out (Bt,) i32
    *,
    K: int,
    A: int,
    T: int,
):
    """Backward parent walk over the id log (beam_fast
    ``_traceback_scan_batch`` semantics: a parent is always created at an
    earlier step than its child, so one backward sweep over t visits
    every node of the final chain, leaf first).  Each emit is stored at
    the read's running count, which is its leaf-first rank."""
    del lab_in_ref, tim_in_ref
    Bt = fin_ref.shape[0]
    KA = np.int32(K * A)
    lanes = jax.lax.broadcasted_iota(jnp.int32, (Bt,), 0)

    def step(n, carry):
        cur, cnt = carry
        t = np.int32(T - 1) - n
        safe = jnp.maximum(cur, 0)
        tt = jax.lax.div(safe, KA)
        r = jax.lax.rem(safe, KA)
        hit = (cur >= 0) & (tt == t)
        par = plt.load(
            ids_ref.at[t, jax.lax.div(r, np.int32(A)), lanes],
            mask=hit, other=-2,
        )
        plt.store(lab_ref.at[lanes, cnt], jax.lax.rem(r, np.int32(A)),
                  mask=hit)
        plt.store(tim_ref.at[lanes, cnt], jnp.full((Bt,), t), mask=hit)
        return jnp.where(hit, par, cur), cnt + hit.astype(jnp.int32)

    _, cnt = jax.lax.fori_loop(
        0, T, step, (fin_ref[...], jnp.zeros((Bt,), jnp.int32))
    )
    cnt_ref[...] = cnt


def _params(block_b: int):
    # one warp per 32 reads: one read per thread
    return plt.CompilerParams(num_warps=max(block_b // 32, 1), num_stages=1)


def _traceback_call(fin, ids_log, *, T, K, A, Bt, interpret):
    """fin [Bp] + ids_log [T, K, Bp] -> (labels_rev, times_rev, count)."""
    Bp = fin.shape[0]
    fill = jnp.full((Bp, T), -1, jnp.int32)
    row = pl.BlockSpec((Bt, T), lambda i: (i, 0))
    vec = pl.BlockSpec((Bt,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(_traceback_kernel, K=K, A=A, T=T),
        grid=(Bp // Bt,),
        in_specs=[vec, pl.BlockSpec((T, K, Bt), lambda i: (0, 0, i)), row, row],
        out_specs=[row, row, vec],
        out_shape=[
            jax.ShapeDtypeStruct((Bp, T), jnp.int32),
            jax.ShapeDtypeStruct((Bp, T), jnp.int32),
            jax.ShapeDtypeStruct((Bp,), jnp.int32),
        ],
        input_output_aliases={2: 0, 3: 1},
        backend="triton",
        compiler_params=_params(Bt),
        name="ctc_beam_traceback",
        interpret=interpret,
    )(fin, ids_log, fill, fill)


@functools.partial(
    jax.jit, static_argnames=("T", "K", "A", "block_b", "interpret")
)
def traceback_pallas_batch(
    fin,  # [B] i32 final beam-head ids
    ids_log,  # [T, K, B] i32
    *,
    T: int,
    K: int,
    A: int,
    block_b: int = 32,
    interpret: bool = False,
):
    """Fused traceback: (labels_rev [B, T], times_rev [B, T], count [B]),
    bit-identical to beam_fast._traceback_scan_batch over the same log."""
    B = fin.shape[0]
    Bt = min(block_b, _pow2_at_least(B))
    Bp = -(-B // Bt) * Bt
    fin_p = jnp.pad(fin.astype(jnp.int32), (0, Bp - B), constant_values=-2)
    ids_p = jnp.pad(ids_log[:T], ((0, 0), (0, 0), (0, Bp - B)))
    lab, tim, cnt = _traceback_call(
        fin_p, ids_p, T=T, K=K, A=A, Bt=Bt, interpret=interpret
    )
    return lab[:B], tim[:B], cnt[:B]


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


@functools.partial(
    jax.jit,
    static_argnames=(
        "beam_size", "collapse_repeats", "block_b", "interpret", "raw",
    ),
)
def beam_search_pallas_batch(
    probs: jnp.ndarray,  # [B, T, A+1] f32
    lengths: jnp.ndarray,  # [B] i32
    beam_cut_threshold,
    *,
    beam_size: int,
    collapse_repeats: bool = True,
    block_b: int = 32,
    interpret: bool = False,
    raw: bool = False,
):
    """Fused-kernel batched beam search; beam_fast output contract.

    ``block_b`` reads per program (a power of two; one warp per 32).
    ``raw=True`` returns the decode kernel's outputs only (``ids_log``
    [T, K, B], ``fin``, ``err``) for stage timing and tests."""
    B, T, A1 = probs.shape
    A = A1 - 1
    K = beam_size
    Bt = min(block_b, _pow2_at_least(B))
    Bp = -(-B // Bt) * Bt
    # [T, A1, Bp]: reads on the minor axis so per-step loads coalesce
    probs_t = jnp.transpose(probs.astype(jnp.float32), (1, 2, 0))
    lens = jnp.asarray(lengths, jnp.int32)
    if Bp != B:
        probs_t = jnp.pad(probs_t, ((0, 0), (0, 0), (0, Bp - B)))
        lens = jnp.pad(lens, (0, Bp - B))
    thr = jnp.asarray(beam_cut_threshold, jnp.float32).reshape(1)

    vec = pl.BlockSpec((Bt,), lambda i: (i,))
    ids_log, fin, err = pl.pallas_call(
        functools.partial(
            _beam_kernel, K=K, A=A, T=T, collapse=collapse_repeats,
            interpret=interpret,
        ),
        grid=(Bp // Bt,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,)),
            pl.BlockSpec((T, A1, Bt), lambda i: (0, 0, i)),
            vec,
        ],
        out_specs=[pl.BlockSpec((T, K, Bt), lambda i: (0, 0, i)), vec, vec],
        out_shape=[
            jax.ShapeDtypeStruct((T, K, Bp), jnp.int32),
            jax.ShapeDtypeStruct((Bp,), jnp.int32),
            jax.ShapeDtypeStruct((Bp,), jnp.int32),
        ],
        backend="triton",
        compiler_params=_params(Bt),
        name="ctc_beam_decode",
        interpret=interpret,
    )(thr, probs_t, lens)

    if raw:
        return {"ids_log": ids_log[:, :, :B], "fin": fin[:B], "err": err[:B]}
    labels_rev, times_rev, count = _traceback_call(
        fin, ids_log, T=T, K=K, A=A, Bt=Bt, interpret=interpret
    )
    return {
        "labels_rev": labels_rev[:B],
        "times_rev": times_rev[:B],
        "count": count[:B],
        "err": err[:B],
    }
