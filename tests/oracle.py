"""Test oracle: a straightforward NumPy re-implementation of the reference
semantics (/root/reference/src/search.rs, src/duplex.rs), used to validate the
device kernels on random inputs.  All arithmetic is np.float32 in the reference's
exact operation order.  This is test scaffolding, not product code — it is
deliberately slow and simple.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
ROOT = -1


class Tree:
    """Flat suffix tree with (parent, label) child map (reference src/tree.rs)."""

    def __init__(self):
        self.parent = []
        self.label = []
        self.data = []
        self.children = {}  # (parent, label) -> node id

    def get_child(self, node, label):
        return self.children.get((node, label))

    def add_node(self, parent, label, data):
        nid = len(self.parent)
        assert (parent, label) not in self.children
        self.children[(parent, label)] = nid
        self.parent.append(parent)
        self.label.append(label)
        self.data.append(data)
        return nid

    def tip_label(self, node):
        return self.label[node] if node >= 0 else None

    def traceback(self, node):
        out = []
        while node >= 0:
            out.append((self.label[node], self.data[node]))
            node = self.parent[node]
        return out  # leaf -> root


def _merge_sort_truncate(beam, beam_size, probability, on_sorted=None):
    """Dedup-by-node (left-fold += in node-sorted order), NaN check, sort by
    prob desc (stable over node order => ties ascending node id), truncate.

    beam: list of dicts with key 'node'. `probability(e)` gives the sort score.
    `on_sorted`, if given, sees the sorted scores before truncation.
    Returns (beam, 'nan'|'empty'|None). Mutates entries in place.
    """
    beam.sort(key=lambda e: e["node"])  # python sort is stable, like Rust's
    merged = []
    for e in beam:
        if merged and merged[-1]["node"] == e["node"]:
            acc = merged[-1]
            for k in ("lab", "gap"):
                if k in acc:
                    acc[k] = F32(acc[k] + e[k])
            if "p1l" in e:  # duplex ProbPair accumulate (logspace add)
                acc["p1l"] = _ls_add(acc["p1l"], e["p1l"])
                acc["p1g"] = _ls_add(acc["p1g"], e["p1g"])
        else:
            merged.append(e)
    beam = merged
    probs = [probability(e) for e in beam]
    if len(beam) >= 2 and any(np.isnan(p) for p in probs):
        return beam, "nan"
    beam.sort(key=lambda e: -float(probability(e)))  # stable; f32->f64 exact
    if on_sorted is not None:
        on_sorted([probability(e) for e in beam])
    del beam[beam_size:]
    if not beam:
        return beam, "empty"
    return beam, None


def beam_search(probs, alphabet, beam_size=5, beam_cut_threshold=0.0,
                collapse_repeats=True, on_step=None):
    """Oracle for reference beam_search (src/search.rs:159-301).
    ``on_step(t, scores)``, if given, sees step t's merged candidate scores
    sorted best first, before the beam is cut to ``beam_size``."""
    probs = np.asarray(probs, dtype=np.float32)
    thr = F32(beam_cut_threshold)
    tree = Tree()
    beam = [dict(node=ROOT, lab=F32(0.0), gap=F32(1.0))]

    for idx in range(probs.shape[0]):
        pr = probs[idx]
        next_beam = []
        for tip in beam:
            node, lab, gap = tip["node"], tip["lab"], tip["gap"]
            tip_label = tree.tip_label(node)
            if pr[0] > thr:
                next_beam.append(
                    dict(node=node, lab=F32(0.0), gap=F32(F32(lab + gap) * pr[0]))
                )
            for label in range(len(pr) - 1):
                p = pr[label + 1]
                if p < thr:
                    continue
                if collapse_repeats and tip_label == label:
                    next_beam.append(dict(node=node, lab=F32(lab * p), gap=F32(0.0)))
                    child = tree.get_child(node, label)
                    if child is None and gap > 0.0:
                        child = tree.add_node(node, label, idx)
                    if child is not None:
                        next_beam.append(
                            dict(node=child, lab=F32(gap * p), gap=F32(0.0))
                        )
                else:
                    child = tree.get_child(node, label)
                    if child is None:
                        child = tree.add_node(node, label, idx)
                    next_beam.append(
                        dict(node=child, lab=F32(F32(lab + gap) * p), gap=F32(0.0))
                    )
        beam, err = _merge_sort_truncate(
            next_beam, beam_size, lambda e: F32(e["lab"] + e["gap"]),
            on_sorted=on_step and (lambda ps, t=idx: on_step(t, ps)),
        )
        if err == "nan":
            raise RuntimeError("Failed to compare values (NaNs in input?)")
        if err == "empty":
            raise RuntimeError("Ran out of search space (beam_cut_threshold too high)")
        top = F32(beam[0]["lab"] + beam[0]["gap"])
        for e in beam:
            e["lab"] = F32(e["lab"] / top)
            e["gap"] = F32(e["gap"] / top)

    seq, path = "", []
    if beam[0]["node"] != ROOT:
        for label, time in tree.traceback(beam[0]["node"]):
            path.append(time)
            seq += alphabet[label + 1]
    return seq[::-1], path[::-1]


def crf_beam_search(probs, init_state, alphabet, beam_size=5, beam_cut_threshold=0.0):
    """Oracle for reference crf_beam_search (src/search.rs:38-157)."""
    probs = np.asarray(probs, dtype=np.float32)
    init_state = np.asarray(init_state, dtype=np.float32)
    thr = F32(beam_cut_threshold)
    T, S, A1 = probs.shape
    n_base = A1 - 1

    tree = Tree()
    beam = [
        dict(
            node=ROOT,
            lab=F32(init_state.max()),
            gap=F32(init_state[0]),
            state=int(init_state.argmax()),
        )
    ]
    for idx in range(T):
        next_beam = []
        for tip in beam:
            pr = probs[idx, tip["state"]]
            if pr[0] > thr:
                next_beam.append(
                    dict(
                        node=tip["node"],
                        state=tip["state"],
                        lab=F32(0.0),
                        gap=F32(F32(tip["lab"] + tip["gap"]) * pr[0]),
                    )
                )
            for label in range(n_base):
                p = pr[label + 1]
                if p < thr:
                    continue
                child = tree.get_child(tip["node"], label)
                if child is None:
                    child = tree.add_node(tip["node"], label, idx)
                next_beam.append(
                    dict(
                        node=child,
                        state=(tip["state"] * n_base) % S + label,
                        lab=F32(F32(tip["lab"] + tip["gap"]) * p),
                        gap=F32(0.0),
                    )
                )
        beam, err = _merge_sort_truncate(
            next_beam, beam_size, lambda e: F32(e["lab"] + e["gap"])
        )
        if err == "nan":
            raise RuntimeError("Failed to compare values (NaNs in input?)")
        if err == "empty":
            raise RuntimeError("Ran out of search space (beam_cut_threshold too high)")
        top = F32(beam[0]["lab"] + beam[0]["gap"])
        for e in beam:
            e["lab"] = F32(e["lab"] / top)
            e["gap"] = F32(e["gap"] / top)

    seq, path = "", []
    if beam[0]["node"] != ROOT:
        for label, time in tree.traceback(beam[0]["node"]):
            path.append(time)
            seq += alphabet[label + 1]
    return seq[::-1], path[::-1]


# ---------------------------------------------------------------- logspace --

NEG_INF = F32(np.float32("-inf"))


def _ls_new(x):
    with np.errstate(divide="ignore", invalid="ignore"):
        return F32(np.log(F32(x)))


def _ls_add(a, b):
    """LogSpace Add (src/duplex.rs:42-63): stable pairwise logsumexp."""
    if a <= b:
        small, big = a, b
    else:
        small, big = b, a
    if small == NEG_INF:
        return F32(big)
    return F32(big + np.log1p(np.exp(F32(small - big))))


def _ls_mul(a, b):
    return F32(a + b)


class SecondaryProbs:
    """Banded forward DP over network_2 time (src/duplex.rs:151-210)."""

    def __init__(self, offset):
        self.offset = offset
        self.probs = []  # list of (label, gap) logspace pairs
        self.max_prob = NEG_INF

    def get(self, at):
        i = at - self.offset
        if 0 <= i < len(self.probs):
            return self.probs[i]
        return (NEG_INF, NEG_INF)

    def end(self):
        return self.offset + len(self.probs)

    def discard_until(self, keep_from):
        if keep_from > self.offset:
            first = keep_from - self.offset
            del self.probs[: max(0, min(first, len(self.probs)))]
            self.offset = keep_from

    def update_max(self, lo, hi):
        begin = min(max(lo - self.offset, 0), len(self.probs))
        end = min(max(hi - self.offset, begin), len(self.probs))
        m = NEG_INF
        for l, g in self.probs[begin:end]:
            t = _ls_add(l, g)
            m = t if m < t else m  # LogSpace::max keeps self unless self < other
        self.max_prob = m


def _pair_total(lg):
    return _ls_add(lg[0], lg[1])


def build_secondary_probs(net2, parent, label, is_repeat, lo, hi):
    """src/duplex.rs:212-249; net2 rows already in logspace."""
    out = SecondaryProbs(lo)
    last = (NEG_INF, NEG_INF)
    for idx in range(lo, hi):
        row = net2[idx]
        gap_prob = _ls_mul(_pair_total(last), row[0])
        pl, pg = parent.get(idx - 1)
        if is_repeat:
            label_prob = _ls_mul(row[label + 1], _ls_add(last[0], pg))
        else:
            label_prob = _ls_mul(row[label + 1], _ls_add(last[0], _ls_add(pl, pg)))
        last = (label_prob, gap_prob)
        out.probs.append(last)
        t = _pair_total(last)
        out.max_prob = t if out.max_prob < t else out.max_prob
    return out


def extend_secondary_probs(sp, net2, parent, label, is_repeat, lo, hi):
    """src/duplex.rs:338-387."""
    if lo > sp.offset:
        sp.discard_until(lo - 1)
        if not sp.probs:
            sp.offset = lo
        sp.update_max(lo, hi)
    cur_end = sp.end()
    assert cur_end < hi
    last = sp.probs[-1] if sp.probs else (NEG_INF, NEG_INF)
    for idx in range(cur_end, hi):
        row = net2[idx]
        gap_prob = _ls_mul(_pair_total(last), row[0])
        pl, pg = parent.get(idx - 1)
        if is_repeat:
            label_prob = _ls_mul(row[label + 1], _ls_add(last[0], pg))
        else:
            label_prob = _ls_mul(row[label + 1], _ls_add(last[0], _ls_add(pl, pg)))
        last = (label_prob, gap_prob)
        sp.probs.append(last)
        t = _pair_total(last)
        sp.max_prob = t if sp.max_prob < t else sp.max_prob


def root_probs(net2_blank_col, upper):
    """src/duplex.rs:389-409."""
    sp = SecondaryProbs(-1)
    sp.max_prob = F32(0.0)  # LogSpace::one
    cur = F32(0.0)
    sp.probs.append((NEG_INF, cur))
    for i in range(upper):
        cur = _ls_mul(cur, net2_blank_col[i])
        sp.probs.append((NEG_INF, cur))
    return sp


def beam_search_duplex(net1, net2, alphabet, envelope=None, beam_size=5,
                       beam_cut_threshold=0.0, collapse_repeats=True):
    """Oracle for reference duplex beam_search (src/duplex.rs:443-650)."""
    net1 = np.asarray(net1, dtype=np.float32)
    net2 = np.asarray(net2, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        l1 = np.log(net1).astype(np.float32)
        l2 = np.log(net2).astype(np.float32)
    thr = _ls_new(beam_cut_threshold)
    T1, A1 = net1.shape
    T2 = net2.shape[0]
    if envelope is None:
        envelope = np.stack(
            [np.zeros(T1, np.int64), np.full(T1, T2, np.int64)], axis=1
        )

    tree = Tree()
    beam = [dict(node=ROOT, p1l=NEG_INF, p1g=F32(0.0), p2max=F32(0.0))]
    root_sp = root_probs(l2[:, 0], int(envelope[0, 1]))
    last_upper = 0

    for t in range(T1):
        lo = max(int(envelope[t, 0]), 0)
        hi = min(int(envelope[t, 1]), T2)
        if lo >= hi or lo > last_upper:
            raise RuntimeError("Invalid envelope values")

        if hi > last_upper:
            beam.sort(key=lambda e: e["node"])  # parents before children
            for tip in beam:
                node = tip["node"]
                if node >= 0:
                    parent_sp = (
                        tree.data[tree.parent[node]]
                        if tree.parent[node] >= 0
                        else root_sp
                    )
                    par_label = tree.tip_label(tree.parent[node])
                    extend_secondary_probs(
                        tree.data[node],
                        l2,
                        parent_sp,
                        tree.label[node],
                        par_label == tree.label[node],
                        lo,
                        hi,
                    )
        last_upper = hi

        next_beam = []
        for tip in beam:
            node = tip["node"]
            tip_label = tree.tip_label(node)
            pr = l1[t]
            p1_total = _ls_add(tip["p1l"], tip["p1g"])
            if pr[0] > thr:
                next_beam.append(
                    dict(
                        node=node,
                        p1l=NEG_INF,
                        p1g=_ls_mul(p1_total, pr[0]),
                        p2max=tip["p2max"],
                    )
                )
            for label in range(A1 - 1):
                p = pr[label + 1]
                if p < thr:
                    continue
                if collapse_repeats and tip_label == label:
                    next_beam.append(
                        dict(
                            node=node,
                            p1l=_ls_mul(tip["p1l"], p),
                            p1g=NEG_INF,
                            p2max=tip["p2max"],
                        )
                    )
                    child = tree.get_child(node, label)
                    if child is None and tip["p1g"] > NEG_INF:
                        parent_sp = tree.data[node] if node >= 0 else root_sp
                        sp = build_secondary_probs(l2, parent_sp, label, True, lo, hi)
                        child = tree.add_node(node, label, sp)
                    if child is not None:
                        next_beam.append(
                            dict(
                                node=child,
                                p1l=_ls_mul(tip["p1g"], p),
                                p1g=NEG_INF,
                                p2max=tip["p2max"],
                            )
                        )
                else:
                    child = tree.get_child(node, label)
                    if child is None:
                        parent_sp = tree.data[node] if node >= 0 else root_sp
                        sp = build_secondary_probs(l2, parent_sp, label, False, lo, hi)
                        child = tree.add_node(node, label, sp)
                    next_beam.append(
                        dict(
                            node=child,
                            p1l=_ls_mul(p1_total, p),
                            p1g=NEG_INF,
                            p2max=tip["p2max"],
                        )
                    )

        def score(e):
            return _ls_mul(_ls_add(e["p1l"], e["p1g"]), e["p2max"])

        # duplex merge: sort by node, fold += prob_1 pairs, refresh p2max
        # from tree data, NaN check, sort by score, truncate
        # (src/duplex.rs:595-635; no renormalization in log space)
        next_beam.sort(key=lambda e: e["node"])
        merged = []
        for e in next_beam:
            if merged and merged[-1]["node"] == e["node"]:
                acc = merged[-1]
                acc["p1l"] = _ls_add(acc["p1l"], e["p1l"])
                acc["p1g"] = _ls_add(acc["p1g"], e["p1g"])
            else:
                merged.append(e)
        for e in merged:
            if e["node"] >= 0:
                e["p2max"] = tree.data[e["node"]].max_prob
        beam = merged
        scores = [score(e) for e in beam]
        if len(beam) >= 2 and any(np.isnan(s) for s in scores):
            raise RuntimeError("Failed to compare values (NaNs in input?)")
        beam.sort(key=lambda e: -float(score(e)))
        del beam[beam_size:]
        if not beam:
            raise RuntimeError("Ran out of search space (beam_cut_threshold too high)")

    seq = ""
    if beam[0]["node"] != ROOT:
        for label, _ in tree.traceback(beam[0]["node"]):
            seq += alphabet[label + 1]
    return seq[::-1]


# ------------------------------------------------------------- crf duplex --


def crf_root_probs(l2, init_state, upper):
    """src/duplex.rs:411-441 — blank-state trajectory root band."""
    T2, S, A1 = l2.shape
    n_base = A1 - 1
    sp = SecondaryProbs(-1)
    sp.max_prob = F32(0.0)
    cur = F32(0.0)
    sp.probs.append((NEG_INF, cur))
    state = int(init_state)
    for i in range(min(int(upper), T2)):
        cur = _ls_mul(cur, l2[i, state, 0])
        sp.probs.append((NEG_INF, cur))
        state = (state * n_base) % S
    return sp


def crf_build_secondary_probs(l2, parent, label, tstate, lo, hi):
    """src/duplex.rs:251-288 — fixed tstate, no repeat branch."""
    out = SecondaryProbs(lo)
    last = (NEG_INF, NEG_INF)
    for idx in range(lo, hi):
        row = l2[idx, tstate]
        gap_prob = _ls_mul(_pair_total(last), row[0])
        pl, pg = parent.get(idx - 1)
        label_prob = _ls_mul(row[label + 1], _ls_add(last[0], _ls_add(pl, pg)))
        last = (label_prob, gap_prob)
        out.probs.append(last)
        t = _pair_total(last)
        out.max_prob = t if out.max_prob < t else out.max_prob
    return out


def crf_extend_secondary_probs(sp, l2, parent, label, tstate, lo, hi):
    """src/duplex.rs:290-336."""
    if lo > sp.offset:
        sp.discard_until(lo - 1)
        if not sp.probs:
            sp.offset = lo
        sp.update_max(lo, hi)
    cur_end = sp.end()
    last = sp.probs[-1] if sp.probs else (NEG_INF, NEG_INF)
    for idx in range(cur_end, hi):
        row = l2[idx, tstate]
        gap_prob = _ls_mul(_pair_total(last), row[0])
        pl, pg = parent.get(idx - 1)
        label_prob = _ls_mul(row[label + 1], _ls_add(last[0], _ls_add(pl, pg)))
        last = (label_prob, gap_prob)
        sp.probs.append(last)
        t = _pair_total(last)
        sp.max_prob = t if sp.max_prob < t else sp.max_prob


def crf_beam_search_duplex(net1, init1, net2, init2, alphabet, envelope=None,
                           beam_size=5, beam_cut_threshold=0.0):
    """Oracle for reference crf duplex beam_search (src/duplex.rs:652-834)."""
    net1 = np.asarray(net1, np.float32)
    net2 = np.asarray(net2, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        l1 = np.log(net1).astype(np.float32)
        l2 = np.log(net2).astype(np.float32)
    thr = _ls_new(beam_cut_threshold)
    T1, S, A1 = net1.shape
    T2 = net2.shape[0]
    n_base = A1 - 1
    if envelope is None:
        envelope = np.stack(
            [np.zeros(T1, np.int64), np.full(T1, T2, np.int64)], axis=1
        )

    tree = Tree()
    beam = [dict(node=ROOT, state=int(np.argmax(init1)), p1l=NEG_INF,
                 p1g=F32(0.0), p2max=F32(0.0))]
    root_sp = crf_root_probs(l2, int(np.argmax(init2)), int(envelope[0, 1]))
    last_upper = 0

    for t in range(T1):
        lo = max(int(envelope[t, 0]), 0)
        hi = min(int(envelope[t, 1]), T2)
        if lo >= hi or lo > last_upper:
            raise RuntimeError("Invalid envelope values")

        if hi > last_upper:
            beam.sort(key=lambda e: e["node"])  # parents before children
            for tip in beam:
                node = tip["node"]
                if node >= 0:
                    parent_sp = (
                        tree.data[tree.parent[node]]
                        if tree.parent[node] >= 0
                        else root_sp
                    )
                    # NOTE: extension uses the *beam entry's* state, which
                    # is the post-emission state — not the state the band
                    # was built with (duplex.rs:711-731)
                    crf_extend_secondary_probs(
                        tree.data[node], l2, parent_sp, tree.label[node],
                        tip["state"], lo, hi,
                    )
        last_upper = hi

        next_beam = []
        for tip in beam:
            node = tip["node"]
            pr = l1[t, tip["state"]]
            p1_total = _ls_add(tip["p1l"], tip["p1g"])
            if pr[0] > thr:
                next_beam.append(
                    dict(node=node, state=tip["state"], p1l=NEG_INF,
                         p1g=_ls_mul(p1_total, pr[0]), p2max=tip["p2max"])
                )
            for label in range(n_base):
                p = pr[label + 1]
                if p < thr:
                    continue
                child = tree.get_child(node, label)
                if child is None:
                    parent_sp = tree.data[node] if node >= 0 else root_sp
                    sp = crf_build_secondary_probs(
                        l2, parent_sp, label, tip["state"], lo, hi
                    )
                    child = tree.add_node(node, label, sp)
                next_beam.append(
                    dict(
                        node=child,
                        state=(tip["state"] * n_base) % S + label,
                        p1l=_ls_mul(p1_total, p),
                        p1g=NEG_INF,
                        p2max=tip["p2max"],
                    )
                )

        next_beam.sort(key=lambda e: e["node"])
        merged = []
        for e in next_beam:
            if merged and merged[-1]["node"] == e["node"]:
                acc = merged[-1]
                acc["p1l"] = _ls_add(acc["p1l"], e["p1l"])
                acc["p1g"] = _ls_add(acc["p1g"], e["p1g"])
            else:
                merged.append(e)
        for e in merged:
            if e["node"] >= 0:
                e["p2max"] = tree.data[e["node"]].max_prob
        beam = merged
        scores = [
            _ls_mul(_ls_add(e["p1l"], e["p1g"]), e["p2max"]) for e in beam
        ]
        if len(beam) >= 2 and any(np.isnan(s) for s in scores):
            raise RuntimeError("Failed to compare values (NaNs in input?)")
        beam.sort(
            key=lambda e: -float(_ls_mul(_ls_add(e["p1l"], e["p1g"]), e["p2max"]))
        )
        del beam[beam_size:]
        if not beam:
            raise RuntimeError(
                "Ran out of search space (beam_cut_threshold too high)"
            )

    seq = ""
    if beam[0]["node"] != ROOT:
        for label, _ in tree.traceback(beam[0]["node"]):
            seq += alphabet[label + 1]
    return seq[::-1]
