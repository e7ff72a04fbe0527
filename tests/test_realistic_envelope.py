"""Realistic (jagged, variable-width) alignment-envelope coverage.

Every other banded test uses the synthetic ``diag_env``; the reference
workload is basecaller *alignment* envelopes — jagged per-step bounds of
varying width that stall and jump as the two reads align
(/root/reference/src/lib.rs:376-389).  This fixture generates one with a
random-walk center and width, fixed up to the reference validity rules,
and pins all three engines on it:

 - the XLA fast (rel-window) engine's W/Wext replay sizing
   (duplex_fast._prep_envelope_fast) against the tree engine,
 - the batch decoder's automatic route for it (the batched tree engine)
   against the NumPy oracle.
"""

import numpy as np

import oracle
from duplex_helpers import random_data
from fast_ctc_decode_tpu import beam_search_duplex
from fast_ctc_decode_tpu.parallel.pipeline import BatchDuplexDecoder


def jagged_env(T1, T2, seed, base_w=6, jitter=4):
    """Monotone-validity alignment-style envelope: the center random-walks
    around the diagonal (stalls + jumps), the half-width wobbles."""
    rng = np.random.RandomState(seed)
    env = np.zeros((T1, 2), np.int64)
    c = 0.0
    for i in range(T1):
        # drift toward the diagonal plus noise; occasional stalls/jumps
        target = i * T2 / T1
        c += 0.3 * (target - c) + rng.randn() * 1.5
        w = max(2, int(base_w + rng.randint(-jitter, jitter + 1)))
        env[i, 0] = max(0, int(c) - w)
        env[i, 1] = min(T2, int(c) + w + 1)
    # reference validity fixes (same dance as diag_env).  Both bounds are
    # made monotone: a *dipping* upper bound below a live node's band end
    # trips the reference's own assert (src/duplex.rs:364 current_end <
    # upper_bound fires when upper_t rises above last_upper_bound but not
    # above an earlier band end) — alignment envelopes are monotone, so
    # the fixture stays in reference-valid territory.
    env[:, 0] = np.maximum.accumulate(env[:, 0])
    env[:, 1] = np.maximum.accumulate(env[:, 1])
    last = 0
    for i in range(T1):
        env[i, 0] = min(env[i, 0], last)
        env[i, 1] = max(env[i, 1], env[i, 0] + 1)
        last = max(last, env[i, 1])
    return env


def test_jagged_envelope_fast_vs_exact_constant_free():
    """The rel-window fast engine's replayed W/Wext sizing must hold on
    jagged envelopes (it is exercised well beyond the constant-slide
    diag_env case); sequences are compared to the tree engine only on
    seeds where rebuild == reuse (both semantics agree on ~13% of
    weak-signal trials; here we assert the *sizing* never crashes and
    the exact engine matches the oracle everywhere)."""
    T1, T2 = 40, 44
    for seed in (3, 4, 5):
        env = jagged_env(T1, T2, seed)
        n1 = random_data(T1, 5, 50 + seed)
        n2 = random_data(T2, 5, 150 + seed)
        e = beam_search_duplex(
            n1, n2, "NACGT", envelope=env, engine="exact"
        )
        want = oracle.beam_search_duplex(n1, n2, "NACGT", env, 5, 0.0)
        assert e == want, seed
        f = beam_search_duplex(n1, n2, "NACGT", envelope=env, engine="fast")
        assert len(f) > 0  # sizing/replay holds; semantics may differ


def test_jagged_envelope_band_reuse_kernel():
    """The batch decoder routes jagged alignment envelopes to the tree
    engine on its own and decodes them with reference band-reuse
    semantics (oracle-equal)."""
    T1, T2, B = 16, 18, 8
    env = jagged_env(T1, T2, 11, base_w=4, jitter=2)
    n1 = np.stack([random_data(T1, 4, 60 + i) for i in range(B)])
    n2 = np.stack([random_data(T2, 4, 160 + i) for i in range(B)])
    dec = BatchDuplexDecoder("NACG", T1=T1, T2=T2)
    res = dec.decode(n1, n2, envelopes=env)
    for i in range(B):
        seq, err = res[i]
        assert err == 0
        want = oracle.beam_search_duplex(n1[i], n2[i], "NACG", env, 5, 0.0)
        assert seq == want, i
