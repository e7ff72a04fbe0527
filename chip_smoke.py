#!/usr/bin/env python3
"""Smoke test of the decoder on NVIDIA GPUs, through the entry points users
call, at the benchmark size.  One process drives the card(s).

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the data-parallel path

Phases (one card):
  api       the six public functions on the reference's golden fixtures
            and error probes
  headline  BatchBeamDecoder at T=1000 x B=32768, beam 5, cut 0.1 on
            device-resident inputs: oracle gate on 64 sampled reads, the
            Triton kernel against the XLA scan engine on every read,
            times, compiled memory
  stream    decode_many over ragged reads, interrupted and resumed from
            its checkpoint
  serve     the HTTP server in a thread of this process
  families  viterbi, CRF beam and duplex (constant and moving windows)
            batch decoders against the oracle

It exits non-zero, without the final result line, when JAX finds no GPU,
when it is not run from a checkout of this repository, or when any phase
fails.  The last line printed on success is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20241016
ALPHABET = "NACGT"
# (reads, frames, ...) per phase: the benchmark shape for the headline
SIZES = {
    "headline": (32768, 1000),
    "stream": (3000, 200, 4000, 512),  # reads, shortest, longest, batch
    "viterbi": (8192, 1000),
    "crf": (64, 400, 64),
    "duplex": (8, 60, 64),
    "four-cards": (4 * 32768, 1000),
}


def log(*a):
    print(*a, flush=True)


def timed(fn, n):
    """Median seconds of ``n`` calls, each ending in block_until_ready."""
    import jax

    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def seq_of(labels_rev, count):
    return "".join(ALPHABET[int(l) + 1] for l in labels_rev[:count][::-1])


def random_posteriors(key, B, T, A1):
    """L2-normalized uniform posteriors, made on the device."""
    import jax
    import jax.numpy as jnp

    x = jax.random.uniform(key, (B, T, A1), jnp.float32)
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


# ---------------------------------------------------------------- phases


def phase_api(ctx):
    import fast_ctc_decode_tpu as fcd

    # reference src/search.rs test_viterbi fixture (tests/test_parity_reference)
    rust = np.array(
        [
            [0.0, 0.4, 0.6], [0.0, 0.3, 0.7], [0.3, 0.3, 0.4],
            [0.4, 0.3, 0.3], [0.4, 0.3, 0.3], [0.3, 0.3, 0.4],
            [0.1, 0.4, 0.5], [0.1, 0.5, 0.4], [0.8, 0.1, 0.1],
            [0.1, 0.1, 0.8],
        ],
        np.float32,
    )
    got = fcd.viterbi_search(rust, "NAG", True, 1.0, 0.0, True)
    assert got == ("GGAG%$$(", [0, 5, 7, 9]), got
    got = fcd.beam_search(rust, "NAG", 5, 0.1)
    assert got == ("GAGAG", [0, 1, 2, 4, 6]), got
    x = np.array(
        [[0.01, 0.98, 0.01], [0.01, 0.34, 0.65], [0.01, 0.98, 0.01],
         [0.01, 0.01, 0.98]],
        np.float32,
    )
    y = np.array(
        [[0.0, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0],
         [0.0, 0.0, 1.0]],
        np.float32,
    )
    assert fcd.beam_search(x, "NAB")[0] == "ABAB"
    assert fcd.beam_search_duplex(x, y, "NAB") == "AB"

    import oracle

    rng = np.random.RandomState(SEED)
    crf = rng.rand(40, 16, 5).astype(np.float32)
    crf /= crf.sum(-1, keepdims=True)
    init = rng.rand(16).astype(np.float32)
    assert fcd.crf_beam_search(crf, init, ALPHABET, 5, 0.0) == tuple(
        oracle.crf_beam_search(crf, init, ALPHABET, 5, 0.0)
    )
    seq, path = fcd.crf_greedy_search(crf, init, ALPHABET)
    assert len(seq) == len(path) > 0
    crf2 = rng.rand(44, 16, 5).astype(np.float32)
    crf2 /= crf2.sum(-1, keepdims=True)
    assert fcd.crf_beam_search_duplex(crf, init, crf2, init, ALPHABET) == (
        oracle.crf_beam_search_duplex(crf, init, crf2, init, ALPHABET)
    )

    # error probes (the reference's messages)
    r = rng.rand(100, 5).astype(np.float32)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    probes = [
        (lambda: fcd.beam_search(r, ALPHABET, 0), ValueError, "beam_size cannot be 0"),
        (lambda: fcd.beam_search(r, ALPHABET, 5, 0.2), ValueError, "cannot be more than"),
        (lambda: fcd.beam_search(r, "NACG"), ValueError, "alphabet size"),
        (lambda: fcd.beam_search(np.full((20, 5), np.nan, np.float32), ALPHABET),
         RuntimeError, "Failed to compare values"),
        (lambda: fcd.beam_search(r.astype(np.float64), ALPHABET), TypeError, "float32"),
        (lambda: fcd.beam_search_duplex(
            r[:4], r[:4], ALPHABET, envelope=np.array([[0, 4], [3, 1], [0, 4], [0, 4]])),
         RuntimeError, "Invalid envelope values"),
    ]
    for fn, exc, msg in probes:
        try:
            fn()
        except exc as e:
            assert msg in str(e), (msg, str(e))
        else:
            raise AssertionError(f"no {exc.__name__} for {msg!r}")
    assert fcd.beam_search(np.zeros((0, 5), np.float32), ALPHABET) == ("", [])
    assert fcd.beam_search(r, ["N", "AA", "C", "G", "T"], 5, 0.1)[0]
    log("[api] goldens GGAG%$$( / GAGAG / AB, crf beam and duplex == oracle, "
        f"{len(probes) + 2} error and edge probes")


def _near_tie_gap(probs_read, t_sel, K):
    """Smallest relative gap between adjacent candidates among the best
    K+1 of the oracle's step ``t_sel`` (the step whose selection the two
    engines made differently)."""
    import oracle

    seen = {}

    def on_step(t, scores):
        if t == t_sel:
            seen["s"] = [float(x) for x in scores[: K + 1]]

    oracle.beam_search(probs_read, ALPHABET, K, 0.1, on_step=on_step)
    s = seen["s"]
    gaps = [(s[i] - s[i + 1]) / abs(s[i]) for i in range(len(s) - 1) if s[i]]
    return min(gaps) if gaps else float("inf")


def phase_headline(ctx):
    import jax
    import jax.numpy as jnp

    import oracle
    from fast_ctc_decode_tpu.ops import beam_fast, beam_pallas
    from fast_ctc_decode_tpu.parallel.pipeline import BatchBeamDecoder

    (B, T), A1, K, thr = SIZES["headline"], 5, 5, 0.1
    dev = jax.devices()[0]
    probs = jax.device_put(
        jax.jit(lambda k: random_posteriors(k, B, T, A1))(
            jax.random.PRNGKey(SEED)
        ),
        dev,
    )
    lens = jax.device_put(jnp.full((B,), T, jnp.int32), dev)

    decs = {
        "auto": BatchBeamDecoder(ALPHABET, T=T, beam_size=K, beam_cut_threshold=thr),
        "fast": BatchBeamDecoder(ALPHABET, T=T, beam_size=K, beam_cut_threshold=thr,
                                 engine="fast"),
    }
    assert decs["auto"].engine == "pallas", decs["auto"].engine
    comp = {}
    for name, dec in decs.items():
        t0 = time.perf_counter()
        comp[name] = jax.jit(dec.decode_arrays).lower(probs, lens).compile()
        log(f"[headline] {name} ({dec.engine}): compile {time.perf_counter() - t0:.2f} s")
        ma = comp[name].memory_analysis()
        if ma is not None:
            log(f"[headline] {name} memory_analysis: args {ma.argument_size_in_bytes} "
                f"out {ma.output_size_in_bytes} temp {ma.temp_size_in_bytes} bytes")
    outs = {n: jax.block_until_ready(c(probs, lens)) for n, c in comp.items()}

    # hard gate: the kernel's sequences equal the oracle's
    host = {k: np.asarray(v) for k, v in outs["auto"].items()}
    assert not host["err"].any(), "decode errors"
    sample = np.unique(np.linspace(0, B - 1, 64).astype(int))
    sub = np.asarray(probs[sample])
    for j, i in enumerate(sample):
        want, _ = oracle.beam_search(sub[j], ALPHABET, K, thr)
        got = seq_of(host["labels_rev"][i], host["count"][i])
        assert got == want, f"read {i}: kernel {got!r} != oracle {want!r}"
    log(f"[headline] oracle gate: {len(sample)}/{len(sample)} sampled reads "
        f"equal at T={T} x B={B}")

    # kernel vs XLA scan engine on every read: sequences and id logs
    f = {k: np.asarray(v) for k, v in outs["fast"].items()}
    seq_diff = (host["labels_rev"] != f["labels_rev"]).any(1) | (
        host["count"] != f["count"]
    )
    raw_k = beam_pallas.beam_search_pallas_batch(probs, lens, np.float32(thr),
                                                 beam_size=K, raw=True)
    raw_f = beam_fast.beam_search_fast_batch(probs, lens, np.float32(thr),
                                             beam_size=K, raw=True)
    step_diff = jnp.any(
        raw_k["ids_log"] != jnp.transpose(raw_f["ids_log"], (0, 2, 1)), axis=1
    )  # [T, B]
    log_diff = np.asarray(jnp.any(step_diff, axis=0))
    first = np.asarray(jnp.argmax(step_diff, axis=0))
    bad = np.flatnonzero(seq_diff | log_diff)
    log(f"[headline] kernel vs XLA fast: {int(seq_diff.sum())} reads differ in "
        f"sequence, {int(log_diff.sum())} in the id log, of {B}")
    ties = 0
    for i in bad:
        x = np.asarray(probs[i])
        gap = _near_tie_gap(x, int(first[i]) - 1, K) if log_diff[i] else np.nan
        want, _ = oracle.beam_search(x, ALPHABET, K, thr)
        ok = gap < 1e-5
        ties += ok
        log(f"[headline]   read {i}: first id-log difference at t={first[i]}, "
            f"oracle relative gap {gap:.3g} ({'near-tie' if ok else 'NOT a near-tie'}); "
            f"kernel==oracle {seq_of(host['labels_rev'][i], host['count'][i]) == want}, "
            f"fast==oracle {seq_of(f['labels_rev'][i], f['count'][i]) == want}")
    assert ties == len(bad), f"{len(bad) - ties} differences are not near-ties"

    # times: warm, then alternate engines; each call ends in block_until_ready
    res = {n: [] for n in comp}
    for _ in range(5):
        for n, c in comp.items():
            res[n].extend(timed(lambda: c(probs, lens), 1)[1])
    for n in comp:
        med = float(np.median(res[n]))
        log(f"[headline] {n} ({decs[n].engine}) decode_arrays: median "
            f"{med * 1e3:.3f} ms = {B / med:,.0f} reads/s "
            f"(runs ms: {[round(t * 1e3, 3) for t in res[n]]})")
    raw_fn = jax.jit(lambda p, l: beam_pallas.beam_search_pallas_batch(
        p, l, np.float32(thr), beam_size=K, raw=True))
    tb_k = jax.jit(lambda fi, ids: beam_pallas.traceback_pallas_batch(
        fi, ids, T=T, K=K, A=A1 - 1))
    tb_x = jax.jit(lambda fi, ids: beam_fast._traceback_scan_batch(
        fi, ids, T, K, A1 - 1))
    raw = raw_fn(probs, lens)
    for name, fn in (("decode kernel (raw)", lambda: raw_fn(probs, lens)),
                     ("traceback kernel", lambda: tb_k(raw["fin"], raw["ids_log"])),
                     ("traceback XLA scan", lambda: tb_x(raw["fin"], raw["ids_log"]))):
        jax.block_until_ready(fn())
        med, _ = timed(fn, 5)
        log(f"[headline] {name}: median {med * 1e3:.3f} ms")
    same = [np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
            zip(tb_k(raw["fin"], raw["ids_log"]), tb_x(raw["fin"], raw["ids_log"]))]
    assert all(same), "traceback kernel != XLA scan traceback"
    stats = dev.memory_stats() or {}
    log(f"[headline] peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    ctx["probs_sample"] = sub[:4]


def phase_stream(ctx, tmpdir):
    from fast_ctc_decode_tpu.parallel import pipeline
    from fast_ctc_decode_tpu.utils.checkpoint import DecodeCheckpoint

    import oracle

    n, lo, hi, batch = SIZES["stream"]
    rng = np.random.RandomState(SEED + 1)
    lengths = rng.randint(lo, hi + 1, size=n)
    reads = []
    for L in lengths:
        r = rng.rand(L, 5).astype(np.float32)
        reads.append(r / np.linalg.norm(r, axis=1, keepdims=True))
    kw = dict(beam_size=5, beam_cut_threshold=0.1, batch_size=batch)
    ck = str(Path(tmpdir) / "decode_many.ckpt.jsonl")

    t0 = time.perf_counter()
    full = pipeline.decode_many(reads, ALPHABET, **kw)
    log(f"[stream] decode_many, {len(reads)} reads of {lo}-{hi} frames, "
        f"no checkpoint: {time.perf_counter() - t0:.2f} s (compiles included)")

    class Killed(Exception):
        pass

    real = DecodeCheckpoint.record
    calls = {"n": 0}

    def record_then_die(self, idxs, res):
        real(self, idxs, res)
        calls["n"] += 1
        if calls["n"] == 3:
            raise Killed()

    DecodeCheckpoint.record = record_then_die
    try:
        pipeline.decode_many(reads, ALPHABET, checkpoint_path=ck, **kw)
        raise AssertionError("the interrupted run did not stop")
    except Killed:
        pass
    finally:
        DecodeCheckpoint.record = real
    with open(ck) as fh:
        done = sum(len(json.loads(line).get("i", [])) for line in fh)
    assert 0 < done < len(reads), done
    t0 = time.perf_counter()
    resumed = pipeline.decode_many(reads, ALPHABET, checkpoint_path=ck, **kw)
    log(f"[stream] interrupted after 3 batches ({done} reads checkpointed), "
        f"resumed in {time.perf_counter() - t0:.2f} s")
    assert [tuple(r) for r in resumed] == [tuple(r) for r in full]
    for i in rng.choice(len(reads), 6, replace=False):
        assert full[i][0] == oracle.beam_search(reads[i], ALPHABET, 5, 0.1)[0], i
    log("[stream] resumed results equal the uninterrupted run; 6 reads equal the oracle")


def phase_serve(ctx):
    import http.client
    import threading

    import fast_ctc_decode_tpu as fcd
    from fast_ctc_decode_tpu import serve

    rng = np.random.RandomState(SEED + 2)

    def rand_read(T):
        r = rng.rand(T, 5).astype(np.float32)
        return r / np.linalg.norm(r, axis=1, keepdims=True)

    httpd = serve.make_http_server("127.0.0.1", 0, microbatch=True)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()

    def post(req):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/", json.dumps(req))
        r = conn.getresponse()
        out = (r.status, json.loads(r.read()))
        conn.close()
        return out

    base = {"alphabet": list(ALPHABET), "beam_size": 5, "beam_cut_threshold": 0.1}
    try:
        singles = [rand_read(300) for _ in range(4)]
        res = [None] * len(singles)

        def one(i):
            res[i] = post({**base, "method": "beam_search",
                           "posteriors": singles[i].ravel().tolist(),
                           "shape": [300, 5]})

        ths = [threading.Thread(target=one, args=(i,)) for i in range(len(singles))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(600)
        for x, (status, out) in zip(singles, res):
            assert status == 200, out
            assert out["seq"] == fcd.beam_search(x, ALPHABET, 5, 0.1)[0]

        v = rand_read(500)
        status, out = post({"method": "viterbi_search", "alphabet": list(ALPHABET),
                            "posteriors": v.ravel().tolist(), "shape": [500, 5]})
        assert status == 200, out
        assert (out["seq"], out["starts"]) == fcd.viterbi_search(v, ALPHABET)

        batch = np.stack([rand_read(500) for _ in range(16)])
        status, out = post({**base, "method": "beam_search",
                            "posteriors": batch.ravel().tolist(),
                            "shape": [16, 500, 5]})
        assert status == 200, out
        for x, r in zip(batch, out["results"]):
            assert r["err"] == 0 and r["seq"] == fcd.beam_search(x, ALPHABET, 5, 0.1)[0]

        status, out = post({**base, "method": "beam_search", "posteriors": [1.0],
                            "shape": [2, 5]})
        assert status == 400 and "error" in out, (status, out)
    finally:
        httpd.shutdown()
        httpd.server_close()
        serve.disable_microbatching()
        th.join(60)
    log("[serve] HTTP microbatch: 4 concurrent single reads, viterbi, a 16-read "
        "batch and a bad request answered as the API does")


def phase_families(ctx):
    import jax

    import oracle
    from fast_ctc_decode_tpu.parallel.pipeline import (
        BatchCrfBeamDecoder,
        BatchDuplexDecoder,
        BatchViterbiDecoder,
    )
    import fast_ctc_decode_tpu as fcd

    from test_realistic_envelope import jagged_env

    rng = np.random.RandomState(SEED + 3)

    B, T = SIZES["viterbi"]
    v = np.asarray(random_posteriors(jax.random.PRNGKey(SEED + 3), B, T, 5))
    dec = BatchViterbiDecoder(ALPHABET, T=T)
    t0 = time.perf_counter()
    out = dec.decode(v, np.full((B,), T, np.int32))
    log(f"[families] viterbi B={B} T={T}: {time.perf_counter() - t0:.2f} s "
        "(compile included)")
    for i in (0, B // 2, B - 1):
        assert out[i] == fcd.viterbi_search(v[i], ALPHABET), i

    B, T, S = SIZES["crf"]
    x = rng.rand(B, T, S, 5).astype(np.float32)
    x /= x.sum(-1, keepdims=True)
    init = rng.rand(B, S).astype(np.float32)
    dec = BatchCrfBeamDecoder(ALPHABET, T=T, n_state=S, beam_size=5,
                              beam_cut_threshold=0.01)
    t0 = time.perf_counter()
    out = dec.decode(x, init, np.full((B,), T, np.int32))
    log(f"[families] CRF beam B={B} T={T} S={S} ({dec.engine}): "
        f"{time.perf_counter() - t0:.2f} s (compile included)")
    for i in (0, B - 1):
        want, _ = oracle.crf_beam_search(x[i], init[i], ALPHABET, 5, 0.01)
        assert out[i][0] == want and out[i][2] == 0, i

    # duplex: a constant (full-range) window and a jagged moving envelope
    B, T1, T2 = SIZES["duplex"]

    def reads(T):
        r = rng.rand(B, T, 5).astype(np.float32)
        return r / np.linalg.norm(r, axis=-1, keepdims=True)

    n1, n2 = reads(T1), reads(T2)
    full = np.zeros((T1, 2), np.int64)
    full[:, 1] = T2
    for name, env in (("constant window", full),
                      ("jagged moving envelope", jagged_env(T1, T2, 11))):
        dec = BatchDuplexDecoder(ALPHABET, T1=T1, T2=T2)
        t0 = time.perf_counter()
        out = dec.decode(n1, n2, envelopes=env)
        log(f"[families] duplex {name} B={B} T1={T1} T2={T2}: "
            f"{time.perf_counter() - t0:.2f} s (compile included)")
        for i in (0, B - 1):
            want = oracle.beam_search_duplex(n1[i], n2[i], ALPHABET, env, 5, 0.0)
            assert out[i] == (want, 0), (name, i)


def phase_four_cards(ctx):
    import jax
    import jax.numpy as jnp

    from fast_ctc_decode_tpu.parallel.mesh import batch_sharding, make_data_mesh
    from fast_ctc_decode_tpu.parallel.pipeline import (
        BatchBeamDecoder,
        decode_and_count,
    )

    devs = jax.devices()
    assert len(devs) == 4, f"--four-cards needs 4 GPUs, JAX sees {len(devs)}"
    (B, T), K, thr = SIZES["four-cards"], 5, 0.1
    mesh4 = make_data_mesh(devs)
    mesh1 = make_data_mesh(devs[:1])
    probs4 = jax.jit(
        lambda k: random_posteriors(k, B, T, 5),
        out_shardings=batch_sharding(mesh4),
    )(jax.random.PRNGKey(SEED))
    lens4 = jax.device_put(jnp.full((B,), T, jnp.int32), batch_sharding(mesh4))
    probs1 = jax.device_put(probs4, devs[0])
    lens1 = jax.device_put(lens4, devs[0])

    outs, rates = {}, {}
    for name, mesh, p, l in (("1 card", mesh1, probs1, lens1),
                             ("4 cards", mesh4, probs4, lens4)):
        dec = BatchBeamDecoder(ALPHABET, T=T, beam_size=K,
                               beam_cut_threshold=thr, mesh=mesh)
        assert dec.engine == "pallas", dec.engine
        t0 = time.perf_counter()
        fn = jax.jit(dec.decode_arrays).lower(p, l).compile()
        comp = time.perf_counter() - t0
        outs[name] = jax.block_until_ready(fn(p, l))
        med, runs = timed(lambda: fn(p, l), 5)
        rates[name] = B / med
        log(f"[four-cards] BatchBeamDecoder {name}: compile {comp:.2f} s, median "
            f"{med * 1e3:.3f} ms = {B / med:,.0f} reads/s "
            f"(runs ms: {[round(t * 1e3, 3) for t in runs]})")
        out, totals = decode_and_count(mesh, p, l, beam_size=K, threshold=thr,
                                       collapse=True)
        totals = np.asarray(totals)
        assert totals.tolist() == [B, 0], totals
        assert np.array_equal(np.asarray(out["labels_rev"]),
                              np.asarray(outs[name]["labels_rev"]))
        log(f"[four-cards] decode_and_count {name}: psum totals {totals.tolist()}")
    a, b = outs["1 card"], outs["4 cards"]
    diff = (np.asarray(a["labels_rev"]) != np.asarray(b["labels_rev"])).any(1) | (
        np.asarray(a["count"]) != np.asarray(b["count"]))
    assert not diff.any(), f"{int(diff.sum())} reads differ between 1 and 4 cards"
    log(f"[four-cards] {B} reads: identical sequences on 1 and 4 cards; "
        f"speedup {rates['4 cards'] / rates['1 card']:.3f}x")


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card data-parallel phase")
    args = ap.parse_args(argv)
    if not (ROOT / "fast_ctc_decode_tpu").is_dir() or not (
        ROOT / "tests" / "oracle.py"
    ).is_file():
        print(f"chip_smoke.py must run from a checkout of the repository "
              f"(no package beside {__file__})", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

    import jax

    from fast_ctc_decode_tpu import device

    device.use_compile_cache()
    try:
        info = device.require_gpu()
    except RuntimeError as exc:
        print(f"chip_smoke.py: {exc}", file=sys.stderr)
        return 1
    log(device.card_line())
    log(f"[device] {info['platform']} {info['kind']} x{info['count']}, "
        f"jax {jax.__version__}")
    from fast_ctc_decode_tpu.native import get_lib

    log(f"[device] native detokenizer loaded: {get_lib() is not None}")

    import tempfile

    ctx: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        if args.four_cards:
            phases = [("four-cards", phase_four_cards)]
        else:
            phases = [
                ("api", phase_api),
                ("headline", phase_headline),
                ("stream", lambda c: phase_stream(c, tmp)),
                ("serve", phase_serve),
                ("families", phase_families),
            ]
        failed = []
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn(ctx)
            except Exception:  # reported, and the exit code says so
                traceback.print_exc()
                failed.append(name)
                log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
                continue
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke.py: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
