"""Tests for the JSON decode service (C2 analog) and checkpoint/resume."""

import json
import os

import numpy as np

from fast_ctc_decode_tpu import beam_search, viterbi_search
from fast_ctc_decode_tpu.serve import decode_json, decode_request
from fast_ctc_decode_tpu.parallel.pipeline import decode_many


def rand_read(T, A1, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=1, keepdims=True)


class TestServe:
    def test_beam_request_matches_api(self):
        x = rand_read(20, 5, 0)
        req = {
            "method": "beam_search",
            "posteriors": x.reshape(-1).tolist(),
            "shape": [20, 5],
            "alphabet": ["N", "A", "C", "G", "T"],
            "beam_size": 5,
            "beam_cut_threshold": 0.1,
        }
        out = decode_request(req)
        seq, starts = beam_search(x, "NACGT", 5, 0.1)
        assert out == {"seq": seq, "starts": starts}

    def test_viterbi_request_matches_api(self):
        # the reference wasm fixture matrix (tests/index.html:9-18)
        x = np.array(
            [
                [0.0, 0.4, 0.6], [0.0, 0.3, 0.7], [0.3, 0.3, 0.4],
                [0.4, 0.3, 0.3], [0.4, 0.3, 0.3], [0.3, 0.3, 0.4],
                [0.1, 0.4, 0.5], [0.1, 0.5, 0.4], [0.8, 0.1, 0.1],
                [0.1, 0.1, 0.8],
            ],
            np.float32,
        )
        req = {
            "method": "viterbi_search",
            "posteriors": x.reshape(-1).tolist(),
            "shape": [10, 3],
            "alphabet": ["N", "A", "G"],
        }
        out = decode_request(req)
        seq, starts = viterbi_search(x, "NAG")
        assert out["seq"] == seq == "GGAG"
        assert out["starts"] == starts

    def test_batch_request_matches_api(self):
        reads = [rand_read(20, 5, s) for s in range(5)]
        x = np.stack(reads)
        req = {
            "method": "beam_search",
            "posteriors": x.reshape(-1).tolist(),
            "shape": [5, 20, 5],
            "alphabet": ["N", "A", "C", "G", "T"],
            "beam_size": 5,
            "beam_cut_threshold": 0.1,
        }
        out = decode_request(req)
        assert len(out["results"]) == 5
        # batch requests ride the pipeline's fast engine: sequences match
        # the reference exactly; compare paths against the same engine
        for r, read in zip(out["results"], reads):
            seq, starts = beam_search(read, "NACGT", 5, 0.1, engine="fast")
            assert (r["seq"], r["starts"], r["err"]) == (seq, starts, 0)

    def test_batch_viterbi_with_qstring(self):
        reads = [rand_read(16, 5, s) for s in range(3)]
        x = np.stack(reads)
        req = {
            "method": "viterbi_search",
            "posteriors": x.reshape(-1).tolist(),
            "shape": [3, 16, 5],
            "alphabet": "NACGT",
            "qstring": True,
        }
        out = decode_request(req)
        for r, read in zip(out["results"], reads):
            seq, starts = viterbi_search(read, "NACGT", qstring=True)
            assert (r["seq"], r["starts"]) == (seq, starts)

    def test_http_status_codes(self):
        from fast_ctc_decode_tpu.serve import handle_json

        x = rand_read(10, 5, 1)
        good = json.dumps(
            {
                "method": "beam_search",
                "posteriors": x.reshape(-1).tolist(),
                "shape": [10, 5],
                "alphabet": "NACGT",
            }
        )
        _, code = handle_json(good)
        assert code == 200
        # input errors are 400 (typed, not string-sniffed)
        for bad in (
            "not json",
            '{"method": "nope", "shape": [1, 2], "posteriors": [0.5, 0.5], "alphabet": "NA"}',
            '{"shape": [10, 5]}',  # KeyError: posteriors
        ):
            body, code = handle_json(bad)
            assert code == 400
            assert "error" in json.loads(body)
        # a NaN posterior surfaces the reference's RuntimeError as 400
        # (NaN must sit on a *label* column to enter the beam; a NaN blank
        # fails the > threshold push test in the reference too)
        xn = np.full((10, 5), np.nan, np.float32)
        nan_req = json.dumps(
            {
                "method": "beam_search",
                "posteriors": xn.reshape(-1).tolist(),
                "shape": [10, 5],
                "alphabet": "NACGT",
            }
        )
        body, code = handle_json(nan_req)
        assert code == 400
        assert "Failed to compare values" in json.loads(body)["error"]

    def test_json_roundtrip_and_errors(self):
        x = rand_read(10, 5, 1)
        req = json.dumps(
            {
                "method": "beam_search",
                "posteriors": x.reshape(-1).tolist(),
                "shape": [10, 5],
                "alphabet": "NACGT",
            }
        )
        out = json.loads(decode_json(req))
        assert set(out) == {"seq", "starts"}
        # structured error instead of the reference wasm's "Error" string
        bad = json.loads(decode_json('{"method": "nope", "shape": [1, 2]}'))
        assert "error" in bad
        bad = json.loads(decode_json("not json"))
        assert "error" in bad


class TestDecodeMany:
    def test_resume_from_checkpoint(self, tmp_path):
        reads = [rand_read(t, 5, i) for i, t in enumerate([30, 17, 30, 9, 25])]
        ckpt = str(tmp_path / "run.jsonl")

        full = decode_many(
            reads, "NACGT", beam_size=5, beam_cut_threshold=0.1,
            batch_size=16, T=30, checkpoint_path=None,
        )
        # simulate preemption: decode only the first two reads, then resume
        # over the full list — indices 0/1 must come from the checkpoint
        decode_many(
            reads[:2], "NACGT", beam_size=5, beam_cut_threshold=0.1,
            batch_size=16, T=30, checkpoint_path=ckpt,
        )
        resumed = decode_many(
            reads, "NACGT", beam_size=5, beam_cut_threshold=0.1,
            batch_size=16, T=30, checkpoint_path=ckpt,
        )
        assert [r[0] for r in resumed] == [r[0] for r in full]
        # already-complete checkpoint returns without decoding
        again = decode_many(
            reads, "NACGT", beam_size=5, beam_cut_threshold=0.1,
            batch_size=16, T=30, checkpoint_path=ckpt,
        )
        assert [tuple(r) for r in again] == [tuple(r) for r in resumed]
        # the checkpoint is JSONL: header + one line per batch (O(batch)
        # appends, not a rewrite of the whole result set)
        with open(ckpt) as f:
            lines = f.read().splitlines()
        assert json.loads(lines[0])["meta"]["beam_size"] == 5
        assert all("i" in json.loads(l) for l in lines[1:])

    def test_truncated_trailing_line_tolerated(self, tmp_path):
        reads = [rand_read(20, 5, i) for i in range(3)]
        ckpt = str(tmp_path / "run.jsonl")
        decode_many(reads, "NACGT", T=20, checkpoint_path=ckpt)
        full = decode_many(reads, "NACGT", T=20, checkpoint_path=ckpt)
        # simulate a crash mid-append: garbage partial line at the end
        with open(ckpt, "a") as f:
            f.write('{"i": [99], "r"')
        again = decode_many(reads, "NACGT", T=20, checkpoint_path=ckpt)
        assert [r[0] for r in again] == [r[0] for r in full]

    def test_bucketing_matches_single_bucket(self, tmp_path):
        # mixed lengths spanning several power-of-2 buckets
        lens = [10, 100, 140, 257, 30, 512, 33]
        reads = [rand_read(t, 5, i) for i, t in enumerate(lens)]
        one_bucket = decode_many(
            reads, "NACGT", beam_cut_threshold=0.1, T=512, batch_size=8
        )
        bucketed = decode_many(
            reads, "NACGT", beam_cut_threshold=0.1, batch_size=8
        )
        assert [r[0] for r in bucketed] == [r[0] for r in one_bucket]
        assert [r[1] for r in bucketed] == [r[1] for r in one_bucket]

    def test_mismatched_params_rejected(self, tmp_path):
        import pytest

        reads = [rand_read(10, 5, 0)]
        ckpt = str(tmp_path / "run.jsonl")
        decode_many(reads, "NACGT", beam_size=5, checkpoint_path=ckpt)
        with pytest.raises(ValueError, match="different decode parameters"):
            decode_many(reads, "NACGT", beam_size=7, checkpoint_path=ckpt)


class TestWasmGoldens:
    """The reference's browser-test golden values (tests/fast_ctc_wasm.test.js:
    29-46 + tests/index.html:9-18), driven through the JSON service — the
    direct analog of the WASM entry points it exercises."""

    MATRIX = [
        [0.0, 0.4, 0.6], [0.0, 0.3, 0.7], [0.3, 0.3, 0.4],
        [0.4, 0.3, 0.3], [0.4, 0.3, 0.3], [0.3, 0.3, 0.4],
        [0.1, 0.4, 0.5], [0.1, 0.5, 0.4], [0.8, 0.1, 0.1],
        [0.1, 0.1, 0.8],
    ]

    def test_beam_golden(self):
        req = {
            "method": "beam_search",
            "posteriors": [x for row in self.MATRIX for x in row],
            "shape": [10, 3],
            "alphabet": ["N", "A", "G"],
            "beam_size": 5,
            "beam_cut_threshold": 0.1,
        }
        out = decode_request(req)
        assert out == {"seq": "GAGAG", "starts": [0, 1, 2, 4, 6]}

    def test_viterbi_golden(self):
        req = {
            "method": "viterbi_search",
            "posteriors": [x for row in self.MATRIX for x in row],
            "shape": [10, 3],
            "alphabet": ["N", "A", "G"],
        }
        out = decode_request(req)
        assert out == {"seq": "GGAG", "starts": [0, 5, 7, 9]}


class TestCrashRecoveryChain:
    def test_truncated_line_then_append_then_reload(self, tmp_path):
        # crash leaves a truncated line WITHOUT newline; the next run's
        # appends must not merge into it (regression: the merged line
        # poisoned every later record on the third load)
        from fast_ctc_decode_tpu.utils.checkpoint import DecodeCheckpoint

        ckpt = str(tmp_path / "run.jsonl")
        c1 = DecodeCheckpoint.load_or_create(ckpt, {"v": 1})
        c1.record([0], [("A", [0], 0)])
        c1.close()
        with open(ckpt, "a") as f:
            f.write('{"i": [9], "r"')  # no trailing newline
        c2 = DecodeCheckpoint.load_or_create(ckpt, {"v": 1})
        assert set(c2.done) == {0}
        c2.record([1], [("C", [1], 0)])
        c2.close()
        c3 = DecodeCheckpoint.load_or_create(ckpt, {"v": 1})
        assert set(c3.done) == {0, 1}
        assert c3.done[1] == ("C", [1], 0)


class TestServeDecoderCache:
    def test_nearby_lengths_share_compiled_decoder(self):
        """T is rounded up to a power-of-two bucket edge before keying the
        decoder cache, so nearby-T batch requests reuse ONE compiled
        decoder instead of compiling per distinct T."""
        from fast_ctc_decode_tpu import serve

        serve._DECODER_CACHE.clear()
        results = []
        for T, seed in ((100, 1), (120, 2)):
            reads = np.stack([rand_read(T, 5, seed + i) for i in range(2)])
            req = {
                "method": "beam_search",
                "posteriors": reads.reshape(-1).tolist(),
                "shape": [2, T, 5],
                "alphabet": ["N", "A", "C", "G", "T"],
                "beam_size": 5,
                "beam_cut_threshold": 0.1,
            }
            out = decode_request(req)
            results.append((reads, out))
        assert len(serve._DECODER_CACHE) == 1  # both T=100/T=120 -> T=128
        (key,) = serve._DECODER_CACHE
        assert key[2] == 128
        # padding to the bucket edge must not change the decode (the batch
        # pipeline runs the fast engine on the CPU, so compare to its
        # contract)
        for reads, out in results:
            for i, r in enumerate(out["results"]):
                seq, starts = beam_search(
                    reads[i], "NACGT", 5, 0.1, engine="fast"
                )
                assert (r["seq"], r["starts"], r["err"]) == (seq, starts, 0)


class TestMicroBatch:
    """Cross-request coalescing: concurrent single-read requests share one
    device batch (serve.MicroBatcher)."""

    def _req(self, x, method="beam_search", **kw):
        req = {
            "method": method,
            "posteriors": x.reshape(-1).tolist(),
            "shape": list(x.shape),
            "alphabet": ["N", "A", "C", "G", "T"],
        }
        req.update(kw)
        return req

    def test_concurrent_singles_coalesce(self):
        import threading

        from fast_ctc_decode_tpu import serve

        mb = serve.enable_microbatching(max_wait_ms=200.0)
        try:
            reads = [rand_read(20 + i, 5, 100 + i) for i in range(8)]
            outs = [None] * 8

            def run(i):
                outs[i] = decode_request(
                    self._req(reads[i], beam_size=5, beam_cut_threshold=0.1)
                )

            threads = [
                threading.Thread(target=run, args=(i,)) for i in range(8)
            ]
            b0 = mb.batches
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            # all 8 landed in one (or at most two, on scheduler skew)
            # device batches, and sequences match the single-read API
            assert mb.batches - b0 <= 2
            for i, x in enumerate(reads):
                seq, _ = beam_search(x, "NACGT", 5, 0.1)
                assert outs[i]["seq"] == seq
        finally:
            serve.disable_microbatching()

    def test_bad_request_fails_alone(self):
        import threading

        from fast_ctc_decode_tpu import serve

        mb = serve.enable_microbatching(max_wait_ms=100.0)
        try:
            good = rand_read(20, 5, 3)
            bad = rand_read(20, 5, 4)
            results = {}

            def run(name, req):
                body, code = __import__(
                    "fast_ctc_decode_tpu.serve", fromlist=["handle_json"]
                ).handle_json(json.dumps(req))
                results[name] = (json.loads(body), code)

            reqs = {
                "good": self._req(good, beam_size=5, beam_cut_threshold=0.1),
                # beam_size=0 must 400 at submit, never touching the batch
                "bad": self._req(bad, beam_size=0),
            }
            threads = [
                threading.Thread(target=run, args=(k, v))
                for k, v in reqs.items()
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert results["good"][1] == 200
            assert results["bad"][1] == 400
            assert "beam_size cannot be 0" in results["bad"][0]["error"]
        finally:
            serve.disable_microbatching()

    def test_viterbi_microbatch_matches_api(self):
        from fast_ctc_decode_tpu import serve

        serve.enable_microbatching(max_wait_ms=10.0)
        try:
            x = rand_read(24, 5, 9)
            out = decode_request(self._req(x, method="viterbi_search"))
            seq, path = viterbi_search(x, "NACGT")
            assert out == {"seq": seq, "starts": path}
        finally:
            serve.disable_microbatching()

    def test_qstring_variants_share_one_decoder(self):
        from fast_ctc_decode_tpu import serve

        serve.enable_microbatching(max_wait_ms=10.0)
        try:
            x = rand_read(24, 5, 21)
            keys0 = set(serve._DECODER_CACHE)
            out_plain = decode_request(self._req(x, method="viterbi_search"))
            out_q = decode_request(
                self._req(x, method="viterbi_search", qstring=True)
            )
            # qstring is a decode-time arg: both requests share ONE
            # BatchViterbiDecoder cache entry
            assert len(set(serve._DECODER_CACHE) - keys0) <= 1
            seq, path = viterbi_search(x, "NACGT")
            seq_q, path_q = viterbi_search(x, "NACGT", qstring=True)
            assert out_plain == {"seq": seq, "starts": path}
            assert out_q == {"seq": seq_q, "starts": path_q}
        finally:
            serve.disable_microbatching()

    def test_different_buckets_group_separately(self):
        import threading

        from fast_ctc_decode_tpu import serve
        from fast_ctc_decode_tpu.parallel.pipeline import _bucket_edge_for

        mb = serve.enable_microbatching(max_wait_ms=200.0)
        try:
            # T=20 and T=200 fall in different power-of-two buckets, so one
            # drain cycle runs two device batches
            reads = [rand_read(20, 5, 31), rand_read(200, 5, 32)]
            assert _bucket_edge_for(20) != _bucket_edge_for(200)
            outs = [None, None]

            def run(i):
                outs[i] = decode_request(
                    self._req(reads[i], beam_size=5, beam_cut_threshold=0.1)
                )

            b0 = mb.batches
            threads = [
                threading.Thread(target=run, args=(i,)) for i in range(2)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert mb.batches - b0 == 2
            for i, x in enumerate(reads):
                seq, _ = beam_search(x, "NACGT", 5, 0.1)
                assert outs[i]["seq"] == seq
        finally:
            serve.disable_microbatching()


class TestDecodeManyDuplex:
    def _pairs(self, sizes, seed=0):
        out = []
        for j, (t1, t2) in enumerate(sizes):
            out.append(
                (rand_read(t1, 5, seed + 2 * j), rand_read(t2, 5, seed + 2 * j + 1))
            )
        return out

    def test_matches_single_pair_api(self):
        from fast_ctc_decode_tpu import beam_search_duplex
        from fast_ctc_decode_tpu.parallel.pipeline import decode_many_duplex

        pairs = self._pairs([(20, 24), (150, 140), (18, 18), (20, 20)])
        res = decode_many_duplex(pairs, "NACGT", batch_size=8)
        assert len(res) == len(pairs)
        for (n1, n2), (seq, err) in zip(pairs, res):
            assert err == 0
            assert seq == beam_search_duplex(n1, n2, "NACGT")

    def test_resume_skips_decoded_pairs(self, tmp_path, monkeypatch):
        from fast_ctc_decode_tpu.parallel import pipeline

        pairs = self._pairs([(16, 16)] * 6, seed=50)
        ck = str(tmp_path / "dup.ckpt.jsonl")
        first = pipeline.decode_many_duplex(
            pairs, "NACGT", batch_size=4, checkpoint_path=ck
        )
        # a fresh run over the same checkpoint must not decode anything
        calls = []
        orig = pipeline.BatchDuplexDecoder.decode

        def spy(self, *a, **k):
            calls.append(1)
            return orig(self, *a, **k)

        monkeypatch.setattr(pipeline.BatchDuplexDecoder, "decode", spy)
        again = pipeline.decode_many_duplex(
            pairs, "NACGT", batch_size=4, checkpoint_path=ck
        )
        assert again == first
        assert not calls

    def test_envelope_pairs_roundtrip(self):
        import numpy as np

        from fast_ctc_decode_tpu import beam_search_duplex
        from fast_ctc_decode_tpu.parallel.pipeline import decode_many_duplex

        t1, t2 = 20, 22
        env = np.zeros((t1, 2), np.int64)
        env[:, 0] = 0
        env[:, 1] = t2  # constant window expressed as an explicit envelope
        n1 = rand_read(t1, 5, 70)
        n2 = rand_read(t2, 5, 71)
        res = decode_many_duplex([(n1, n2, env), (n1, n2)], "NACGT")
        want = beam_search_duplex(n1, n2, "NACGT", envelope=env)
        assert res[0] == (want, 0)
        assert res[1] == (want, 0)


class TestDecodeManyCrf:
    def _reads(self, lens, S=8, seed=0):
        rng = np.random.RandomState(seed)
        out = []
        for t in lens:
            p = rng.rand(t, S, 5).astype(np.float32)
            p /= p.sum(-1, keepdims=True)
            st = rng.rand(S).astype(np.float32)
            out.append((p, st))
        return out

    def test_matches_single_read_api(self):
        from fast_ctc_decode_tpu import crf_beam_search
        from fast_ctc_decode_tpu.parallel.pipeline import decode_many_crf

        reads = self._reads([20, 150, 18, 20])
        res = decode_many_crf(reads, "NACGT", batch_size=8)
        assert len(res) == len(reads)
        for (p, st), (seq, path, err) in zip(reads, res):
            assert err == 0
            want_seq, want_path = crf_beam_search(
                p, st, "NACGT", engine="fast"
            )
            assert seq == want_seq
            assert path == want_path

    def test_resume(self, tmp_path):
        from fast_ctc_decode_tpu.parallel.pipeline import decode_many_crf

        reads = self._reads([16] * 5, seed=9)
        ck = str(tmp_path / "crf.ckpt.jsonl")
        first = decode_many_crf(reads, "NACGT", checkpoint_path=ck)
        again = decode_many_crf(reads, "NACGT", checkpoint_path=ck)
        assert [tuple(r) for r in again] == [tuple(r) for r in first]


class TestHttpEndToEnd:
    def test_http_server_microbatch_roundtrip(self):
        import http.client
        import threading

        from fast_ctc_decode_tpu import serve

        # the server serve_http runs, on a free port, shut down cleanly
        # from the test
        serve.enable_microbatching(max_wait_ms=150.0)
        try:
            httpd = serve.make_http_server("127.0.0.1", 0)
            port = httpd.server_address[1]
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
            try:
                reads = [rand_read(20, 5, 200 + i) for i in range(4)]
                results = [None] * 4

                def post(i):
                    conn = http.client.HTTPConnection("127.0.0.1", port)
                    body = json.dumps({
                        "method": "beam_search",
                        "posteriors": reads[i].reshape(-1).tolist(),
                        "shape": [20, 5],
                        "alphabet": "NACGT",
                        "beam_size": 5,
                        "beam_cut_threshold": 0.1,
                    })
                    conn.request("POST", "/", body)
                    r = conn.getresponse()
                    results[i] = (r.status, json.loads(r.read()))
                    conn.close()

                threads = [
                    threading.Thread(target=post, args=(i,)) for i in range(4)
                ]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=120)
                for i, x in enumerate(reads):
                    status, out = results[i]
                    assert status == 200
                    seq, _ = beam_search(x, "NACGT", 5, 0.1)
                    assert out["seq"] == seq
            finally:
                httpd.shutdown()
        finally:
            serve.disable_microbatching()
