"""JSON decode service — this engine's analog of the reference's WASM/JS
binding layer (C2 in SURVEY.md §2).

The reference ships ``js_beam_search`` / ``js_viterbi_search``
(/root/reference/src/lib.rs:63-140): browser/Node callers pass a flattened
f32 posterior array + shape + params and get back the JSON string
``{"seq": ..., "starts": [...]}``.  A WASM build makes no sense for an
accelerator engine, so the non-Python binding surface is a wire protocol
instead: the same request/response schema over stdin/stdout or HTTP, with decodes
running on the accelerator.  Unlike the reference's weak error handling
(it returns the string "Error" and logs — src/lib.rs:78-88), failures are
typed: input errors (bad params/shape/JSON, search failures on the given
input) map to HTTP 400, server-side faults to 500, and the body is always
structured ``{"error": "..."}``.

Request schema:
    {
      "method": "beam_search" | "viterbi_search",
      "posteriors": [f32, ...],        # flattened row-major
      "shape": [T, A],                 # or [B, T, A] for a batch
      "lengths": [int, ...],           # optional, batch only
      "alphabet": ["N", "A", ...],
      "beam_size": 5,                  # beam_search only
      "beam_cut_threshold": 0.0,       # beam_search only
      "collapse_repeats": true,
      "qstring": false,                # viterbi_search only
      "qscale": 1.0, "qbias": 0.0      # viterbi_search only
    }
Response: {"seq": str, "starts": [int, ...]} — reference schema
(src/lib.rs:99, 137).  Batch requests (3-d shape) return
{"results": [{"seq": ..., "starts": ..., "err": 0}, ...]} and route
through the mesh-sharded batch pipeline, so one HTTP call amortizes the
device dispatch over B reads (per-read error codes; a bad read never
aborts the batch).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import api, errors


def _decode_single(req: Dict[str, Any], posteriors: np.ndarray) -> Dict[str, Any]:
    method = req.get("method", "beam_search")
    alphabet = req["alphabet"]
    if method == "beam_search":
        seq, starts = api.beam_search(
            posteriors,
            alphabet,
            int(req.get("beam_size", 5)),
            float(req.get("beam_cut_threshold", 0.0)),
            bool(req.get("collapse_repeats", True)),
        )
    elif method == "viterbi_search":
        seq, starts = api.viterbi_search(
            posteriors,
            alphabet,
            bool(req.get("qstring", False)),
            float(req.get("qscale", 1.0)),
            float(req.get("qbias", 0.0)),
            bool(req.get("collapse_repeats", True)),
        )
    else:
        raise ValueError(f"unknown method {method!r}")
    return {"seq": seq, "starts": list(starts)}


_DECODER_CACHE: Dict[Tuple, Any] = {}
_DECODER_CACHE_MAX = 16
_DECODER_LOCK = threading.Lock()


def _cache_get_or_make(key, factory):
    """FIFO-bounded compiled-decoder cache, safe against concurrent
    handler/micro-batcher threads: the caller keeps the returned decoder
    even if another thread evicts the entry immediately after."""
    with _DECODER_LOCK:
        dec = _DECODER_CACHE.get(key)
        if dec is None:
            dec = factory()
            if len(_DECODER_CACHE) >= _DECODER_CACHE_MAX:
                _DECODER_CACHE.pop(next(iter(_DECODER_CACHE)))
            _DECODER_CACHE[key] = dec
    return dec


def _decode_batch(req: Dict[str, Any], posteriors: np.ndarray) -> Dict[str, Any]:
    """[B, T, A] request through the batch pipeline (decoders cached per
    static config so repeated requests reuse the compiled kernel)."""
    from .parallel import pipeline

    method = req.get("method", "beam_search")
    B, T, _ = posteriors.shape
    alphabet = tuple(req["alphabet"])
    lengths = np.asarray(req.get("lengths", [T] * B), np.int32)
    if lengths.shape != (B,):
        raise ValueError("lengths must have one entry per read")
    if np.any(lengths < 0) or np.any(lengths > T):
        raise ValueError("lengths must be in [0, T]")

    # round T up to a power-of-two bucket edge so requests with naturally
    # varying read lengths share compiled decoders instead of compiling per
    # T (per-read ``lengths`` keep the decode exact on the padded frames)
    Tb = pipeline._bucket_edge_for(T)
    if Tb > T:
        posteriors = np.concatenate(
            [posteriors, np.zeros((B, Tb - T, posteriors.shape[2]), np.float32)],
            axis=1,
        )
        T = Tb

    # pad to a full device batch with length-0 dummy reads (decoded empty)
    from .parallel.mesh import make_data_mesh

    n_dev = len(make_data_mesh().devices.reshape(-1))
    pad = (-B) % n_dev
    if pad:
        posteriors = np.concatenate(
            [posteriors, np.zeros((pad, T, posteriors.shape[2]), np.float32)]
        )
        lengths = np.concatenate([lengths, np.zeros((pad,), np.int32)])

    if method == "beam_search":
        key = (
            "beam", alphabet, T,
            int(req.get("beam_size", 5)),
            float(req.get("beam_cut_threshold", 0.0)),
            bool(req.get("collapse_repeats", True)),
        )
        dec = _cache_get_or_make(key, lambda: pipeline.BatchBeamDecoder(
            list(alphabet), T=T, beam_size=key[3],
            beam_cut_threshold=key[4], collapse_repeats=key[5],
        ))
        res = dec.decode(posteriors, lengths)[:B]
        return {
            "results": [
                {"seq": s, "starts": p, "err": int(e)} for s, p, e in res
            ]
        }
    if method == "viterbi_search":
        key = (
            "viterbi", alphabet, T,
            bool(req.get("collapse_repeats", True)),
            float(req.get("qscale", 1.0)),
            float(req.get("qbias", 0.0)),
        )
        dec = _cache_get_or_make(key, lambda: pipeline.BatchViterbiDecoder(
            list(alphabet), T=T, collapse_repeats=key[3],
            qscale=key[4], qbias=key[5],
        ))
        res = dec.decode(
            posteriors, lengths, qstring=bool(req.get("qstring", False))
        )[:B]
        return {
            "results": [{"seq": s, "starts": p, "err": 0} for s, p in res]
        }
    raise ValueError(f"unknown method {method!r}")


class _MicroItem:
    __slots__ = ("key", "req", "post", "T", "event", "result", "error")

    def __init__(self, key, req, post, T):
        self.key = key
        self.req = req
        self.post = post
        self.T = T
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Coalesce concurrent single-read requests into one device batch.

    The reference binding decodes one read per call (src/lib.rs:63-140);
    on an accelerator that wastes the device — a single T=1000 read uses
    a sliver of it.  The micro-batcher holds each single-read (2-d shape)
    request for at most ``max_wait_ms``, stacks every compatible pending
    request (same method/alphabet/params and T bucket) into one [B, Tb, A]
    batch through the cached mesh decoders, then fans results back out.
    Per-read status codes keep one bad read from failing its batch-mates;
    malformed requests are rejected at submit time, before batching.

    Trade-off (opt-in, ``serve_http(..., microbatch=True)``): batched beam
    decodes run the throughput engines, whose ``path`` entries for
    pruned-and-re-derived prefixes may differ from the single-call exact
    engine (sequences are identical — see BatchBeamDecoder).
    """

    def __init__(self, max_batch: int = 256, max_wait_ms: float = 3.0):
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self._cv = threading.Condition()
        self._pending: List[_MicroItem] = []
        self._closed = False
        self.batches = 0  # device batches run (observability / tests)
        self.requests = 0
        self._thread = threading.Thread(
            target=self._worker, name="microbatcher", daemon=True
        )
        self._thread.start()

    # -- request -> group key (validates eagerly so a bad request fails
    #    alone with the API's own messages, never poisoning a batch)
    def _key_for(self, req: Dict[str, Any], post: np.ndarray):
        from .parallel import pipeline

        method = req.get("method", "beam_search")
        alphabet = tuple(api.normalize_alphabet(req["alphabet"]))
        if len(alphabet) != post.shape[1]:
            raise ValueError(
                f"alphabet size {len(alphabet)} does not match probability "
                f"matrix inner dimension {post.shape[1]}"
            )
        T = int(post.shape[0])
        if T == 0:
            raise ValueError("network_output must not be empty")
        Tb = pipeline._bucket_edge_for(T)
        if method == "beam_search":
            beam_size = int(req.get("beam_size", 5))
            thr = float(req.get("beam_cut_threshold", 0.0))
            api._check_beam_args(list(alphabet), beam_size, thr)
            return (
                "beam", alphabet, Tb, beam_size, thr,
                bool(req.get("collapse_repeats", True)),
            )
        if method == "viterbi_search":
            return (
                "viterbi", alphabet, Tb,
                bool(req.get("collapse_repeats", True)),
                float(req.get("qscale", 1.0)),
                float(req.get("qbias", 0.0)),
                bool(req.get("qstring", False)),
            )
        raise ValueError(f"unknown method {method!r}")

    def submit(self, req: Dict[str, Any], post: np.ndarray) -> Dict[str, Any]:
        """Block until this request's batch is decoded; returns the
        single-read response dict or re-raises its per-read failure."""
        key = self._key_for(req, post)
        item = _MicroItem(key, req, post, int(post.shape[0]))
        with self._cv:
            if self._closed:
                raise RuntimeError("micro-batcher is closed")
            self._pending.append(item)
            self.requests += 1
            self._cv.notify_all()
        item.event.wait()
        if item.error is not None:
            raise item.error
        assert item.result is not None
        return item.result

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join()

    def _worker(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                deadline = time.monotonic() + self.max_wait
                while len(self._pending) < self.max_batch and not self._closed:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                items, self._pending = self._pending, []
            groups: Dict[Tuple, List[_MicroItem]] = {}
            for it in items:
                groups.setdefault(it.key, []).append(it)
            for key, group in groups.items():
                try:
                    self._run_group(key, group)
                except BaseException as e:  # fan the fault out, keep serving
                    for it in group:
                        it.error = e
                        it.event.set()

    def _run_group(self, key: Tuple, group: List[_MicroItem]):
        from .parallel import pipeline
        from .parallel.mesh import make_data_mesh

        Tb = key[2]
        A1 = len(key[1])
        n_dev = len(make_data_mesh().devices.reshape(-1))
        B = len(group)
        Bp = B + ((-B) % n_dev)
        probs = np.zeros((Bp, Tb, A1), np.float32)
        lengths = np.zeros((Bp,), np.int32)
        for i, it in enumerate(group):
            probs[i, : it.T] = it.post
            lengths[i] = it.T

        if key[0] == "beam":
            dec = _cache_get_or_make(key, lambda: pipeline.BatchBeamDecoder(
                list(key[1]), T=Tb, beam_size=key[3],
                beam_cut_threshold=key[4], collapse_repeats=key[5],
            ))
        else:
            # decoder key drops qstring (key[6]) — it is a decode-time
            # argument, not part of the compiled shape
            dec = _cache_get_or_make(
                key[:6], lambda: pipeline.BatchViterbiDecoder(
                    list(key[1]), T=Tb, collapse_repeats=key[3],
                    qscale=key[4], qbias=key[5],
                )
            )
        self.batches += 1
        if key[0] == "beam":
            res = dec.decode(probs, lengths)[:B]
            for it, (seq, starts, err) in zip(group, res):
                if err != errors.OK:
                    it.error = errors.SearchError(err)
                else:
                    it.result = {"seq": seq, "starts": list(starts)}
                it.event.set()
        else:
            res = dec.decode(probs, lengths, qstring=key[6])[:B]
            for it, (seq, starts) in zip(group, res):
                it.result = {"seq": seq, "starts": list(starts)}
                it.event.set()


_MICRO: Optional[MicroBatcher] = None


def enable_microbatching(max_batch: int = 256, max_wait_ms: float = 3.0):
    """Route single-read requests through a shared MicroBatcher."""
    global _MICRO
    if _MICRO is None:
        _MICRO = MicroBatcher(max_batch=max_batch, max_wait_ms=max_wait_ms)
    return _MICRO


def disable_microbatching():
    global _MICRO
    if _MICRO is not None:
        _MICRO.close()
        _MICRO = None


def decode_request(req: Dict[str, Any]) -> Dict[str, Any]:
    """Execute one decode request dict; returns the response dict.

    Raises ValueError/TypeError/KeyError/SearchError exactly like the Python
    API — callers map these to protocol errors.
    """
    shape = req["shape"]
    posteriors = np.asarray(req["posteriors"], np.float32)
    if len(shape) == 2:
        if _MICRO is not None and req.get("method", "beam_search") in (
            "beam_search", "viterbi_search",
        ):
            return _MICRO.submit(req, posteriors.reshape(shape))
        return _decode_single(req, posteriors.reshape(shape))
    if len(shape) == 3:
        return _decode_batch(req, posteriors.reshape(shape))
    raise ValueError("shape must be [T, A] or [B, T, A]")


def handle_json(request_json: str) -> Tuple[str, int]:
    """String-in entry point: returns (response_json, http_status).

    Input-derived failures (malformed JSON/params, search errors on the
    given posteriors) are 400; anything unexpected is a 500.
    """
    try:
        req = json.loads(request_json)
        return json.dumps(decode_request(req)), 200
    except (
        ValueError,  # includes json.JSONDecodeError and API validation
        TypeError,
        KeyError,
        errors.SearchError,  # RuntimeError subclass: input-induced
    ) as e:
        return json.dumps({"error": f"{type(e).__name__}: {e}"}), 400
    except Exception as e:  # pragma: no cover - server-side fault
        return json.dumps({"error": f"{type(e).__name__}: {e}"}), 500


def decode_json(request_json: str) -> str:
    """String-in/string-out entry point (the js_beam_search analog)."""
    return handle_json(request_json)[0]


def make_http_server(
    host: str = "127.0.0.1", port: int = 8000, microbatch: bool = False
):
    """Threaded stdlib HTTP server: POST / with a request JSON body.
    Returns the unstarted server (``port=0`` picks a free port); call its
    ``serve_forever`` and, to stop, ``shutdown``.

    Threads overlap host-side JSON/detok work across requests; device
    decodes serialize on the JAX dispatch lock, so throughput-minded
    clients should send batch (3-d shape) requests — or pass
    ``microbatch=True`` (CLI ``--microbatch``) to coalesce concurrent
    single-read requests into shared device batches (see MicroBatcher).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if microbatch:
        enable_microbatching()

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length).decode("utf-8")
            out, code = handle_json(body)
            data = out.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):  # quiet
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(host: str = "127.0.0.1", port: int = 8000, microbatch: bool = False):
    """Run ``make_http_server`` until interrupted."""
    httpd = make_http_server(host, port, microbatch)
    print(f"fast_ctc_decode_tpu serving on http://{host}:{httpd.server_address[1]}")
    httpd.serve_forever()


def main():
    """CLI: one JSON request per stdin line -> one JSON response per line,
    or --http [host:port] for the HTTP server."""
    import sys

    from .device import use_compile_cache

    use_compile_cache()
    args = sys.argv[1:]
    microbatch = "--microbatch" in args
    args = [a for a in args if a != "--microbatch"]
    if args and args[0] == "--http":
        hp = args[1] if len(args) > 1 else "127.0.0.1:8000"
        host, _, port = hp.partition(":")
        serve_http(host, int(port or 8000), microbatch=microbatch)
        return
    if microbatch:
        # honored in stdin mode too (coalescing only helps when multiple
        # producers share the process, but the flag must not be a no-op)
        enable_microbatching()
    for line in sys.stdin:
        line = line.strip()
        if line:
            print(decode_json(line), flush=True)


if __name__ == "__main__":
    main()
