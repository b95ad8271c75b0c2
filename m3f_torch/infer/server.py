"""Minimal HTTP serving frontend over :class:`Predictor`.

Counterpart of ``m3f/pytorch_tpu/infer/server.py``: one process owns the
model on the card and answers per-video and live-stream requests over
HTTP. Stdlib-only and single-model: one Predictor, its input shapes run
once at startup (``run_server`` calls ``Predictor.warmup`` and
``SessionGroup.warmup``), every forward serialized through one lock (the
card is one queue; concurrency belongs to SessionGroup's batches, not to
the HTTP threads, which only overlap parsing and serialization with it).

Protocol (binary-first: videos are big, JSON base64 would triple them):

    POST /predict   body = .npz with optional arrays:
                      frames   uint8 [N, S, S, 3]  (S = data.image_size)
                      waveform float32/float64 [T] (16 kHz mono)
                    query: ?smooth=K  (odd moving-average window, optional)
                           ?fps=R    (the video's true frame rate when it
                                      differs from the configured default;
                                      also accepted on /stream/open)
                    response: application/json {"pred": [[v, a], ...]}
                    (or x-npy raw float32 [N,2] with Accept: application/x-npy)
    GET  /healthz   {"ok": true, "model": ..., "image_size": ..., ...}

    Live streams (bounded-latency online inference; concurrent sessions'
    ready window groups run as one batched forward through SessionGroup):

    POST /stream/open          -> {"id": "...", "latency_frames": n}
    POST /stream/<id>/push     body = .npz chunk (frames/waveform)
                               -> {"start": i, "pred": [[v, a], ...]}
                                  (frames finalized by this chunk; the
                                  emission lags `latency_frames` behind)
    POST /stream/<id>/flush    -> same shape; closes the session
    GET  /statz                -> serving counters: per-route request and
                                  response-class counts, bytes in, p50/p99
                                  latency, micro-batch size histogram,
                                  active and evicted stream counts
    POST /reload               body = {"checkpoint": "<server-side path>"}
                               -> {"ok": true, "step": N, "reloads": k}
                               Weight swap (same config and shapes). An
                               operator endpoint: enabled only with
                               ``allow_reload`` (403 otherwise); a failure
                               leaves the old weights serving.

    Sessions idle longer than ``stream_ttl_s`` (default 300 s) are evicted:
    their slot is reclaimed and later touches answer 410 Gone (an id that
    never existed answers 404).

    Memory bound: each accepted request body is buffered in full by its
    HTTP thread, so worst-case request RAM is ``max_body`` x concurrent
    uploads. The default ``max_body`` is 256 MiB (about 4.4 min of raw 112
    px 25 fps video in one /predict; longer videos and live capture go
    through chunked /stream pushes). An oversized Content-Length is refused
    413 before any body byte is read, and the connection is closed (the
    unread body must not be parsed as the next keep-alive request).

Example client:

    buf = io.BytesIO(); np.savez(buf, frames=crops, waveform=wav)
    r = urllib.request.urlopen("http://HOST:PORT/predict", buf.getvalue())
    pred = np.asarray(json.load(r)["pred"])
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from m3f_torch.infer.predictor import SessionGroup


class _StreamStuckError(RuntimeError):
    """A push's batch never completed within 2x the timeout: whether the
    chunk was applied is unknowable, so the session is closed (500) instead
    of risking a silent double-append on a client retry."""


class _Stats:
    """Serving counters, thread-safe; a snapshot is served on GET /statz.
    Latency is a bounded reservoir of the most recent samples per route:
    p50/p99 over the live window, not all-time."""

    def __init__(self, reservoir: int = 2048):
        self._lock = threading.Lock()
        self.requests = {}          # route -> count
        self.responses = {}         # (route, status_class) -> count, e.g. "4xx"
        self.batch_hist = {}        # micro-batch size -> count
        self.bytes_in = {}          # route -> body bytes actually buffered
        self.rejected_bytes = 0     # Content-Length refused before any read
        self.evicted_streams = 0
        self._lat = {}              # route -> deque of seconds
        self._reservoir = reservoir

    def record(self, route: str, code: int, dt_s: float) -> None:
        cls = f"{code // 100}xx"
        with self._lock:
            self.requests[route] = self.requests.get(route, 0) + 1
            self.responses[(route, cls)] = \
                self.responses.get((route, cls), 0) + 1
            self._lat.setdefault(
                route, deque(maxlen=self._reservoir)).append(dt_s)

    def record_bytes(self, route: str, n: int) -> None:
        """Body bytes BUFFERED for a route (upload pressure: worst-case
        request RAM is max_body x concurrent uploads — see module doc)."""
        with self._lock:
            self.bytes_in[route] = self.bytes_in.get(route, 0) + n

    def record_rejected_bytes(self, n: int) -> None:
        """Content-Length refused by the 413 gate before any read — what
        the max_body bound is actually deflecting."""
        with self._lock:
            self.rejected_bytes += n

    def record_batch(self, k: int) -> None:
        with self._lock:
            self.batch_hist[k] = self.batch_hist.get(k, 0) + 1

    def record_evicted(self, n: int = 1) -> None:
        with self._lock:
            self.evicted_streams += n

    def snapshot(self, active_streams: int) -> dict:
        with self._lock:
            lat = {}
            for route, q in self._lat.items():
                if not q:
                    continue
                xs = np.sort(np.asarray(q))
                lat[route] = {
                    "n": len(xs),
                    "p50_ms": round(float(np.percentile(xs, 50)) * 1e3, 3),
                    "p99_ms": round(float(np.percentile(xs, 99)) * 1e3, 3),
                    "max_ms": round(float(xs[-1]) * 1e3, 3),
                }
            return {
                "requests": dict(self.requests),
                "responses": {f"{r}:{c}": n
                              for (r, c), n in self.responses.items()},
                "bytes_in": dict(self.bytes_in),
                "rejected_bytes": self.rejected_bytes,
                "latency": lat,
                "micro_batch_hist": {str(k): v for k, v in
                                     sorted(self.batch_hist.items())},
                "active_streams": active_streams,
                "evicted_streams": self.evicted_streams,
            }


class PredictServer:
    # 256 MiB: ~4.4 min of raw 112 px 25 fps uint8 video in one /predict.
    # Worst-case request RAM = max_body x concurrent uploads (bodies buffer
    # per HTTP thread)
    DEFAULT_MAX_BODY = 256 << 20

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 8321,
                 max_body: int = DEFAULT_MAX_BODY, max_streams: int = 64,
                 stream_ttl_s: float = 300.0, push_timeout_s: float = 30.0,
                 allow_reload: bool = False):
        self.predictor = predictor
        # one device queue -> one request at a time through the model; HTTP
        # threads only overlap parsing/serialization with device compute.
        # Predictor.reload takes this lock for its swap, so a request or a
        # push_many tick runs on one set of weights
        self._lock = threading.Lock()
        self._group = SessionGroup(predictor)
        self._streams = {}          # id -> StreamingSession
        self._touched = {}          # id -> monotonic time of last activity
        self._evicted = deque(maxlen=1024)   # recently evicted ids -> 410
        self._next_id = 0
        self.max_streams = max_streams
        # a client that opens a stream and disappears must not hold its slot
        # forever: sessions idle past the TTL are evicted lazily (on open and
        # on any stream touch) and answer 410 Gone afterwards, distinct from
        # never-existed 404s
        self.stream_ttl_s = stream_ttl_s
        self.push_timeout_s = push_timeout_s
        # POST /reload swaps weights from a checkpoint path in the request
        # body: an operator endpoint (it reads server-side files), off
        # unless the server was started with allow_reload (403 otherwise)
        self.allow_reload = allow_reload
        self.max_body = max_body
        self.stats = _Stats()
        # micro-batching of concurrent /push requests: the first arrival
        # becomes the leader, sleeps batch_window_s so concurrent sessions'
        # chunks pile up, then runs one SessionGroup.push_many for all of
        # them
        self.batch_window_s = 0.003
        self._pending = []          # (session, data, event, slot)
        self._pending_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            _route = "other"        # set per-request; keys the stats rows
            _t0 = 0.0

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json"):
                outer.stats.record(self._route, code,
                                   time.monotonic() - self._t0)
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _fail(self, code: int, msg: str):
                self._send(code, json.dumps({"error": msg}).encode())

            def _reject_oversize(self, n: int) -> None:
                """413 BEFORE reading a single body byte. The unread body
                would be parsed as the next request on this keep-alive
                connection, so it must be closed — that (not draining
                max_body bytes) is what keeps the RAM bound real."""
                outer.stats.record_rejected_bytes(n)
                self.close_connection = True
                self._fail(413, f"body too large ({n} > max_body="
                                f"{max_body})")

            def do_GET(self):
                self._t0 = time.monotonic()
                path = self.path.rstrip("/")
                if path in ("", "/healthz"):
                    self._route = "healthz"
                    cfg = outer.predictor.cfg
                    self._send(200, json.dumps({
                        "ok": True, "model": cfg.name,
                        "uses_video": cfg.model.use_video,
                        "uses_audio": cfg.model.use_audio,
                        "image_size": cfg.data.image_size,
                        "sample_rate": cfg.model.mel.sample_rate,
                        "fps": cfg.data.fps,
                        "checkpoint": outer.predictor.checkpoint_path,
                        "reloads": outer.predictor.reload_count,
                    }).encode())
                elif path == "/statz":
                    self._route = "statz"
                    outer._evict_idle()
                    self._send(200, json.dumps(outer.stats.snapshot(
                        active_streams=len(outer._streams))).encode())
                else:
                    self._fail(404, f"unknown path {self.path}")

            def _content_length(self):
                """Content-Length as int, or None after a JSON 400: a raw
                client sending a non-numeric header gets an HTTP error, not
                a dropped connection."""
                raw = self.headers.get("Content-Length", 0)
                try:
                    return int(raw)
                except (TypeError, ValueError):
                    # unread body: close, or it desyncs the keep-alive stream
                    self.close_connection = True
                    self._fail(400, f"bad Content-Length {raw!r}")
                    return None

            def _read_npz(self):
                # header sanity (bad/oversize Content-Length) already ran
                # in do_POST before routing; this route additionally needs
                # a body — rfile.read(-1) on a non-positive length would
                # block until the CLIENT closes a keep-alive connection,
                # pinning this handler thread (and a negative n would
                # corrupt the bytes_in counter)
                n = self._n_body
                if n <= 0:
                    self.close_connection = True
                    self._fail(400, f"bad Content-Length {n}")
                    return None
                outer.stats.record_bytes(self._route, n)
                raw = self.rfile.read(n)
                try:
                    with np.load(io.BytesIO(raw)) as z:
                        return {k: (z[k].astype(np.float32)
                                    if k == "waveform" else z[k])
                                for k in z.files}
                except Exception as e:  # noqa: BLE001 — client error
                    self._fail(400, f"body is not a readable npz: {e}")
                    return None

            def _stream_routes(self, path: str) -> bool:
                parts = path.strip("/").split("/")
                if parts[0] != "stream":
                    return False
                if parts[1:] == ["open"]:
                    self._route = "stream/open"
                    if self._n_body > 0:
                        # /open takes no body; the unread bytes would be
                        # parsed as the next keep-alive request
                        self.close_connection = True
                    q = parse_qs(urlparse(self.path).query)
                    fps = q.get("fps", [None])[0]   # capture's true rate
                    with outer._pending_lock:
                        outer._evict_idle_locked()
                        if len(outer._streams) >= outer.max_streams:
                            self._fail(429, "too many open streams")
                            return True
                        sid = f"s{outer._next_id}"
                        outer._next_id += 1
                        try:
                            outer._streams[sid] = outer._group.open(fps=fps)
                        except ValueError as e:  # e.g. eval_smooth, bad fps
                            self._fail(400, str(e))
                            return True
                        outer._touched[sid] = time.monotonic()
                    self._send(200, json.dumps({
                        "id": sid,
                        "latency_frames": outer._streams[sid].latency_frames,
                    }).encode())
                    return True
                if len(parts) == 3 and parts[2] in ("push", "flush"):
                    self._route = f"stream/{parts[2]}"
                    if parts[2] == "flush" and self._n_body > 0:
                        self.close_connection = True   # body never read
                    sid = parts[1]
                    # evict on every touch, not just /open: a client
                    # returning after the TTL always sees 410, whether or
                    # not anyone needed the slot meanwhile
                    outer._evict_idle()
                    sess = outer._streams.get(sid)
                    if sess is None:
                        if sid in outer._evicted:
                            self._fail(410, f"stream {sid} was evicted "
                                       f"after {outer.stream_ttl_s}s idle")
                        else:
                            self._fail(404, f"unknown stream {sid}")
                        return True
                    outer._touch(sid)
                    if parts[2] == "push":
                        data = self._read_npz()
                        if data is None:
                            return True
                        try:
                            lo, pred = outer._stream_push(sess, data)
                        except ValueError as e:
                            self._fail(400, str(e))
                            return True
                        except TimeoutError as e:
                            self._fail(503, str(e))
                            return True
                        except _StreamStuckError as e:
                            outer._drop_stream(sid)
                            self._fail(500, str(e))
                            return True
                        except Exception as e:  # noqa: BLE001 — surface as
                            # a JSON 500, never a dropped connection
                            self._fail(500, f"{type(e).__name__}: {e}")
                            return True
                        outer._touch(sid)
                    else:
                        try:
                            with outer._lock:
                                lo, pred = sess.flush()
                        except ValueError as e:
                            # a failed flush means the session is dead
                            # either way: don't leak its slot
                            outer._drop_stream(sid)
                            self._fail(400, str(e))
                            return True
                        except Exception as e:  # noqa: BLE001
                            outer._drop_stream(sid)
                            self._fail(500, f"{type(e).__name__}: {e}")
                            return True
                        outer._drop_stream(sid)
                    self._send(200, json.dumps({
                        "start": int(lo),
                        "pred": np.asarray(pred, np.float32).tolist(),
                    }).encode())
                    return True
                self._fail(404, f"unknown path /{path.strip('/')}")
                return True

            def _reload_route(self):
                """POST /reload {"checkpoint": path}: weight swap.

                The read, checks and upload run outside the device lock;
                the swap into the module takes it, so it lands between
                batched forwards and a request is answered by one set of
                weights. Failures leave the old weights serving.
                """
                self._route = "reload"
                if not outer.allow_reload:
                    return self._fail(
                        403, "reload disabled: start the server with "
                             "allow_reload=True to enable POST /reload")
                n = self._n_body   # header sanity already ran in do_POST
                if not 0 < n <= 1 << 20:
                    self.close_connection = True   # body stays unread
                    return self._fail(400, f"bad Content-Length {n}")
                outer.stats.record_bytes(self._route, n)
                try:
                    body = json.loads(self.rfile.read(n))
                    path = body["checkpoint"]
                except (ValueError, KeyError, TypeError):
                    return self._fail(
                        400, 'body must be JSON {"checkpoint": "<path>"}')
                if not isinstance(path, str):
                    # a client error must be a 400, not a 500 from deep
                    # inside the loader
                    return self._fail(
                        400, 'body must be JSON {"checkpoint": "<path>"}')
                try:
                    # the checkpoint read and upload run without the
                    # device lock (serving goes on with the old weights);
                    # only the swap takes outer._lock
                    info = outer.predictor.reload(path, lock=outer._lock)
                except FileNotFoundError:
                    return self._fail(400, f"no such checkpoint: {path}")
                except ValueError as e:        # architecture mismatch etc.
                    return self._fail(400, str(e))
                except Exception as e:  # noqa: BLE001 — JSON 500, never a
                    # dropped connection; the old weights keep serving
                    return self._fail(500, f"{type(e).__name__}: {e}")
                self._send(200, json.dumps({"ok": True, **info}).encode())

            def do_POST(self):
                self._t0 = time.monotonic()
                # header sanity gates EVERY POST route BEFORE it acts: an
                # oversize body is 413'd before a single byte is buffered
                # (the RAM bound is max_body × concurrent uploads), on any
                # route — /predict, /stream/*, /reload alike
                n = self._content_length()
                if n is None:
                    return
                if n > max_body:
                    return self._reject_oversize(n)
                self._n_body = n
                url = urlparse(self.path)
                if self._stream_routes(url.path):
                    return
                if url.path.rstrip("/") == "/reload":
                    return self._reload_route()
                if url.path.rstrip("/") != "/predict":
                    return self._fail(404, f"unknown path {url.path}")
                self._route = "predict"
                if n <= 0:
                    self.close_connection = True
                    return self._fail(400, f"bad Content-Length {n}")
                outer.stats.record_bytes(self._route, n)
                raw = self.rfile.read(n)
                try:
                    with np.load(io.BytesIO(raw)) as z:
                        frames = z["frames"] if "frames" in z.files else None
                        wav = (z["waveform"].astype(np.float32)
                               if "waveform" in z.files else None)
                except Exception as e:  # noqa: BLE001 — client error, report
                    return self._fail(400, f"body is not a readable npz: {e}")
                q = parse_qs(url.query)
                try:
                    smooth = int(q.get("smooth", ["0"])[0])
                except ValueError:
                    # client error → JSON 400, never an uncaught exception
                    # that drops the connection
                    return self._fail(400, "smooth must be an integer, got "
                                      f"{q['smooth'][0]!r}")
                fps = q.get("fps", [None])[0]       # video's true rate
                try:
                    with outer._lock:
                        out = outer.predictor.predict_video(
                            frames=frames, waveform=wav,
                            smooth_window=smooth, fps=fps)
                except ValueError as e:
                    return self._fail(400, str(e))
                except Exception as e:  # noqa: BLE001 — JSON 500, not a
                    # dropped connection
                    return self._fail(500, f"{type(e).__name__}: {e}")
                pred = np.asarray(out["pred"], np.float32)
                if "application/x-npy" in self.headers.get("Accept", ""):
                    buf = io.BytesIO()
                    np.save(buf, pred)
                    return self._send(200, buf.getvalue(),
                                      "application/x-npy")
                self._send(200, json.dumps(
                    {"pred": pred.tolist()}).encode())

        self._httpd = ThreadingHTTPServer((host, port), Handler)

    # -- stream lifecycle ---------------------------------------------------

    def _drop_stream_locked(self, sid: str) -> None:
        self._streams.pop(sid, None)
        self._touched.pop(sid, None)

    def _drop_stream(self, sid: str) -> None:
        with self._pending_lock:
            self._drop_stream_locked(sid)

    def _touch(self, sid: str) -> None:
        """Refresh a stream's idle clock, only while it still exists.

        An unconditional ``_touched[sid] = now`` races _drop_stream (a flush
        or an eviction landing between the route's existence check and the
        touch): it would recreate an orphan entry that a later sweep counts
        and 410-labels as evicted though the stream was flushed. Guarded by
        _pending_lock, which every eviction and drop holds.
        """
        with self._pending_lock:
            if sid in self._streams:
                self._touched[sid] = time.monotonic()

    def _evict_idle_locked(self) -> None:
        """Evict streams idle past the TTL (call with _pending_lock held)."""
        if self.stream_ttl_s <= 0:
            return
        now = time.monotonic()
        # snapshot: push/flush routes update _touched entries outside this
        # lock (atomic assignments), and a re-touch racing an eviction may
        # INSERT — iterating the live dict could raise dict-changed-size
        stale = [sid for sid, t in list(self._touched.items())
                 if now - t > self.stream_ttl_s]
        for sid in stale:
            self._drop_stream_locked(sid)
            self._evicted.append(sid)
        if stale:
            self.stats.record_evicted(len(stale))

    def _evict_idle(self) -> None:
        with self._pending_lock:
            self._evict_idle_locked()

    # -- streaming micro-batcher ------------------------------------------

    def _stream_push(self, sess, data):
        """Batch this push with whatever else arrives inside the window.

        Two pushes for the SAME session in one window can't share one
        push_many dict — the later one is deferred to the next round, which
        also serializes a client that (against the contract) pipelines
        pushes for one stream.
        """
        ev = threading.Event()
        slot = {}
        with self._pending_lock:
            self._pending.append((sess, data, ev, slot))
            leader = len(self._pending) == 1
        while leader:
            time.sleep(self.batch_window_s)
            with self._pending_lock:
                batch, dup = [], []
                seen = set()
                for item in self._pending:
                    (dup if id(item[0]) in seen else batch).append(item)
                    seen.add(id(item[0]))
                self._pending = dup
            live = batch
            try:
                if live:
                    self.stats.record_batch(len(live))
                    errs = {}
                    with self._lock:
                        # per-session isolation happens inside push_many
                        # (a flush racing this window, a wrong-modality
                        # body, a bad shape: each fails only its own
                        # session)
                        outs = self._group.push_many(
                            {s: d for s, d, _, _ in live}, errors=errs)
                    for s, _, e, sl in live:
                        if s in errs:
                            sl["err"] = errs[s]
                        else:
                            sl["out"] = outs[s]
                        e.set()
            except BaseException as exc:
                for _, _, e, sl in live:
                    if "out" not in sl:    # never mask a delivered result
                        sl.setdefault("err", exc)
                    e.set()
            with self._pending_lock:
                # keep leading until the queue is EMPTY (deferred same-
                # session duplicates have no other leader; new arrivals only
                # self-elect when they find an empty queue)
                leader = bool(self._pending)
        if not ev.wait(timeout=self.push_timeout_s):
            # timing out must not leave the item queued: the leader would
            # still apply it later, with nobody to receive its predictions,
            # and a client retry (503 is retryable) would append the chunk
            # twice and desync the stream for good
            with self._pending_lock:
                still_queued = any(item[2] is ev for item in self._pending)
                if still_queued:
                    self._pending = [item for item in self._pending
                                     if item[2] is not ev]
            if still_queued:
                # safely cancelled — never touched the session; retryable
                raise TimeoutError(
                    f"stream push timed out after {self.push_timeout_s}s "
                    "behind the batcher (not applied; safe to retry)")
            # the leader already took it: the result (or error) is coming —
            # give the in-flight batch one more full window
            if not ev.wait(timeout=self.push_timeout_s):
                # mid-batch and still nothing: whether the chunk was applied
                # is unknowable here, so the session must die rather than
                # risk a double-append on retry (handler drops it → 500)
                raise _StreamStuckError(
                    f"stream push still in flight after "
                    f"{2 * self.push_timeout_s}s; closing the stream — "
                    "its window alignment can no longer be trusted")
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def serve_forever(self):
        self._httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def run_server(predictor, host: str = "127.0.0.1", port: int = 8321,
               warmup_frames: Optional[int] = 1024, log=print,
               max_streams: int = 64, stream_ttl_s: float = 300.0,
               push_timeout_s: float = 30.0, warmup_rates=(),
               allow_reload: bool = False,
               max_body: int = PredictServer.DEFAULT_MAX_BODY):
    """Serve ``predictor`` until SIGINT: first run every input shape a
    request up to ``warmup_frames`` frames (and the ``warmup_rates``) can
    bring, and every micro-batch bucket, so no live request builds a
    kernel or meets a new shape."""
    if warmup_frames:
        log(f"warming shape buckets up to {warmup_frames} frames "
            + (f"(+ rates {list(warmup_rates)}) " if warmup_rates else "")
            + "...")
        predictor.warmup(max_frames=warmup_frames,
                         rates=tuple(warmup_rates))
    srv = PredictServer(predictor, host=host, port=port,
                        max_streams=max_streams, stream_ttl_s=stream_ttl_s,
                        push_timeout_s=push_timeout_s,
                        allow_reload=allow_reload, max_body=max_body)
    if warmup_frames:
        # the micro-batcher's power-of-two [b, W, ...] batches, fixed-hop
        # and (rates) dynamic-hop: a cold one would be set up while the
        # batch leader holds the device, stalling every waiting stream
        log("warming micro-batch buckets ...")
        srv._group.warmup(rates=tuple(warmup_rates))
    log(f"serving {predictor.cfg.name} on http://{host}:{srv.port} "
        "(POST /predict, GET /healthz, GET /statz)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        log("shutting down")
        srv.shutdown()
    return 0
