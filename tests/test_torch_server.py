"""The port's HTTP serving frontend (m3f_torch/infer/server.py): the
counterpart of ``tests/test_server.py`` on a port ``PredictServer`` on an
OS-assigned port. Answers are held against the in-process port Predictor
and against the JAX Predictor on the same JAX checkpoint; small fp32
models, inputs numpy from a seed."""

import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import urlparse

import numpy as np
import pytest
import torch
import jax

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.infer import Predictor as JPredictor
from m3f.pytorch_tpu.train.checkpoint import Checkpointer
from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
from m3f_torch.infer import Predictor, PredictServer
from m3f_torch.infer import predictor as pred_mod
from m3f_torch.infer.server import _StreamStuckError, run_server

from test_torch_streaming import _video, tiny

TOL = 2e-5          # fp32: the port against JAX, and two port paths


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _checkpoint(d, use_video, seed=0):
    cfg = tiny(jc, use_video=use_video)
    state = JTrainer(cfg).init_state(seed)
    return cfg, Checkpointer(str(d), keep=1, cfg=cfg).save(
        jax.device_get(state))


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """(JAX Predictor, port Predictor, base url) of an audio-only model."""
    cfg, path = _checkpoint(tmp_path_factory.mktemp("audio"), False)
    p = Predictor(cfg=tiny(tc, use_video=False), checkpoint=path, device="cpu")
    srv = PredictServer(p, port=0)
    srv.start_background()
    yield JPredictor(cfg=cfg, checkpoint=path), p, \
        f"http://127.0.0.1:{srv.port}"
    srv.shutdown()


@pytest.fixture(scope="module")
def video_server(tmp_path_factory):
    """The same for the fusion model (frames and audio)."""
    cfg, path = _checkpoint(tmp_path_factory.mktemp("fusion"), True)
    p = Predictor(cfg=tiny(tc), checkpoint=path, device="cpu")
    srv = PredictServer(p, port=0)
    srv.start_background()
    yield JPredictor(cfg=cfg, checkpoint=path), p, \
        f"http://127.0.0.1:{srv.port}"
    srv.shutdown()


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, headers=headers or {})
    return urllib.request.urlopen(req, timeout=120)


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.load(r)


def _raw(base, head):
    """Send raw HTTP and read until the server closes the connection."""
    u = urlparse(base)
    t0 = time.monotonic()
    with socket.create_connection((u.hostname, u.port), timeout=30) as s:
        s.sendall(head)
        resp = b""
        while True:
            d = s.recv(4096)
            if not d:
                break
            resp += d
    return resp.decode(), time.monotonic() - t0


def _stream_over_http(base, frames, wav, fps, chunk=8, query=""):
    """Open, push ``chunk`` frames (and their audio) at a time, push the
    audio's tail, flush; the emission, checked contiguous."""
    with _post(f"{base}/stream/open{query}", b"") as r:
        o = json.load(r)
    assert o["latency_frames"] > 0
    sid, got, sr = o["id"], [], 16000
    n = len(frames) if frames is not None else int(len(wav) / sr * fps)
    ai = 0
    for i in range(0, n, chunk):
        a = int(round((i + chunk) / fps * sr))
        arrs = {"waveform": wav[ai:a]}
        if frames is not None:
            arrs["frames"] = frames[i:i + chunk]
        with _post(f"{base}/stream/{sid}/push", _npz(**arrs)) as r:
            out = json.load(r)
        assert out["start"] == sum(len(g) for g in got)
        got.append(np.asarray(out["pred"], np.float32).reshape(-1, 2))
        ai = a
    if ai < len(wav):
        with _post(f"{base}/stream/{sid}/push", _npz(waveform=wav[ai:])) as r:
            got.append(np.asarray(json.load(r)["pred"],
                                  np.float32).reshape(-1, 2))
    with _post(f"{base}/stream/{sid}/flush", b"") as r:
        got.append(np.asarray(json.load(r)["pred"], np.float32).reshape(-1, 2))
    return sid, np.concatenate(got)


def test_healthz(server):
    _, _, base = server
    h = _get(base + "/healthz")
    assert h["ok"] and h["uses_audio"] and not h["uses_video"]
    assert h["sample_rate"] == 16_000 and h["reloads"] == 0


@pytest.mark.parametrize("fps", [None, 25.0], ids=["nominal", "off_rate"])
def test_predict_matches_inprocess_and_jax(video_server, fps):
    """/predict (JSON and x-npy, ?fps, ?smooth) equals the in-process port
    Predictor bit for bit and the JAX Predictor within fp32 order."""
    jp, p, base = video_server
    frames, wav = _video(30, fps or 30.0, seed=4)
    q = f"?fps={fps:g}" if fps else ""
    want = p.predict_video(frames=frames, waveform=wav, fps=fps)["pred"]
    body = _npz(frames=frames, waveform=wav)
    with _post(base + "/predict" + q, body) as r:
        pred = np.asarray(json.load(r)["pred"], np.float32)
    np.testing.assert_array_equal(pred, want)
    np.testing.assert_allclose(
        pred, jp.predict_video(frames=frames, waveform=wav, fps=fps)["pred"],
        rtol=TOL, atol=TOL)
    with _post(base + "/predict" + q, body,
               {"Accept": "application/x-npy"}) as r:
        assert r.headers["Content-Type"] == "application/x-npy"
        np.testing.assert_array_equal(np.load(io.BytesIO(r.read())), want)
    amp = "&" if q else "?"
    with _post(base + "/predict" + q + amp + "smooth=5", body) as r:
        pred_s = np.asarray(json.load(r)["pred"], np.float32)
    np.testing.assert_array_equal(pred_s, p.predict_video(
        frames=frames, waveform=wav, fps=fps, smooth_window=5)["pred"])


@pytest.mark.parametrize("fps", [None, 25.0], ids=["nominal", "off_rate"])
def test_stream_routes_match_offline(video_server, fps):
    """/stream/open (?fps), /push and /flush equal the port's and the JAX
    package's whole-video predictions; the flushed id is gone (404)."""
    jp, p, base = video_server
    frames, wav = _video(40, fps or 30.0, seed=11)
    sid, pred = _stream_over_http(base, frames, wav, fps or 30.0,
                                  query=f"?fps={fps:g}" if fps else "")
    assert pred.shape == (40, 2)
    np.testing.assert_allclose(pred, p.predict_video(
        frames=frames, waveform=wav, fps=fps)["pred"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pred, jp.predict_video(
        frames=frames, waveform=wav, fps=fps)["pred"], rtol=TOL, atol=TOL)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/stream/{sid}/push", _npz(waveform=wav[:100]))
    assert e.value.code == 404


def test_concurrent_streams_micro_batch(server):
    """Three streams pushing at once through a server whose batch window
    is long enough to gather them: /statz shows a micro-batch of more than
    one push, and each stream still equals offline."""
    _, p, _ = server
    srv = PredictServer(p, port=0)
    srv.batch_window_s = 0.2
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        wavs = [_video(24 + 6 * i, 30.0, seed=20 + i, use_video=False)[1]
                for i in range(3)]
        want = [p.predict_video(waveform=w)["pred"] for w in wavs]
        results, errs = [None] * 3, []
        start = threading.Barrier(3)

        def run(i):
            try:
                start.wait(timeout=30)
                results[i] = _stream_over_http(base, None, wavs[i], 30.0)[1]
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append((i, e))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert not errs, errs
        for i in range(3):
            np.testing.assert_allclose(results[i], want[i], rtol=TOL, atol=TOL)
        s = _get(base + "/statz")
        assert max(int(k) for k in s["micro_batch_hist"]) > 1, s
        assert s["requests"]["stream/push"] >= 6
        assert s["latency"]["stream/push"]["p99_ms"] >= \
            s["latency"]["stream/push"]["p50_ms"] > 0
        assert s["active_streams"] == 0
    finally:
        srv.shutdown()


def test_client_errors_are_400s(video_server):
    """Garbage bodies, wrong dtype / shape, a missing modality, bad
    ?smooth / ?fps and malformed Content-Length are JSON 400s; an unknown
    path is a 404; a stream survives a refused push."""
    _, p, base = video_server
    S = p.cfg.data.image_size
    _, wav = _video(8, 30.0, seed=3)

    def expect(path, body, code, needle):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + path, body)
        assert e.value.code == code
        assert needle in json.load(e.value)["error"]

    expect("/predict", b"not an npz", 400, "npz")
    expect("/predict", _npz(frames=np.zeros((8, S, S, 3), np.float32),
                            waveform=wav), 400, "uint8")
    expect("/predict", _npz(frames=np.zeros((8, S + 2, S, 3), np.uint8),
                            waveform=wav), 400, "shape")
    expect("/predict", _npz(frames=np.zeros((8, S, S, 3), np.uint8),
                            waveform=np.zeros((5, 4), np.float32)), 400, "1-D")
    expect("/predict", _npz(waveform=wav), 400, "frames")
    good = _npz(frames=np.zeros((8, S, S, 3), np.uint8), waveform=wav)
    expect("/predict?smooth=abc", good, 400, "smooth")
    expect("/predict?fps=999", good, 400, "band")
    expect("/nope", b"x", 404, "unknown")
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/stream/open?fps=abc", b"")
    assert e.value.code == 400
    for path in ("/predict", "/reload"):
        resp, _ = _raw(base, f"POST {path} HTTP/1.1\r\nHost: x\r\n"
                             "Content-Length: abc\r\n\r\n".encode())
        assert " 400 " in resp.splitlines()[0] and "error" in resp
    with _post(base + "/stream/open", b"") as r:
        sid = json.load(r)["id"]
    expect(f"/stream/{sid}/push",
           _npz(frames=np.zeros((4, S, S, 3), np.int32), waveform=wav), 400,
           "uint8")
    with _post(f"{base}/stream/{sid}/push",
               _npz(frames=np.zeros((4, S, S, 3), np.uint8),
                    waveform=wav[:2000])) as r:
        assert json.load(r)["start"] == 0
    with _post(f"{base}/stream/{sid}/flush", b"") as r:
        assert len(json.load(r)["pred"]) == 4


def test_oversize_body_is_413_before_read(server):
    """A huge Content-Length is refused 413 before any body byte is read
    (max_body bounds request RAM) and the connection closes; /statz counts
    the refused bytes; a conforming request still round-trips. The default
    max_body is 256 MiB."""
    _, p, _ = server
    assert PredictServer.DEFAULT_MAX_BODY == 256 << 20
    srv = PredictServer(p, port=0, max_body=1 << 20)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        huge = 10 << 30                        # 10 GiB never sent
        for path in ("/predict", "/stream/open", "/reload"):
            resp, dt = _raw(base, f"POST {path} HTTP/1.1\r\nHost: x\r\n"
                                  f"Content-Length: {huge}\r\n\r\n".encode())
            assert dt < 10
            assert " 413 " in resp.splitlines()[0] and "max_body" in resp
        st = _get(base + "/statz")
        assert st["rejected_bytes"] >= 3 * huge
        body = _npz(waveform=_video(8, 30.0, seed=7, use_video=False)[1])
        assert len(body) <= 1 << 20
        with _post(base + "/predict", body) as r:
            json.load(r)
        assert _get(base + "/statz")["bytes_in"]["predict"] == len(body)
        # a non-positive length is a 400 and a close, not a hung read
        with _post(base + "/stream/open", b"") as r:
            sid = json.load(r)["id"]
        for route, n in ((f"/stream/{sid}/push", -1), ("/predict", 0)):
            resp, dt = _raw(base, f"POST {route} HTTP/1.1\r\nHost: x\r\n"
                                  f"Content-Length: {n}\r\n\r\n".encode())
            assert dt < 10 and " 400 " in resp.splitlines()[0]
        # a body on a route that reads none still gets its 200
        resp, _ = _raw(base, b"POST /stream/open HTTP/1.1\r\nHost: x\r\n"
                             b"Content-Length: 5\r\n\r\nxxxxx")
        assert " 200 " in resp.splitlines()[0]
    finally:
        srv.shutdown()


def test_ttl_eviction_410_and_404(server):
    """Streams idle past the TTL are evicted: their slots come back (open
    succeeds again at capacity) and they answer 410; an id that never
    existed answers 404; a flushed stream is not resurrected by a late
    touch."""
    _, p, _ = server
    srv = PredictServer(p, port=0, max_streams=2, stream_ttl_s=0.25)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        sids = []
        for _ in range(2):
            with _post(base + "/stream/open", b"") as r:
                sids.append(json.load(r)["id"])
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/stream/open", b"")
        assert e.value.code == 429
        time.sleep(0.4)
        with _post(base + "/stream/open", b"") as r:
            json.load(r)
        body = _npz(waveform=np.zeros(4000, np.float32))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/stream/{sids[0]}/push", body)
        assert e.value.code == 410
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/stream/nope/push", body)
        assert e.value.code == 404
        assert _get(base + "/statz")["evicted_streams"] >= 2
        srv._streams["sX"] = srv._group.open()
        srv._touch("sX")
        srv._drop_stream("sX")
        srv._touch("sX")
        assert "sX" not in srv._touched and "sX" not in srv._streams
    finally:
        srv.shutdown()


def test_concurrent_lifecycle_stress(server):
    """Eight threads race opens, pushes (some malformed), flushes, pushes
    to dead ids, whole-video predicts and /statz polls (the eviction scan)
    with a short switch interval: only 200 / 400 / 404 / 410 / 429 come
    back, never a 500 or a dropped connection, and afterwards every slot
    can be opened again."""
    import sys
    _, p, _ = server
    srv = PredictServer(p, port=0, max_streams=8, stream_ttl_s=0.6)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    _, wav = _video(24, 30.0, seed=77, use_video=False)
    unexpected = []

    def worker(i):
        rng = np.random.RandomState(i)
        try:
            for _ in range(6):
                r = rng.rand()
                try:
                    if r < 0.45:
                        with _post(base + "/stream/open", b"") as resp:
                            sid = json.load(resp)["id"]
                        for _ in range(2):
                            if rng.rand() < 0.25:
                                body = _npz(frames=np.zeros((2, 4, 4, 3),
                                                            np.uint8))
                            else:
                                body = _npz(waveform=wav[:int(
                                    rng.randint(2000, 9000))])
                            _post(f"{base}/stream/{sid}/push", body)
                        if rng.rand() < 0.7:
                            _post(f"{base}/stream/{sid}/flush", b"")
                    elif r < 0.7:
                        _post(f"{base}/stream/s{int(rng.randint(40))}/push",
                              _npz(waveform=wav[:3000]))
                    elif r < 0.85:
                        _post(base + "/predict", _npz(waveform=wav))
                    else:
                        _get(base + "/statz")
                except urllib.error.HTTPError as e:
                    if e.code not in (400, 404, 410, 429):
                        unexpected.append((i, e.code, e.read()[:200]))
        except Exception as e:  # noqa: BLE001 — dropped connections etc.
            unexpected.append((i, type(e).__name__, str(e)[:200]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not unexpected, unexpected[:5]
        time.sleep(0.8)                 # idle sessions age out
        for _ in range(8):
            with _post(base + "/stream/open", b"") as r:
                json.load(r)
        s = _get(base + "/statz")
        assert s["active_streams"] == 8
        assert s["responses"].get("stream/push:5xx", 0) == 0
    finally:
        srv.shutdown()


def _stalled_server(p, push_timeout_s):
    """A server whose batcher stalls inside push_many until ``release`` is
    set, its batch window long enough for a second push to queue."""
    srv = PredictServer(p, port=0, push_timeout_s=push_timeout_s)
    srv.batch_window_s = 0.4
    release = threading.Event()
    orig = srv._group.push_many

    def stalled(pushes, errors=None):
        release.wait(15)
        return orig(pushes, errors=errors)
    srv._group.push_many = stalled
    return srv, release


def test_push_timeout_cancels_a_queued_push(server):
    """A push that times out while still queued is removed, never applied
    (503, safe to retry): the retry reproduces offline exactly. A push the
    stalled leader already took fails with the session-closing error
    instead, never a retryable one."""
    _, p, _ = server
    _, wav = _video(30, 30.0, seed=77, use_video=False)
    want = p.predict_video(waveform=wav)["pred"]
    srv, release = _stalled_server(p, push_timeout_s=0.6)
    try:
        sess = srv._group.open()
        res, errs = {}, {}

        def push(key, s, chunk):
            try:
                res[key] = srv._stream_push(s, {"waveform": chunk})
            except Exception as e:  # noqa: BLE001
                errs[key] = e

        ta = threading.Thread(target=push, args=("a", sess, wav[:9000]))
        ta.start()
        time.sleep(0.1)
        tb = threading.Thread(target=push, args=("b", sess, wav[9000:]))
        tb.start()                      # the same session: deferred
        tb.join(timeout=10)
        assert isinstance(errs.get("b"), TimeoutError), (res, errs)
        assert "retry" in str(errs["b"])
        with srv._pending_lock:
            assert not srv._pending
        release.set()
        ta.join(timeout=10)
        assert not ta.is_alive() and "a" in res, errs
        got = [res["a"][1], srv._stream_push(sess, {"waveform": wav[9000:]})[1],
               sess.flush()[1]]
        np.testing.assert_allclose(np.concatenate(got), want,
                                   rtol=TOL, atol=TOL)
    finally:
        release.set()
        srv._httpd.server_close()
    srv, release = _stalled_server(p, push_timeout_s=0.4)
    try:
        s1, s2 = srv._group.open(), srv._group.open()
        errs = {}

        def push2(key, s):
            try:
                srv._stream_push(s, {"waveform": np.zeros(9000, np.float32)})
            except Exception as e:  # noqa: BLE001
                errs[key] = e

        ta = threading.Thread(target=push2, args=("a", s1))
        ta.start()
        time.sleep(0.1)
        tb = threading.Thread(target=push2, args=("b", s2))
        tb.start()                      # another session: the same batch
        tb.join(timeout=10)
        assert isinstance(errs.get("b"), _StreamStuckError), errs
        release.set()
        ta.join(timeout=10)
        assert not ta.is_alive() and "a" not in errs
    finally:
        release.set()
        srv._httpd.server_close()


def test_reload_is_403_unless_allowed_then_swaps(server, tmp_path):
    """/reload is refused (403) by default; with ``allow_reload`` a bad
    path is a 400 that leaves the old weights serving, and a good one swaps
    in the new weights: /predict then equals the JAX Predictor of the new
    checkpoint, and /healthz counts the reload."""
    jp_old, p, base = server
    body = json.dumps({"checkpoint": "x.npz"}).encode()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/reload", body)
    assert e.value.code == 403
    jcfg, new = _checkpoint(tmp_path, False, seed=5)
    q = Predictor(cfg=p.cfg, device="cpu")
    q.model.load_state_dict(p.model.state_dict())
    srv = PredictServer(q, port=0, allow_reload=True)
    srv.start_background()
    b2 = f"http://127.0.0.1:{srv.port}"
    _, wav = _video(24, 30.0, seed=6, use_video=False)
    audio = _npz(waveform=wav)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(b2 + "/reload", json.dumps(
                {"checkpoint": str(tmp_path / "none.npz")}).encode())
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(b2 + "/reload", b'{"checkpoint": 12}')
        assert e.value.code == 400
        with _post(b2 + "/predict", audio) as r:
            old = np.asarray(json.load(r)["pred"], np.float32)
        np.testing.assert_allclose(old, jp_old.predict_video(
            waveform=wav)["pred"], rtol=TOL, atol=TOL)
        with _post(b2 + "/reload", json.dumps({"checkpoint": new}).encode()) as r:
            info = json.load(r)
        assert info["ok"] and info["reloads"] == 1 and info["step"] == 0
        with _post(b2 + "/predict", audio) as r:
            got = np.asarray(json.load(r)["pred"], np.float32)
        want = JPredictor(cfg=jcfg, checkpoint=new).predict_video(
            waveform=wav)["pred"]
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert np.abs(got - old).max() > 1e-3       # the weights did change
        h = _get(b2 + "/healthz")
        assert h["reloads"] == 1 and h["checkpoint"] == new
    finally:
        srv.shutdown()


def test_run_server_warms_predictor_and_group_with_its_rates(server,
                                                             monkeypatch):
    """run_server warms the predictor up to ``warmup_frames`` and then the
    group's micro-batch buckets, both with ``warmup_rates``."""
    _, p, _ = server
    calls = []
    monkeypatch.setattr(type(p), "warmup",
                        lambda self, max_frames=1024, rates=(): calls.append(
                            ("predictor", max_frames, rates)))
    monkeypatch.setattr(pred_mod.SessionGroup, "warmup",
                        lambda self, rates=(): calls.append(("group", rates)))

    def _interrupt(self):
        raise KeyboardInterrupt
    monkeypatch.setattr(PredictServer, "serve_forever", _interrupt)
    # shutdown() waits for a serve_forever loop that never ran
    monkeypatch.setattr(PredictServer, "shutdown",
                        lambda self: self._httpd.server_close())
    assert run_server(p, port=0, warmup_frames=8, warmup_rates=(25.0,),
                      log=lambda *a, **k: None) == 0
    assert calls == [("predictor", 8, (25.0,)), ("group", (25.0,))]


def test_a_cuda_server_needs_a_gpu():
    """The server serves the predictor it is given; a CUDA Predictor
    without a GPU raises before any server exists."""
    if torch.cuda.is_available():
        srv = PredictServer(Predictor(cfg=tiny(tc)), port=0)
        assert srv.predictor.model.head.kernel.is_cuda
        srv._httpd.server_close()
        return
    with pytest.raises(RuntimeError, match="cuda"):
        PredictServer(Predictor(cfg=tiny(tc)), port=0)
