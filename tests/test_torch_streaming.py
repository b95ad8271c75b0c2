"""The port's live serving path (m3f_torch/infer/predictor.py:
``Predictor.stream`` / ``warmup``, ``StreamingSession``, ``SessionGroup``)
against the JAX package's on one JAX checkpoint, and against the port's
own ``predict_video``: the counterparts of the streaming tests of
``tests/test_predictor.py``. Small models (32×32 frames), inputs numpy from
a seed; fp32 and bf16 compute where outputs are compared with JAX."""

import numpy as np
import pytest
import torch
import jax

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.infer import Predictor as JPredictor
from m3f.pytorch_tpu.infer.predictor import SessionGroup as JSessionGroup
from m3f.pytorch_tpu.train.checkpoint import Checkpointer
from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
from m3f_torch.infer import Predictor, SessionGroup
from m3f_torch.ops.melspec import log_mel_spectrogram_reference, row_hops

F32_TOL = 2e-5      # fp32 against JAX, and between two port paths in fp32
BF16_TOL = 3e-2     # bf16 against JAX: one-ulp rounding differences carried
SR = 16000


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tiny(mod, dtype="float32", use_video=True, **window):
    cfg = mod.ExperimentConfig(
        name="stream_tiny",
        model=mod.ModelConfig(
            use_video=use_video,
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            visual=mod.VisualNetConfig(block_channels=(8, 16),
                                       blocks_per_stage=(1, 1),
                                       stem_channels=8, feature_dim=16),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype=dtype),
        window=mod.WindowConfig(windows_per_clip=2, eval_stride=8, **window),
        data=mod.DataConfig(image_size=32),
        train=mod.TrainConfig(batch_size=2))
    # one data device: the stream's [1, W, ...] forward on the 8-device
    # test mesh costs seconds of dispatch a push on the JAX side
    return mod.apply_overrides(cfg, {"train.mesh.num_data": 1})


def _video(n, fps, seed, use_video=True):
    rng = np.random.RandomState(seed)
    frames = (rng.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8)
              if use_video else None)
    wav = (rng.randn(int(round(n / fps * SR)) + SR) * 0.3).astype(np.float32)
    return frames, wav


def _run_stream(sess, frames, wav, chunk_frames, fps):
    """Push ``chunk_frames`` frames (and their audio) at a time, then the
    audio's tail, then flush; the concatenated emission, checked to be
    contiguous and online (some frames out before the flush)."""
    got, fi, ai = [], 0, 0
    n = len(frames) if frames is not None else 0
    while fi < n or (frames is None and ai < len(wav)):
        a = int(round((fi + chunk_frames) / fps * SR))
        kw = {"waveform": wav[ai:a]}
        if frames is not None:
            kw["frames"] = frames[fi:fi + chunk_frames]
        lo, preds = sess.push(**kw)
        assert lo == sum(len(g) for g in got)      # contiguous emission
        got.append(preds)
        fi, ai = fi + chunk_frames, a
    if ai < len(wav):
        got.append(sess.push(waveform=wav[ai:])[1])
    before_flush = sum(len(g) for g in got)
    got.append(sess.flush()[1])
    assert before_flush > 0                         # online, not at the end
    return np.concatenate(got)


@pytest.fixture(scope="module", params=[
    ("fusion", "float32"), ("fusion", "bfloat16"), ("audio", "float32")])
def pair(request, tmp_path_factory):
    """(kind, dtype, JAX Predictor, port Predictor) on one JAX checkpoint."""
    kind, dtype = request.param
    use_video = kind == "fusion"
    cfg = tiny(jc, dtype, use_video)
    state = JTrainer(cfg).init_state()
    d = tmp_path_factory.mktemp(f"ckpt_{kind}_{dtype}")
    path = Checkpointer(str(d), keep=1, cfg=cfg).save(jax.device_get(state))
    port = Predictor(cfg=tiny(tc, dtype, use_video), checkpoint=path,
                     device="cpu")
    return kind, dtype, JPredictor(cfg=cfg, checkpoint=path), port


@pytest.mark.parametrize("fps", [None, 25.0], ids=["nominal", "off_rate"])
def test_stream_matches_jax_stream_and_offline(pair, fps):
    """A 52-frame stream pushed 7 frames at a time: equal to the JAX
    package's stream on the same checkpoint and to the port's own
    ``predict_video``."""
    kind, dtype, jp, port = pair
    use_video = kind == "fusion"
    frames, wav = _video(52, fps or 30.0, seed=3, use_video=use_video)
    got = _run_stream(port.stream(fps=fps), frames, wav, 7, fps or 30.0)
    want = _run_stream(jp.stream(fps=fps), frames, wav, 7, fps or 30.0)
    offline = port.predict_video(frames=frames, waveform=wav,
                                 fps=fps)["pred"]
    assert got.shape == want.shape == offline.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, offline, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def audio_port():
    return Predictor(cfg=tiny(tc, use_video=False), device="cpu")


@pytest.mark.parametrize("seed", range(3))
def test_stream_random_chunking_matches_offline(audio_port, seed):
    """Arbitrary push sizes, one sample up, reproduce ``predict_video``."""
    p = audio_port
    rng = np.random.RandomState(100 + seed)
    _, wav = _video(20 + 15 * seed, 30.0, seed=seed, use_video=False)
    offline = p.predict_video(waveform=wav)["pred"]
    sess = p.stream()
    got, i = [], 0
    while i < len(wav):
        k = int(rng.randint(1, 6000))
        got.append(sess.push(waveform=wav[i:i + k])[1])
        i += k
    got.append(sess.flush()[1])
    np.testing.assert_allclose(np.concatenate(got), offline,
                               rtol=F32_TOL, atol=F32_TOL)


def test_stream_buffers_stay_bounded():
    """A live session keeps O(latency) frames, samples and accumulator
    rows, not O(stream): 12 pushes of 16 frames wrap its buffers many
    times over (latency_frames is 24 here)."""
    p = Predictor(cfg=tiny(tc), device="cpu")
    sess = p.stream()
    rng = np.random.RandomState(0)
    chunk_f, n_push = 16, 12
    chunk_a = int(chunk_f / 30.0 * SR)
    assert n_push * chunk_f > 4 * sess.latency_frames
    total = 0
    for i in range(n_push):
        _, preds = sess.push(
            frames=rng.randint(0, 256, (chunk_f, 32, 32, 3), np.uint8),
            waveform=rng.randn(chunk_a).astype(np.float32))
        total += len(preds)
        bound_f = sess.latency_frames + 2 * chunk_f
        assert len(sess._frames) <= bound_f, (i, len(sess._frames))
        assert len(sess._wav) <= int(bound_f / 30.0 * SR) + sess.spw + chunk_a
        assert len(sess._num) <= sess.latency_frames + chunk_f
    _, preds = sess.flush()
    assert total + len(preds) == n_push * chunk_f


def test_short_video_in_one_flush():
    """Shorter than one window: nothing before the flush, then the padded
    tail equals offline."""
    p = Predictor(cfg=tiny(tc), device="cpu")
    frames, wav = _video(9, 30.0, seed=0)
    offline = p.predict_video(frames=frames, waveform=wav)["pred"]
    sess = p.stream()
    _, a = sess.push(frames=frames, waveform=wav)
    assert len(a) == 0
    _, b = sess.flush()
    np.testing.assert_allclose(b, offline, rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(ValueError, match="flushed"):
        sess.push(frames=frames[:1])        # a flushed session is closed


def test_stream_refusals():
    """``eval_smooth > 1`` refuses a stream (a centred smoother needs future
    frames), as JAX does; so does a rate outside the band. A session
    refuses the modality its model lacks and a bad shape, leaving its
    buffers as they were, and a flush without audio for an audio model."""
    cfg = tc.apply_overrides(tiny(tc, use_video=False),
                             {"window.eval_smooth": 5})
    with pytest.raises(ValueError, match="streaming"):
        Predictor(cfg=cfg, device="cpu").stream()
    jp = JPredictor(cfg=jc.apply_overrides(tiny(jc, use_video=False),
                                           {"window.eval_smooth": 5}))
    with pytest.raises(ValueError, match="streaming"):
        jp.stream()
    p = Predictor(cfg=tiny(tc, use_video=False), device="cpu")
    with pytest.raises(ValueError, match="band"):
        p.stream(fps=1000.0)
    sess = p.stream()
    with pytest.raises(ValueError, match="audio-only"):
        sess.push(frames=np.zeros((4, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="1-D"):
        sess.push(waveform=np.zeros((3, 5), np.float32))
    assert len(sess._wav) == 0 and sess._nwin == 0
    sess = Predictor(cfg=tiny(tc), device="cpu").stream()
    sess.push(frames=np.zeros((4, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="no waveform"):
        sess.flush()


def test_row_hops_broadcast_from_the_left():
    """A batch of dynamic-hop sessions feeds one hop per entry, [b], for a
    [b, W, samples] wav: every window of entry i is framed at hop i, as the
    plain version frames it (the kernel's wrapper takes ``row_hops``)."""
    hops = torch.tensor([640, 593, 711], dtype=torch.int32)
    assert row_hops(hops, (3, 2)).tolist() == [640, 640, 593, 593, 711, 711]
    assert row_hops(torch.tensor(640), (2, 2)).tolist() == [640] * 4
    cfg = tc.MelConfig()
    frames_out = 9
    wav = torch.from_numpy(np.random.RandomState(1).randn(3, 2, 8 * 711)
                           .astype(np.float32))
    batch = log_mel_spectrogram_reference(wav, cfg, hop=hops,
                                          n_frames_out=frames_out)
    for i, h in enumerate(hops.tolist()):
        one = log_mel_spectrogram_reference(wav[i], cfg, hop=h,
                                            n_frames_out=frames_out)
        torch.testing.assert_close(batch[i], one, rtol=0, atol=0)


def _tick_schedule(lengths, first, rng):
    """Per tick, {session index: (frame lo, frame hi)}: a first tick of
    ``first`` frames for every session, then uneven arrival, some sessions
    skipping some ticks."""
    yield {i: (0, first) for i in range(len(lengths))}
    pos = [first] * len(lengths)
    while any(p < n for p, n in zip(pos, lengths)):
        tick = {}
        for i, n in enumerate(lengths):
            if pos[i] >= n or rng.rand() < 0.25:
                continue
            tick[i] = (pos[i], min(pos[i] + int(rng.randint(6, 30)), n))
            pos[i] = tick[i][1]
        if tick:
            yield tick


def _drive_group(group, sessions, videos, fpss, schedule):
    """Feed each tick's slices through ``push_many``; every session's
    emission, flushed at the end."""
    got = [[] for _ in sessions]
    for tick in schedule:
        pushes = {}
        for i, (lo, hi) in tick.items():
            frames, wav = videos[i]
            a0, a1 = (int(round(f / fpss[i] * SR)) for f in (lo, hi))
            if hi == len(frames):
                a1 = len(wav)                       # the audio's tail too
            pushes[sessions[i]] = {"frames": frames[lo:hi],
                                   "waveform": wav[a0:a1]}
        outs = group.push_many(pushes)
        for i, s in enumerate(sessions):
            if s in outs:
                got[i].append(outs[s][1])
    for i, s in enumerate(sessions):
        got[i].append(group.flush(s)[1])
    return [np.concatenate(g) for g in got]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_session_group_matches_inline_and_jax(tmp_path, dtype):
    """Four sessions, two at the nominal rate and two off-rate at 25 and 27
    fps (the dynamic hop), fed through ``push_many`` tick by tick: the
    off-rate pair share each batch with a per-entry hop, and ticks pad to
    power-of-two buckets. Each session's output equals its inline stream
    and its own ``predict_video`` (fp32: 2e-5), and the JAX package's
    SessionGroup on the same checkpoint and ticks."""
    jcfg = tiny(jc, dtype)
    path = Checkpointer(str(tmp_path), keep=1, cfg=jcfg).save(
        jax.device_get(JTrainer(jcfg).init_state()))
    port = Predictor(cfg=tiny(tc, dtype), checkpoint=path, device="cpu")
    jp = JPredictor(cfg=jcfg, checkpoint=path)
    fpss = [30.0, 25.0, 30.0, 27.0]
    lengths = [40, 48, 56, 44]
    videos = [_video(n, f, seed=20 + i)
              for i, (n, f) in enumerate(zip(lengths, fpss))]
    rates = [None if f == 30.0 else f for f in fpss]
    # the first tick, 30 frames each, readies one group in every session
    schedule = list(_tick_schedule(lengths, 30, np.random.RandomState(0)))

    group = SessionGroup(port, max_batch=8)
    sizes = []
    fwd = group._fwd

    def recording(feed):
        sizes.append((len(next(iter(feed.values()))),
                      feed["hop"].tolist() if "hop" in feed else None))
        return fwd(feed)
    group._fwd = recording
    got = _drive_group(group, [group.open(fps=r) for r in rates], videos,
                       fpss, schedule)
    jgroup = JSessionGroup(jp, max_batch=8)
    want = _drive_group(jgroup, [jgroup.open(fps=r) for r in rates], videos,
                        fpss, schedule)
    # the first tick's off-rate batch held both sessions, each at its hop
    assert (2, [640, 593]) in sizes, sizes
    assert {b for b, _ in sizes} <= {1, 2, 4, 8}
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for i, (frames, wav) in enumerate(videos):
        inline = _run_stream(port.stream(fps=rates[i]), frames, wav, 9,
                             fpss[i])
        offline = port.predict_video(frames=frames, waveform=wav,
                                     fps=rates[i])["pred"]
        assert got[i].shape == (lengths[i], 2)
        np.testing.assert_allclose(got[i], inline, rtol=tol, atol=tol,
                                   err_msg=f"session {i} vs inline")
        np.testing.assert_allclose(got[i], offline, rtol=tol, atol=tol,
                                   err_msg=f"session {i} vs offline")
        np.testing.assert_allclose(got[i], want[i], rtol=tol, atol=tol,
                                   err_msg=f"session {i} vs JAX")


def test_push_many_isolates_a_bad_session(audio_port):
    """One malformed push (wrong modality, bad shape, a flushed session)
    fails only its own session: the healthy one's groups are forwarded,
    the bad one's buffers are untouched, and the healthy stream stays
    equal to offline."""
    p = audio_port
    group = SessionGroup(p, max_batch=8)
    _, wav = _video(30, 30.0, seed=42, use_video=False)
    offline = p.predict_video(waveform=wav)["pred"]
    good, bad = group.open(), group.open()
    got = []
    errs = {}
    outs = group.push_many(
        {good: {"waveform": wav[:16000]},
         bad: {"frames": np.zeros((4, 8, 8, 3), np.uint8)}}, errors=errs)
    assert isinstance(errs[bad], ValueError) and "audio-only" in str(errs[bad])
    assert bad not in outs and good in outs
    assert len(bad._wav) == 0                  # atomic: nothing half-appended
    got.append(outs[good][1])
    errs = {}
    outs = group.push_many(
        {good: {"waveform": wav[16000:32000]},
         bad: {"waveform": np.zeros((3, 5), np.float32)}}, errors=errs)
    assert isinstance(errs[bad], ValueError) and "1-D" in str(errs[bad])
    got.append(outs[good][1])
    bad.flush()
    errs = {}
    outs = group.push_many(
        {good: {"waveform": wav[32000:]}, bad: {"waveform": wav[:100]}},
        errors=errs)
    assert "flushed" in str(errs[bad])
    got.append(outs[good][1])
    got.append(group.flush(good)[1])
    np.testing.assert_allclose(np.concatenate(got), offline,
                               rtol=F32_TOL, atol=F32_TOL)


def test_push_many_forwards_collected_groups_even_when_raising(audio_port):
    """Without ``errors`` push_many raises, but only after the healthy
    session's collected groups ran: its finalized frames come back at the
    next emit and the stream stays equal to offline."""
    p = audio_port
    group = SessionGroup(p, max_batch=8)
    _, wav = _video(26, 30.0, seed=7, use_video=False)
    offline = p.predict_video(waveform=wav)["pred"]
    good, dead = group.open(), group.open()
    dead.flush()
    calls = []
    fwd = group._fwd
    group._fwd = lambda feed: calls.append(1) or fwd(feed)
    with pytest.raises(ValueError, match="flushed"):
        group.push_many({good: {"waveform": wav},
                         dead: {"waveform": wav[:100]}})
    assert calls                                # good's groups did run
    got = [good._emit_final()[1], group.flush(good)[1]]
    np.testing.assert_allclose(np.concatenate(got), offline,
                               rtol=F32_TOL, atol=F32_TOL)


def _signature(video=None, mel=None, wav=None, hop=None):
    return (None if video is None else tuple(video.shape),
            None if wav is None else tuple(wav.shape),
            None if hop is None else
            ("per_entry", tuple(hop.shape)) if isinstance(hop, torch.Tensor)
            else "static")


@pytest.mark.parametrize("max_batch", [3, 4])
def test_warmup_covers_every_live_shape(max_batch):
    """``Predictor.warmup`` and ``SessionGroup.warmup`` run every model
    input shape live traffic brings: after them, whole videos of every
    length up to ``max_frames`` (nominal and at a warmed rate, fused and
    chunked), single streams and group ticks of any concurrency up to
    ``max_batch`` bring no new one. With ``max_batch`` 3 the group warms
    through bucket 4, which a tick of 3 pads to."""
    cfg = tiny(tc, window_frames=16, eval_max_windows=6)
    p = Predictor(cfg=cfg, device="cpu")
    group = SessionGroup(p, max_batch=max_batch)
    seen = []
    model = p.model
    orig = type(model).forward

    def recording(video=None, mel=None, wav=None, hop=None):
        seen.append(_signature(video, mel, wav, hop))
        return orig(model, video=video, mel=mel, wav=wav, hop=hop)
    model.forward = recording
    p.warmup(max_frames=80, rates=(25.0,))
    group.warmup(rates=(25.0,))
    warmed = set(seen)
    off = p.stream(fps=25.0)
    assert ((1, 2, 16, 32, 32, 3), (1, 2, off.spw_buf),
            ("per_entry", (1,))) in warmed   # the dynamic-hop stream
    assert len({s[0][0] for s in warmed if s[0]}) >= 4   # batch sizes
    seen.clear()
    rng = np.random.RandomState(5)
    for n in (16, 23, 40, 64, 71, 80, 77):   # 64+: past 6 windows, chunked
        for fps in (None, 25.0):
            frames, wav = _video(n, fps or 30.0, seed=n)
            p.predict_video(frames=frames, waveform=wav, fps=fps)
    for k in range(1, max_batch + 1):
        sessions = [group.open(fps=None if i % 2 else 25.0) for i in range(k)]
        for s in sessions:
            s.push(frames=rng.randint(0, 256, (8, 32, 32, 3), np.uint8))
        group.push_many({s: {"frames": rng.randint(0, 256, (40, 32, 32, 3),
                                                   np.uint8),
                             "waveform": rng.randn(2 * SR).astype(np.float32)}
                         for s in sessions})
        for s in sessions:
            group.flush(s)
    assert seen and set(seen) <= warmed, set(seen) - warmed
