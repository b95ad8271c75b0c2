"""The port's profiling hooks (m3f_torch/utils/profiling.py, and
``train.profile_dir`` in ``Trainer.fit``) against the JAX package's
``utils/profiling.py``: one set of synthetic events, written once as a TPU
track of a JAX trace and once as CUDA kernel and copy events of a torch
trace, gives the same summary rows; ``StepTimer`` the same summary for the
same times; ``fit`` traces steps start+2 to start+12 on the CPU."""

import gzip
import json

import numpy as np
import pytest
import torch

import m3f.pytorch_tpu.utils.profiling as jprof
import m3f_torch.config as tc
from m3f_torch.data.synthetic import SyntheticAVDataset
from m3f_torch.data.windowing import WindowSequencer, example_stream
from m3f_torch.train import loop
from m3f_torch.train.loop import Trainer
from m3f_torch.utils import profiling

# (name, start us, duration us, kind): a per-step marker ("7") and a host
# op neither summary counts; "fusion.1" / "fusion.2" merge under group
EVENTS = (("fusion.1", 0.0, 120.5, "kernel"),
          ("fusion.2", 130.0, 60.25, "kernel"),
          ("convolution.3", 200.0, 310.0, "kernel"),
          ("copy", 520.0, 40.0, "gpu_memcpy"),
          ("fill", 570.0, 5.0, "gpu_memset"),
          ("reduce.12", 580.0, 90.0, "kernel"),
          ("7", 0.0, 700.0, "kernel"))
HOST_OP = ("aten::conv3d", 0.0, 900.0)


def _write(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _jax_trace(d):
    """The events on a TPU track of a jax.profiler trace."""
    ev = [{"ph": "M", "name": "process_name", "pid": 1,
           "args": {"name": "/device:TPU:0"}},
          {"ph": "M", "name": "process_name", "pid": 2,
           "args": {"name": "/host:CPU"}},
          {"ph": "X", "pid": 2, "name": HOST_OP[0], "ts": HOST_OP[1],
           "dur": HOST_OP[2]}]
    for i, (name, ts, dur, _) in enumerate(EVENTS):
        ev.append({"ph": "X", "pid": 1, "tid": i, "name": name, "ts": ts,
                   "dur": dur, "args": {"long_name": f"%{name} = (bf16[64]) "
                                                     f"fusion(x)"}})
    _write(d / "plugins" / "profile" / "run" / "host.trace.json.gz", ev)


def _torch_trace(d):
    """The same events as CUDA kernel / memcpy / memset events of a torch
    profiler trace, beside a host op."""
    ev = [{"ph": "X", "cat": "cpu_op", "pid": 100, "tid": 100,
           "name": HOST_OP[0], "ts": HOST_OP[1], "dur": HOST_OP[2]}]
    for name, ts, dur, cat in EVENTS:
        args = ({"grid": [132, 1, 1], "block": [256, 1, 1]}
                if cat == "kernel" else {"bytes": 4096})
        ev.append({"ph": "X", "cat": cat, "pid": 0, "tid": 7, "name": name,
                   "ts": ts, "dur": dur, "args": args})
    _write(d / "host_1.1.pt.trace.json.gz", ev)


@pytest.mark.parametrize("group", [True, False])
@pytest.mark.parametrize("top", [15, 3])
def test_summarize_trace_matches_jax(tmp_path, group, top):
    """Equal op, ms, percent (and count) rows, largest first; the port's
    detail is the kernel's launch geometry or the copy's bytes, where the
    JAX one's is the HLO's result shapes."""
    _jax_trace(tmp_path / "jax")
    _torch_trace(tmp_path / "torch")
    want = jprof.summarize_trace(str(tmp_path / "jax"), top=top, group=group)
    got = profiling.summarize_trace(str(tmp_path / "torch"), top=top,
                                    group=group)
    assert len(got) == len(want) == min(top, 5 if group else 6)
    for g, w in zip(got, want):
        assert g["op"] == w["op"]
        assert g.get("count") == w.get("count")
        np.testing.assert_allclose([g["ms"], g["percent"]],
                                   [w["ms"], w["percent"]], rtol=1e-12)
    if not group:
        detail = {r["op"]: r["detail"] for r in got}
        assert detail["convolution.3"] == "grid [132, 1, 1] block [256, 1, 1]"
        if "copy" in detail:
            assert detail["copy"] == "4096 bytes"
    assert got[0]["op"] == ("convolution" if group else "convolution.3")


def test_device_total_counts_busy_time_once(tmp_path):
    """The union of the device intervals: two kernels on two streams at
    once count once, a host op not at all."""
    ev = [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "a",
           "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "pid": 0, "tid": 8, "name": "b",
           "ts": 50.0, "dur": 100.0},
          {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "name": "c",
           "ts": 200.0, "dur": 10.0},
          {"ph": "X", "cat": "cpu_op", "pid": 100, "tid": 100, "name": "h",
           "ts": 0.0, "dur": 1000.0}]
    _write(tmp_path / "x.pt.trace.json.gz", ev)
    assert profiling.device_total_ms(str(tmp_path)) == pytest.approx(0.160)
    with pytest.raises(FileNotFoundError):
        profiling.device_total_ms(str(tmp_path / "none"))


def test_step_timer_summary_matches_jax():
    times = list(np.random.RandomState(0).uniform(0.01, 0.5, 23))
    a, b = profiling.StepTimer(), jprof.StepTimer()
    a.times, b.times = list(times), list(times)
    assert a.summary() == b.summary()
    assert profiling.StepTimer().summary() == jprof.StepTimer().summary() == {}
    a.start()
    assert a.stop(torch.ones(3)) >= 0 and len(a.times) == 24


def test_trace_writes_a_gzipped_chrome_trace(tmp_path):
    """On the CPU the trace holds host ops and no device event; an empty
    dir traces nothing."""
    with profiling.trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    (path,) = tmp_path.glob("*.pt.trace.json.gz")
    with gzip.open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert profiling.summarize_trace(str(tmp_path)) == []
    assert profiling.device_total_ms(str(tmp_path)) == 0.0
    with profiling.trace(""):
        pass


def _cfg(profile_dir, num_steps):
    return tc.ExperimentConfig(
        name="prof",
        model=tc.ModelConfig(
            audio=tc.AudioNetConfig(channels=(4, 8), feature_dim=8),
            visual=tc.VisualNetConfig(block_channels=(8, 16),
                                      blocks_per_stage=(1, 1),
                                      stem_channels=8, feature_dim=16),
            gru=tc.GRUConfig(hidden_size=8), compute_dtype="float32"),
        window=tc.WindowConfig(windows_per_clip=2),
        data=tc.DataConfig(synthetic_num_videos=2, synthetic_video_frames=64,
                           image_size=32),
        train=tc.TrainConfig(batch_size=1, num_steps=num_steps, log_every=0,
                             eval_every=0, checkpoint_every=0,
                             profile_dir=profile_dir))


@pytest.mark.parametrize("num_steps", [14, 6])
def test_fit_traces_steps_start_plus_2_to_start_plus_12(tmp_path, monkeypatch,
                                                        num_steps):
    """``train.profile_dir``: the profiler is on for steps 2 to 12 (of a
    fit from step 0), as the JAX fit's ``jax.profiler`` trace is, and a
    trace lands in the dir; a fit shorter than that stops the trace at its
    end."""
    cfg = _cfg(str(tmp_path / "prof"), num_steps)
    tr = Trainer(cfg, device="cpu")
    traced = []
    step = Trainer.train_step

    def recording(self, state, batch):
        traced.append(torch._C._autograd._profiler_enabled())
        return step(self, state, batch)
    monkeypatch.setattr(Trainer, "train_step", recording)
    ds = SyntheticAVDataset(cfg.data, cfg.model.mel)
    seq = WindowSequencer(cfg.window, cfg.model.mel, mel_frames=16)
    tr.fit(lambda skip: example_stream(ds, seq, 1, seed=0, skip_batches=skip),
           log=lambda s: None)
    assert traced == [2 <= i <= 12 for i in range(num_steps)]
    assert not torch._C._autograd._profiler_enabled()
    assert len(list((tmp_path / "prof").glob("*.pt.trace.json.gz"))) == 1


def test_fit_without_profile_dir_traces_nothing(monkeypatch):
    cfg = _cfg("", 3)
    seen = []
    monkeypatch.setattr(loop, "trace", lambda d: seen.append(d))
    ds = SyntheticAVDataset(cfg.data, cfg.model.mel)
    seq = WindowSequencer(cfg.window, cfg.model.mel, mel_frames=16)
    Trainer(cfg, device="cpu").fit(example_stream(ds, seq, 1, seed=0),
                                   log=lambda s: None)
    assert seen == []
