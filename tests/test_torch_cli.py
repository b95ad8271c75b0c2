"""The port's command line (``python -m m3f_torch.main``) against the JAX
package's (``m3f.pytorch_tpu.main``), on the CPU (``--device cpu``) at narrow
widths on a fake ABAW tree (``tests/torch_abaw_fake.py``):

- ``train`` takes the JAX CLI's hop decision (hop-aware on this tree, whose
  25 fps video is off-rate; the fixed hop under ``mel_backend=pallas``),
  writes checkpoints the JAX package loads, resumes, and seeds a fresh
  directory from ``--resume-from``;
- ``eval`` (one checkpoint and an ensemble, ``--per-video``) and
  ``predict`` (the test split's submission) give the JAX CLI's numbers on
  the same checkpoints (fp32: the tolerances of tests/test_torch_train.py
  and tests/test_torch_predictor.py);
- ``serve`` hands ``run_server`` the JAX CLI's arguments; ``export
  --format torch`` writes the JAX CLI's file; ``inspect``, ``doctor`` and
  ``profile`` print what the JAX CLI prints;
- the refusals: the JAX launchers' variables and a launch that names no
  rank or one outside its world (``--coordinator`` itself launches: a group
  of one trains), ``export --format stablehlo``, the XLA cache variable,
  and no GPU without ``--device cpu``;
- ``train.debug_nans``: both packages raise ``FloatingPointError`` on a
  stream whose second batch holds a NaN (JAX under ``jax.debug_nans``), the
  port naming step 2; without the flag the port does not raise.
"""

import contextlib
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

import jax

from m3f.pytorch_tpu import main as jmain
from m3f_torch import main as tmain

from torch_abaw_fake import make_tree, narrow

F32_TOL = 2e-5        # tests/test_torch_predictor.py, fp32 compute
EVAL_TOL = 1e-4       # tests/test_torch_train.py, eval metrics


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("M3F_JAX_CACHE", "M3F_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
              "MEGASCALE_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(k, raising=False)
    torch.set_num_threads(1)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _json_lines(out):
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One port training run on the tree: 2 steps, a checkpoint and an eval
    at each, plus its stdout."""
    base = tmp_path_factory.mktemp("cli")
    root = make_tree(str(base / "abaw"))
    ck = str(base / "ck")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("M3F_JAX_CACHE", raising=False)
        rc, out = _run(tmain.main, [
            "train", "--device", "cpu", *narrow(root), "train.num_steps=2",
            "train.log_every=1", "train.eval_every=1",
            "train.checkpoint_every=1", f"train.checkpoint_dir={ck}"])
    assert rc == 0
    return {"root": root, "ck": ck, "out": out, "base": base,
            "steps": [os.path.join(ck, f"ckpt_{s:08d}.npz") for s in (1, 2)]}


def test_train_is_hop_aware_and_writes_checkpoints_jax_loads(run):
    assert "hop-aware windowing enabled" in run["out"]
    assert "step 2/2" in run["out"] and "eval @2" in run["out"]
    for p in run["steps"] + [os.path.join(run["ck"], "best.npz")]:
        assert os.path.exists(p), p
    from m3f.pytorch_tpu.train.checkpoint import load_model_checkpoint
    from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
    jcfg = jmain.build_config("fusion", narrow(run["root"]))
    st = load_model_checkpoint(JTrainer(jcfg).init_state(), run["steps"][1])
    assert int(st.step) == 2
    with np.load(run["steps"][1]) as z:
        for path, leaf in jax.tree_util.tree_flatten_with_path(st.params)[0]:
            key = ".params/" + "/".join(
                str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            np.testing.assert_array_equal(np.asarray(leaf), z[key])
    rows = [json.loads(l) for l in
            open(os.path.join(run["ck"], "train.jsonl"))]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2]


def test_resume_and_resume_from(run, tmp_path):
    ck = str(tmp_path / "ck")
    rc, out = _run(tmain.main, [
        "train", "--device", "cpu", "--no-eval", *narrow(run["root"]),
        "train.num_steps=3", "train.log_every=1", f"train.checkpoint_dir={ck}",
        "--resume-from", run["steps"][0]])
    assert rc == 0
    assert "seeded" in out and "step 2/3" in out and "step 1/3" not in out
    assert os.path.exists(os.path.join(ck, "ckpt_00000003.npz"))


def test_pallas_mel_backend_keeps_the_fixed_hop(run, tmp_path, monkeypatch):
    seen = []
    real = tmain.train_stream

    def recording(cfg, ds, hop_aware, *axis):
        seen.append(hop_aware)
        return real(cfg, ds, hop_aware, *axis)
    monkeypatch.setattr(tmain, "train_stream", recording)
    rc, out = _run(tmain.main, [
        "train", "--device", "cpu", "--no-eval", *narrow(run["root"]),
        "model.mel_backend=pallas", "train.num_steps=1",
        f"train.checkpoint_dir={tmp_path}"])
    assert rc == 0 and seen == [False]
    assert "WARNING: dataset has off-rate videos" in out


def _eval(main, run, *args, device=()):
    rc, out = _run(main, ["eval", *device, "--split", "val", "--per-video",
                          *args, *narrow(run["root"])])
    assert rc == 0
    return _json_lines(out)


@pytest.mark.parametrize("members", [1, 2])
def test_eval_matches_the_jax_cli(run, members):
    ck = ",".join(run["steps"][-members:])
    want = _eval(jmain.main, run, "--checkpoint", ck)
    got = _eval(tmain.main, run, "--checkpoint", ck, device=("--device", "cpu"))
    assert len(got) == len(want) == 2          # one video row, the result
    assert got[0]["video"] == want[0]["video"] == "vid_v"
    for g, w in zip(got, want):
        for k in w:
            if k != "video":
                np.testing.assert_allclose(g[k], w[k], rtol=EVAL_TOL,
                                           atol=EVAL_TOL, err_msg=k)
    assert all(np.isfinite(v) for v in got[-1].values())
    if members == 2:
        one = _eval(tmain.main, run, "--checkpoint", run["steps"][-1],
                    device=("--device", "cpu"))
        assert one[-1]["ccc_v"] != got[-1]["ccc_v"]


def _submission(d):
    return {f: np.loadtxt(os.path.join(d, f), delimiter=",", skiprows=1)
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("split,members", [("test", 1), ("val", 2)])
def test_predict_matches_the_jax_cli(run, tmp_path, split, members):
    ck = ",".join(run["steps"][-members:])
    outs = []
    for main, dev in ((jmain.main, ()), (tmain.main, ("--device", "cpu"))):
        d = str(tmp_path / ("jax" if main is jmain.main else "port"))
        rc, _ = _run(main, ["predict", *dev, "--split", split, "--checkpoint",
                            ck, "--out", d, *narrow(run["root"])])
        assert rc == 0
        outs.append(_submission(d))
    want, got = outs
    assert got.keys() == want.keys() == {"vid_t.txt" if split == "test"
                                         else "vid_v.txt"}
    for k in want:
        assert got[k].shape == want[k].shape
        assert got[k].shape[0] == (30 if split == "test" else 36)
        np.testing.assert_allclose(got[k], want[k], rtol=F32_TOL, atol=F32_TOL)


def test_serve_hands_run_server_the_jax_arguments(run, monkeypatch):
    import m3f.pytorch_tpu.infer.server as jserver
    import m3f_torch.infer.server as tserver
    seen = {}
    for mod, name in ((jserver, "jax"), (tserver, "port")):
        def fake(predictor, _name=name, **kw):
            seen[_name] = (predictor, kw)
            return 0
        monkeypatch.setattr(mod, "run_server", fake)
    argv = ["serve", "--checkpoint", run["steps"][-1], "--port", "0",
            "--warmup-frames", "0", "--warmup-fps", "25,24",
            "--max-streams", "3", "--stream-ttl", "7", "--push-timeout", "2",
            "--allow-reload", "--max-body-mb", "9", "--preset", "fusion",
            *narrow(run["root"])]
    assert _run(jmain.main, argv)[0] == 0
    assert _run(tmain.main, argv + ["--device", "cpu"])[0] == 0
    (jp, jkw), (tp, tkw) = seen["jax"], seen["port"]
    assert tkw == jkw
    assert tkw["warmup_rates"] == (25.0, 24.0) and tkw["max_body"] == 9 << 20
    assert tp.cfg.config_hash() == jp.cfg.config_hash()
    assert tp.checkpoint_path == run["steps"][-1]
    from m3f_torch.train.checkpoint import read_model_checkpoint
    sd, step = read_model_checkpoint(run["steps"][-1])
    have = tp.model.state_dict()
    assert step == 2 and all(torch.equal(have[k], v) for k, v in sd.items())


def test_export_writes_the_jax_file(run, tmp_path):
    outs = []
    for main in (jmain.main, tmain.main):
        pt = str(tmp_path / f"{main.__module__}.pt")
        rc, _ = _run(main, ["export", "--format", "torch", "--checkpoint",
                            run["steps"][-1], "--out", pt])
        assert rc == 0
        outs.append(torch.load(pt))
    want, got = outs
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("json_flag", [[], ["--json"]])
def test_inspect_prints_what_the_jax_cli_prints(run, json_flag):
    argv = ["inspect", *json_flag, run["steps"][-1],
            os.path.join(run["ck"], "best.npz")]
    want, got = _run(jmain.main, argv), _run(tmain.main, argv)
    assert got == want
    assert got[0] == 0 and "TrainState" in got[1]


def test_doctor_prints_what_the_jax_cli_prints(run):
    argv = ["doctor", *narrow(run["root"])]
    want, got = _run(jmain.main, argv), _run(tmain.main, argv)
    assert got == want
    assert got[0] == 0 and "1 off-rate" in got[1]
    argv = ["doctor", "--json", "--splits", "train", *narrow(run["root"])]
    assert _run(tmain.main, argv) == _run(jmain.main, argv)


def test_profile_prints_the_trace_summary(tmp_path):
    from test_torch_profiling import _jax_trace, _torch_trace
    _jax_trace(tmp_path / "jax")
    _torch_trace(tmp_path / "torch")
    want = _run(jmain.main, ["profile", str(tmp_path / "jax"), "--top", "4"])
    got = _run(tmain.main, ["profile", str(tmp_path / "torch"), "--top", "4"])
    assert got == want and got[1].count("\n") == 4


def test_refusals(run, monkeypatch, tmp_path):
    base = ["train", "--device", "cpu", *narrow(run["root"]),
            f"train.checkpoint_dir={tmp_path}"]
    # a multi-process launch is ported (tests/test_torch_parallel.py): a
    # group of one through --coordinator trains, resumes from a seed and
    # leaves no group behind; a launch that names no rank, a rank outside
    # its world, and the JAX launchers' variables are refused by name
    import socket
    import torch.distributed as dist
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    ck = str(tmp_path / "group")
    rc, out = _run(tmain.main, [
        "train", "--device", "cpu", "--no-eval", *narrow(run["root"]),
        "train.num_steps=3", "train.log_every=1", f"train.checkpoint_dir={ck}",
        "--resume-from", run["steps"][0],
        "--coordinator", f"127.0.0.1:{port},1,0"])
    assert rc == 0 and "distributed: M3F_COORDINATOR" in out
    assert "step 2/3" in out and "step 1/3" not in out
    assert os.path.exists(os.path.join(ck, "ckpt_00000003.npz"))
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="M3F_COORDINATOR"):
        tmain.main(base + ["--coordinator", "localhost:1234,2,5"])
    for var, value, error in (("M3F_COORDINATOR", "h:1", ValueError),
                              ("JAX_COORDINATOR_ADDRESS", "h:1",
                               NotImplementedError),
                              ("TPU_WORKER_HOSTNAMES", "a,b",
                               NotImplementedError)):
        with monkeypatch.context() as mp:
            mp.setenv(var, value)
            with pytest.raises(error, match=var):
                tmain.main(base)
    with pytest.raises(NotImplementedError, match="stablehlo"):
        tmain.main(["export", "--format", "stablehlo", "--checkpoint",
                    run["steps"][-1], "--out", str(tmp_path / "x")])
    with monkeypatch.context() as mp:
        mp.setenv("M3F_JAX_CACHE", str(tmp_path))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmain.main(["doctor", *narrow(run["root"])])
    # the lane-midplanes variant is no refusal any more: it evaluates
    # (tests/test_torch_backbones.py holds it against the reference)
    got = _eval(tmain.main, run, "--preset", "fusion+lane",
                device=("--device", "cpu"))
    assert np.isfinite(got[-1]["ccc_v"]) and np.isfinite(got[-1]["ccc_a"])
    if not torch.cuda.is_available():
        for cmd in ("train", "eval", "predict", "serve"):
            with pytest.raises(RuntimeError, match="cuda"):
                tmain.main([cmd, *narrow(run["root"]),
                            f"train.checkpoint_dir={tmp_path}"])


def _nan_stream(mod, cfg, windowing, nan_batch=1):
    from importlib import import_module
    synth = import_module(mod + ".data.synthetic")
    ds = synth.SyntheticAVDataset(cfg.data, cfg.model.mel)
    seq = windowing.WindowSequencer(cfg.window, cfg.model.mel, mel_frames=16)
    for i, b in enumerate(windowing.example_stream(ds, seq,
                                                   cfg.train.batch_size)):
        if i == nan_batch:
            b = dict(b, wav=b["wav"].copy())
            b["wav"][0, 0, 100] = np.nan
        yield b


def _nan_cfg(main, debug):
    return main.build_config("fusion", [
        "data.image_size=16", "model.visual.block_channels=[8,16]",
        "model.visual.blocks_per_stage=[1,1]", "model.visual.stem_channels=8",
        "model.visual.feature_dim=16", "model.audio.channels=[4,8]",
        "model.audio.feature_dim=8", "model.gru.hidden_size=8",
        "model.compute_dtype=float32", "window.windows_per_clip=2",
        "train.batch_size=2", "train.mesh.num_data=1", "train.log_every=1",
        "data.synthetic_num_videos=2", "data.synthetic_video_frames=64",
        f"train.debug_nans={'true' if debug else 'false'}"])


def test_debug_nans_raises_in_both_packages():
    from m3f.pytorch_tpu.data import windowing as jwin
    from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
    from m3f_torch.data import windowing as twin
    from m3f_torch.train.loop import Trainer
    jcfg = _nan_cfg(jmain, True)
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            JTrainer(jcfg).fit(_nan_stream("m3f.pytorch_tpu", jcfg, jwin),
                               num_steps=3, log=lambda s: None)
    tcfg = _nan_cfg(tmain, True)
    steps = []
    with pytest.raises(FloatingPointError, match="step 2"):
        Trainer(tcfg, device="cpu").fit(
            _nan_stream("m3f_torch", tcfg, twin), num_steps=3,
            log=steps.append)
    assert len(steps) == 1 and steps[0].startswith("step 1/3")
    tcfg = _nan_cfg(tmain, False)
    _, hist = Trainer(tcfg, device="cpu").fit(
        _nan_stream("m3f_torch", tcfg, twin), num_steps=3, log=lambda s: None)
    assert len(hist["loss"]) == 3 and np.isnan(hist["loss"][1])
