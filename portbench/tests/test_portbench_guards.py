"""The run's guards: no card, JAX loaded, a checkout without the program,
files only under the temporary directory, seeds past 32 bits."""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import types

import torch

from portbench import devtrace, harness
from portbench import run as prun
from portbench_tiny import ROOT

CMD = [sys.executable, "portbench/run.py", "--workload",
       "serve_r2plus1d18_videos", "--seed", "1", "--seconds", "1",
       "--trace", "0"]


def test_no_card_exits_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(CMD, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from portbench import harness;"
            "c = harness.load_cell('.', 'serve_r2plus1d18_videos');"
            "harness.runner(c.traffic['runner']).run(c, 1, 1.0, False, 0.0,"
            " device='cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "m3f_torch" in p.stderr
    p = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import m3f_torch  # noqa: F401
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "m3f", raising=False)
    for k in [k for k in sys.modules if k.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, k)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "m3f.pytorch_tpu", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["jax", "m3f"]


def test_jax_loaded_after_the_window_prints_no_result(monkeypatch, capsys):
    for k in [k for k in sys.modules if k.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, k)
    cell = harness.load_cell(ROOT, "serve_r2plus1d18_videos")
    fake = harness.Run(setup_s=1.0, window_s=1.0, attempted=1, failed=0,
                       memory_peak=0, e2e={"serve_frames_per_s": 1.0},
                       checks={}, model=cell.config["model"])

    def drive(*a):
        sys.modules["jax"] = types.ModuleType("jax")
        return fake
    monkeypatch.setattr(harness, "require_cards", lambda chips: None)
    monkeypatch.setattr(harness, "runner",
                        lambda name: types.SimpleNamespace(run=drive))
    monkeypatch.chdir(ROOT)
    try:
        assert prun.main(["--workload", "serve_r2plus1d18_videos", "--seed",
                          "1", "--seconds", "1"]) == 3
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert out.out.strip() == "" and "jax" in out.err


def test_the_trace_lives_under_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with devtrace.profiled(True) as prof:
        torch.ones(64).sum()
    assert prof.trace is not None
    assert not list(tmp_path.rglob("*.json"))      # the trace was removed


def test_seeds_past_32_bits_are_steady():
    big = 2 ** 31 + 7
    assert harness.sub_seed(big, "a") == harness.sub_seed(big, "a")
    assert harness.sub_seed(big, "a") != harness.sub_seed(big + 1, "a")
    assert 0 <= harness.sub_seed(2 ** 40, "b") < 2 ** 63
    shapes = {"head.kernel": (4, 2), "head.bias": (2,)}
    a = harness.make_weights(shapes, big, "cpu")
    b = harness.make_weights(shapes, big, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)


def test_result_line_keys_and_order():
    cell = harness.load_cell(ROOT, "serve_r2plus1d18_videos")
    run = harness.Run(setup_s=2.0, window_s=1.0, attempted=3, failed=0,
                      memory_peak=5, e2e={"serve_frames_per_s": 10.0},
                      checks={"pred_max_gap": {"value": 0.1, "limit": 0.2}},
                      model=cell.config["model"])
    orig = harness.device_line
    harness.device_line = lambda chips, peak: {"platform": "gpu"}
    try:
        out = prun.report(cell, run, traced=False)
    finally:
        harness.device_line = orig
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True
    assert set(out["metrics"]) == {"serve_frames_per_s", "setup_s"}
    json.dumps(out)
