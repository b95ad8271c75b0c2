"""The benchmark is driven by data: every cell's configuration, mix and
metric is a file found by its name, and a new one needs new files only."""

import json
import os
import re
import shutil

import pytest

from portbench import harness, readers, work
from portbench.harness import Run
from portbench_tiny import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_names_and_files():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_metrics(w):
    cell = harness.load_cell(ROOT, w)
    assert os.path.exists(os.path.join(ROOT, "portbench", "runners",
                                       cell.traffic["runner"] + ".py"))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    cfg = harness.program_config(cell)
    m = cell.config["model"]
    assert cfg.model.visual.block_channels == tuple(m["visual"]["block_channels"])
    assert cfg.model.gru.hidden_size == m["gru"]["hidden_size"]
    assert cell.config["reduced"] == []
    assert cell.config["limits"][cell.traffic["runner"]]


def test_a_new_cell_takes_new_files_only(tmp_path):
    """A later cell ``train_r2plus1d18_fp32``: a configuration file, with
    the limits of its own comparison, and BENCHMARK.json entries; the
    runners, readers and mixes stay as they are. It takes every training
    metric but the bf16 units' roofline, whose kernels fp32 does not run."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(tmp_path / "portbench/configs/m3f_r2plus1d18.json") as f:
        conf = json.load(f)
    conf["name"] = "m3f_r2plus1d18_fp32"
    conf["model"]["compute_dtype"] = "float32"
    conf["limits"] = {"train_steps": {"loss_gap": 1e-4, "grad_gap_median": 1e-3,
                                      "change_gap": 0.25}}
    with open(tmp_path / "portbench/configs/m3f_r2plus1d18_fp32.json", "w") as f:
        json.dump(conf, f)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "m3f_r2plus1d18_fp32",
                             "source": conf["source"], "reduced": [],
                             "file": "portbench/configs/m3f_r2plus1d18_fp32.json",
                             "why": "fp32"})
    bench["workloads"].append({"name": "train_r2plus1d18_fp32",
                               "config": "m3f_r2plus1d18_fp32",
                               "traffic": "train_b32_w4", "chips": 1,
                               "why": "fp32 training"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if ("train_r2plus1d18_b32" in m.get("workloads", ())
                and m["name"] != "conv_units_roofline.train"):
            m["workloads"].append("train_r2plus1d18_fp32")
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    cell = harness.load_cell(str(tmp_path), "train_r2plus1d18_fp32")
    assert harness.program_config(cell).model.compute_dtype == "float32"
    assert harness.checks({"loss_gap": 0.0, "grad_gap_median": 0.0,
                           "change_gap": 0.0}, cell)["loss_gap"]["limit"] == 1e-4
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in harness.load_cell(ROOT, "train_r2plus1d18_b32").per_layer
    } - {"conv_units_roofline.train"}
    run = Run(setup_s=1.0, window_s=10.0, attempted=1, failed=0,
              memory_peak=0, e2e={}, checks={}, model=cell.config["model"],
              counts={"steps": 1, "clips_per_step": 128})
    assert readers.mfu_train(run) == pytest.approx(
        100.0 * 128 * work.train_clip_flops(run.model, 16, 112) / 10.0 / 67e12)
