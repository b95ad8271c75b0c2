"""The port's metric files (``m3f_torch/utils/logging.py``) against the JAX
package's ``MetricWriter``: the same JSONL rows (apart from ``time``) and the
same CSV, through a header growth and a resumed run; ``console_log`` on
rank 0; and ``Trainer.fit(metric_writer=)`` writing the rows the reference's
``fit`` writes, at the same steps, on the same weights and stream."""

import csv
import json

import numpy as np
import pytest
import torch
import jax

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.data.synthetic import SyntheticAVDataset as JDS
from m3f.pytorch_tpu.data.windowing import WindowSequencer as JSeq
from m3f.pytorch_tpu.data.windowing import example_stream as jstream
from m3f.pytorch_tpu.train.loop import Trainer as JTrainer
from m3f.pytorch_tpu.utils.logging import MetricWriter as JWriter
from m3f_torch.data.synthetic import SyntheticAVDataset
from m3f_torch.data.windowing import WindowSequencer, example_stream
from m3f_torch.train.checkpoint import from_jax_params
from m3f_torch.train.loop import Trainer
from m3f_torch.utils.logging import MetricWriter, console_log, process_index


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rows(directory, name="train"):
    """(JSONL rows without ``time``, CSV header, CSV rows without ``time``)."""
    with open(directory / f"{name}.jsonl") as f:
        rows = [json.loads(line) for line in f]
    with open(directory / f"{name}.csv", newline="") as f:
        reader = csv.DictReader(f)
        header = list(reader.fieldnames)
        table = [r for r in reader]
    for r in rows + table:
        r.pop("time")
    return rows, header, table


# train rows, then eval rows with new keys (the header grows), then a row
# with keys of both
SESSIONS = [[(1, {"loss": 0.5, "grad_norm": 2.0}),
             (2, {"loss": np.float32(0.25), "grad_norm": 1.5}),
             (2, {"eval_ccc_v": 0.125, "eval_ccc_a": -0.5})],
            [(3, {"loss": 0.2, "clips_per_sec": 31.5}),
             (4, {"eval_ccc_v": 0.3, "loss": 0.1, "new_key": 7})]]


@pytest.mark.parametrize("tensorboard", [False, True])
def test_rows_match_the_reference_through_growth_and_resume(tmp_path,
                                                            tensorboard):
    for cls, d in ((MetricWriter, tmp_path / "port"), (JWriter, tmp_path / "jax")):
        for session in SESSIONS:           # the second session resumes
            w = cls(str(d), tensorboard=tensorboard)
            for step, metrics in session:
                w.write(step, metrics)
            w.close()
    port, jax_ = _rows(tmp_path / "port"), _rows(tmp_path / "jax")
    assert port == jax_
    rows, header, table = port
    assert [r["step"] for r in rows] == [1, 2, 2, 3, 4]
    assert header == ["step", "time", "loss", "grad_norm", "eval_ccc_v",
                      "eval_ccc_a", "clips_per_sec", "new_key"]
    assert len(table) == 5 and table[0]["eval_ccc_v"] == ""
    assert (tmp_path / "port" / "tb").exists() == \
        (tmp_path / "jax" / "tb").exists()


def test_console_log_prints_on_rank_zero(capsys):
    assert process_index() == 0
    console_log("step 1/2 loss=0.5")
    assert capsys.readouterr().out == "step 1/2 loss=0.5\n"


def _cfg(mod):
    return mod.ExperimentConfig(
        name="log",
        model=mod.ModelConfig(
            use_audio=True, use_video=False,
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype="float32"),
        window=mod.WindowConfig(windows_per_clip=2, eval_stride=8),
        data=mod.DataConfig(synthetic_num_videos=2, synthetic_video_frames=64,
                            image_size=16),
        train=mod.TrainConfig(batch_size=2, num_steps=4, log_every=2,
                              eval_every=2, checkpoint_every=0,
                              mesh=mod.MeshConfig(num_data=1)))


def test_fit_writes_the_reference_rows(tmp_path):
    jcfg, tcfg = _cfg(jc), _cfg(tc)
    jt = JTrainer(jcfg)
    jds = JDS(jcfg.data, jcfg.model.mel)
    jw = JWriter(str(tmp_path / "jax"), tensorboard=False)
    with jax.default_matmul_precision("highest"):
        jt.fit(jstream(jds, JSeq(jcfg.window, jcfg.model.mel, mel_frames=16),
                       2, seed=0), val_dataset=jds, log=lambda s: None,
               metric_writer=jw)
    jw.close()
    js = jax.device_get(jt.init_state())
    tr = Trainer(tcfg, device="cpu")
    tr.model.load_state_dict(from_jax_params(js.params, js.bn_state))
    tds = SyntheticAVDataset(tcfg.data, tcfg.model.mel)
    w = MetricWriter(str(tmp_path / "port"), tensorboard=False)
    tr.fit(example_stream(tds, WindowSequencer(tcfg.window, tcfg.model.mel,
                                               mel_frames=16), 2, seed=0),
           val_dataset=tds, log=lambda s: None, metric_writer=w,
           keep_weights=True)
    w.close()
    got, header, _ = _rows(tmp_path / "port")
    want, jheader, _ = _rows(tmp_path / "jax")
    assert header == jheader
    assert [(r["step"], sorted(r)) for r in got] == \
        [(r["step"], sorted(r)) for r in want]
    assert [r["step"] for r in got] == [2, 2, 4, 4]
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-5)
    for g, r in zip(got, want):
        for k in r:
            if k not in ("step", "clips_per_sec"):
                np.testing.assert_allclose(g[k], r[k], rtol=1e-3, atol=1e-3,
                                           err_msg=k)
