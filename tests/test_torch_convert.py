"""The port's weight converter (``m3f_torch/train/convert.py``) and its
checkpoint scripts (``m3f_torch/scripts/{import,export}_torch_checkpoint``,
``average_checkpoints``) against the JAX package's converter and
``scripts/``: on a random reference-schema state_dict every converted,
exported, imported, re-exported and averaged array is equal; the imported
file loads into the port's model, and a round trip gives the state_dict
back."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

from m3f.pytorch_tpu import config as jconfig
from m3f.pytorch_tpu.models.m3f import M3F as JM3F
from m3f.pytorch_tpu.train import convert as jconv

from m3f_torch import config as tconfig
from m3f_torch.models.m3f import M3F
from m3f_torch.scripts import average_checkpoints as tavg
from m3f_torch.scripts import export_torch_checkpoint as texp
from m3f_torch.scripts import import_torch_checkpoint as timp
from m3f_torch.train import convert as tconv
from m3f_torch.train.checkpoint import (Checkpointer, _flatten,
                                        read_model_checkpoint)
from m3f_torch.train.loop import Trainer

REPO = Path(__file__).resolve().parents[1]


def _model_cfg(mod, **kw):
    return mod.ModelConfig(
        audio=mod.AudioNetConfig(channels=(4, 8, 8, 16), feature_dim=8),
        visual=mod.VisualNetConfig(block_channels=(8, 16),
                                   blocks_per_stage=(2, 1),
                                   stem_channels=8, feature_dim=16),
        gru=mod.GRUConfig(hidden_size=8, **kw))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", params=[1, 2], ids=["gru1", "gru2"])
def state_dict(request):
    """A reference-schema state_dict with random values (the JAX export of
    a narrow model's init, every array redrawn)."""
    cfg = _model_cfg(jconfig, num_layers=request.param)
    params, state = JM3F(cfg).init(jax.random.PRNGKey(0))
    sd = jconv.export_m3f(params, state)
    rng = np.random.RandomState(request.param)
    return {k: (np.asarray(v) if v.dtype == np.int64 else
                rng.randn(*v.shape).astype(np.float32))
            for k, v in sd.items()}


def _equal_trees(got, want):
    g, w = _flatten(got), _flatten(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_convert_and_export_equal(state_dict):
    sd = state_dict
    assert tconv.detect_visual_mode(sd, "visual") \
        == jconv.detect_visual_mode(sd, "visual") == "2plus1d"
    assert tconv.detect_blocks_per_stage(sd, "visual") \
        == jconv.detect_blocks_per_stage(sd, "visual") == (2, 1)
    assert tconv.detect_gru_layers(sd, "gru") == jconv.detect_gru_layers(sd, "gru")
    tp, ts = tconv.convert_m3f(sd)
    jp, js = jconv.convert_m3f(sd)
    _equal_trees(tp, jax.device_get(jp))
    _equal_trees(ts, jax.device_get(js))
    back = tconv.export_m3f(tp, ts)
    want = jconv.export_m3f(jp, js)
    assert back.keys() == want.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    vis = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    _equal_trees(tconv.convert_r2plus1d(vis), jax.device_get(jconv.convert_r2plus1d(vis)))
    aud = {k[len("audio."):]: v for k, v in sd.items() if k.startswith("audio.")}
    _equal_trees(tconv.convert_audio_cnn(aud), jax.device_get(jconv.convert_audio_cnn(aud)))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_npz(got_path, want_path):
    got, want = _npz(got_path), _npz(want_path)
    assert got.keys() == want.keys()
    for k in want:
        if k == "__meta__":
            assert json.loads(bytes(got[k])) == json.loads(bytes(want[k]))
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind,prefix", [("m3f", ""), ("r2plus1d", "visual."),
                                         ("audio_cnn", "audio.")])
def test_import_script_writes_the_jax_scripts_file(tmp_path, state_dict, kind,
                                                   prefix):
    pt = str(tmp_path / "model.pth")
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v))
                               for k, v in state_dict.items()}}, pt)
    want, got = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    args = ["--kind", kind] + (["--prefix", prefix] if prefix else [])
    assert _script("import_torch_checkpoint").main([pt, want] + args) == 0
    assert timp.main([pt, got] + args) == 0
    _same_npz(got, want)
    if kind == "m3f":
        # the imported file is the port model's weights
        m = M3F(_model_cfg(tconfig, num_layers=tconv.detect_gru_layers(
            state_dict, "gru")), device="cpu")
        sd, step = read_model_checkpoint(got)
        m.load_state_dict(sd)
        assert step == 0


def test_export_script_equal(tmp_path, state_dict):
    pt = str(tmp_path / "model.pth")
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in state_dict.items()}, pt)
    npz = str(tmp_path / "imported.npz")
    assert timp.main([pt, npz, "--kind", "m3f"]) == 0
    want, got = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    assert _script("export_torch_checkpoint").main([npz, want]) == 0
    assert texp.main([npz, got]) == 0
    w, g = torch.load(want), torch.load(got)
    assert g.keys() == w.keys() == state_dict.keys()
    for k in w:
        assert torch.equal(g[k], w[k]), k
        np.testing.assert_array_equal(g[k].numpy(), state_dict[k])


def _checkpoints(tmp_path, ema):
    cfg = tconfig.ExperimentConfig(
        name="c", model=_model_cfg(tconfig),
        data=tconfig.DataConfig(image_size=16),
        train=tconfig.TrainConfig(batch_size=2, ema_decay=ema,
                                  mesh=tconfig.MeshConfig(num_data=1)))
    tr = Trainer(cfg, device="cpu")
    ck = Checkpointer(str(tmp_path / "ck"), keep=5, cfg=cfg)
    paths = []
    for seed in (0, 1, 2):
        st = tr.init_state(seed=seed)
        st.step = seed + 1
        if st.ema is not None:
            st.ema = {n: t + 0.5 * seed for n, t in st.ema.items()}
        paths.append(ck.save(st))
    return paths


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_average_and_export_of_trainer_checkpoints(tmp_path, ema):
    paths = _checkpoints(tmp_path, ema)
    want, got = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    assert _script("average_checkpoints").main(paths + ["--out", want]) == 0
    assert tavg.main(paths + ["--out", got]) == 0
    _same_npz(got, want)
    wpt, gpt = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    assert _script("export_torch_checkpoint").main([paths[-1], wpt]) == 0
    assert texp.main([paths[-1], gpt]) == 0
    w, g = torch.load(wpt), torch.load(gpt)
    assert g.keys() == w.keys()
    assert all(torch.equal(g[k], w[k]) for k in w)
    with pytest.raises(SystemExit):
        tavg.main(paths[:1] + ["--out", got])
