"""``model.init_from`` in the port (``load_pretrained_init`` in
``m3f_torch/train/checkpoint.py``, applied by ``Trainer.init_state``)
against the JAX package's ``load_pretrained_init``, on import-script files
written by the JAX package's ``save_pytree`` from a seeded JAX model:

- each ``kind`` (``m3f``, ``r2plus1d``, ``audio_cnn``) and a file without
  one (the kind inferred from its keys) fills what the reference fills,
  bit for bit, and leaves every other tensor as it was;
- a branch the model lacks, a missing leaf and an extra leaf are refused;
- ``fit`` starts from the file; a checkpoint restore wins over it;
- ``init_from`` with ``keep_weights=True`` is refused.
"""

import numpy as np
import pytest
import torch
import jax

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.models.m3f import M3F as JM3F
from m3f.pytorch_tpu.train.checkpoint import load_pretrained_init as jinit
from m3f.pytorch_tpu.train.checkpoint import save_pytree as jsave
from m3f_torch.data.synthetic import SyntheticAVDataset
from m3f_torch.data.windowing import WindowSequencer, example_stream
from m3f_torch.train.checkpoint import (Checkpointer, from_jax_params,
                                        load_pretrained_init)
from m3f_torch.train.loop import Trainer

# kind → (the file's subtree of the JAX model, the port's name prefix)
KINDS = {"m3f": (None, ""), "r2plus1d": ("visual", "visual."),
         "audio_cnn": ("audio", "audio.")}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(mod, use_video=True, init_from="", **train):
    base = dict(batch_size=2, num_steps=2, log_every=1, eval_every=0,
                checkpoint_every=2, mesh=mod.MeshConfig(num_data=1))
    base.update(train)
    return mod.ExperimentConfig(
        name="init_from",
        model=mod.ModelConfig(
            use_video=use_video,
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            visual=mod.VisualNetConfig(block_channels=(8, 16),
                                       blocks_per_stage=(2, 1),
                                       stem_channels=8, feature_dim=16),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype="float32",
            init_from=init_from),
        window=mod.WindowConfig(windows_per_clip=2),
        data=mod.DataConfig(synthetic_num_videos=2, synthetic_video_frames=64,
                            image_size=32),
        train=mod.TrainConfig(**base))


def _host(tree):
    return jax.device_get(tree)


def _write(tmp_path, kind, seed=5, meta=True, use_video=True):
    """An import-script file of ``kind`` from a JAX model seeded ``seed``."""
    params, state = JM3F(_cfg(jc, use_video).model).init(
        jax.random.PRNGKey(seed))
    sub = KINDS[kind][0]
    tree = ({"params": params, "state": state} if sub is None else
            {"params": params[sub], "state": state[sub]})
    path = str(tmp_path / f"{kind}_{seed}_{meta}.npz")
    jsave(_host(tree), path, {"kind": kind} if meta else None)
    return path


@pytest.mark.parametrize("meta", [True, False], ids=["kind", "inferred"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_each_kind_fills_what_the_reference_fills(tmp_path, kind, meta):
    path = _write(tmp_path, kind, meta=meta)
    p0, s0 = JM3F(_cfg(jc).model).init(jax.random.PRNGKey(0))
    jp, js = jinit(_host(p0), _host(s0), path)
    template = from_jax_params(_host(p0), _host(s0))
    got = load_pretrained_init(template, path)
    want = from_jax_params(_host(jp), _host(js))
    assert got.keys() == want.keys() == template.keys()
    prefix = KINDS[kind][1]
    for n, t in got.items():
        assert torch.equal(t, want[n]), n
        if not n.startswith(prefix):
            assert torch.equal(t, template[n]), n
    # the file's weights (seed 5) are not the template's (seed 0)
    kernel = next(n for n in got if n.startswith(prefix)
                  and n.endswith(("kernel", "weight")))
    assert not torch.equal(got[kernel], template[kernel])


def test_a_branch_the_model_lacks_is_refused(tmp_path):
    path = _write(tmp_path, "r2plus1d")
    p0, s0 = JM3F(_cfg(jc, use_video=False).model).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="visual"):
        jinit(_host(p0), _host(s0), path)
    template = from_jax_params(_host(p0), _host(s0))
    with pytest.raises(ValueError, match="branch 'visual'"):
        load_pretrained_init(template, path)


@pytest.mark.parametrize("fault", ["missing", "extra", "stray"])
def test_missing_or_extra_leaves_are_refused(tmp_path, fault):
    path = _write(tmp_path, "audio_cnn")
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    key = next(k for k in data if k.startswith("params/"))
    if fault == "missing":
        del data[key]
    elif fault == "extra":
        data[key + "_more"] = data[key]
    else:
        data["opt_state/count"] = np.zeros((), np.int32)
    np.savez(tmp_path / "bad.npz", **data)
    bad = str(tmp_path / "bad.npz")
    p0, s0 = JM3F(_cfg(jc).model).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="mismatch"):
        jinit(_host(p0), _host(s0), bad)
    with pytest.raises(ValueError, match="mismatch"):
        load_pretrained_init(from_jax_params(_host(p0), _host(s0)), bad)


def _factory(cfg):
    ds = SyntheticAVDataset(cfg.data, cfg.model.mel)
    seq = WindowSequencer(cfg.window, cfg.model.mel, mel_frames=16)
    return lambda skip: example_stream(ds, seq, cfg.train.batch_size, seed=0,
                                       skip_batches=skip)


def test_init_state_and_fit_start_from_the_file(tmp_path):
    """The seeded init, then the file's branch: ``visual.*`` is the file's,
    every other tensor the seed's; a fit from it equals a fit with
    ``keep_weights=True`` from the same weights loaded by hand."""
    path = _write(tmp_path, "r2plus1d")
    tr = Trainer(_cfg(tc, init_from=path), device="cpu")
    state = tr.init_state()
    seeded = Trainer(_cfg(tc), device="cpu").model.state_dict()
    p, s = JM3F(_cfg(jc).model).init(jax.random.PRNGKey(5))
    filed = from_jax_params(_host(p["visual"]), _host(s["visual"]))
    for n, t in {**state.params, **state.bn_state}.items():
        if n.startswith("visual."):
            assert torch.equal(t, filed[n[len("visual."):]]), n
        else:
            assert torch.equal(t, seeded[n]), n
    start = {n: t.clone() for n, t in tr.model.state_dict().items()}
    got, hist = tr.fit(_factory(tr.cfg), log=lambda s: None)
    ref = Trainer(_cfg(tc), device="cpu")
    ref.model.load_state_dict(start)
    want, hist_ref = ref.fit(_factory(ref.cfg), log=lambda s: None,
                             keep_weights=True)
    assert hist["loss"] == hist_ref["loss"]
    for n, t in got.params.items():
        assert torch.equal(t, want.params[n]), n


def test_a_checkpoint_restore_wins_over_the_file(tmp_path):
    first = _cfg(tc, init_from=_write(tmp_path, "m3f", seed=5))
    ck = Checkpointer(str(tmp_path / "run"), keep=2, cfg=first)
    done, _ = Trainer(first, device="cpu").fit(_factory(first),
                                               log=lambda s: None,
                                               checkpointer=ck)
    trained = {n: t.clone() for n, t in done.params.items()}
    # another init file: its config hash leaves init_from out, as the
    # reference's does, so the run directory resumes
    other = _cfg(tc, init_from=_write(tmp_path, "m3f", seed=6))
    tr = Trainer(other, device="cpu")
    state, hist = tr.fit(_factory(other), log=lambda s: None,
                         checkpointer=Checkpointer(str(tmp_path / "run"),
                                                   keep=2, cfg=other))
    assert state.step == 2 and hist["loss"] == []
    for n, t in state.params.items():
        assert torch.equal(t, trained[n]), n


def test_init_from_with_keep_weights_is_refused(tmp_path):
    tr = Trainer(_cfg(tc, init_from=_write(tmp_path, "m3f")), device="cpu")
    with pytest.raises(ValueError, match="init_from.*keep_weights"):
        tr.init_state(keep_weights=True)
    with pytest.raises(ValueError, match="init_from.*keep_weights"):
        tr.fit(_factory(tr.cfg), log=lambda s: None, keep_weights=True)
