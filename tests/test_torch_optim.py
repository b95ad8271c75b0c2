"""The port's optimizer (m3f_torch/train/optim.py) held against the JAX
package's ``make_optimizer`` (optax) step by step: the same parameters and
the same gradients (numpy, from a seed; scaled so the global-norm clip
triggers on some steps) through several steps, for each optimizer ×
schedule, plus ``freeze`` (bitwise unchanged), ``lr_scale``, the prefix
checks and ``MultiSteps`` accumulation. Both sides compute in fp32; the
parameters are held to 1e-6 relative (summation order of the global norm
and rounding order of the schedules)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import optax

import m3f.pytorch_tpu.config as jc
import m3f_torch.config as tc
from m3f.pytorch_tpu.train.loop import make_optimizer as jmake
from m3f_torch.train.optim import make_optimizer, param_path

SHAPES = {"visual.stem.conv1.weight": (4, 3, 1, 3, 3),
          "visual.blocks.0.bn1.scale": (4,),
          "audio.conv.0.weight": (2, 1, 3, 3),
          "gru.layers.0.fwd.w_hh": (3, 9),
          "head.kernel": (6, 2), "head.bias": (2,)}
STEPS = 7


def _jax_tree(flat):
    """Port names → the nested dict a JAX param tree has (paths equal)."""
    tree = {}
    for n, v in flat.items():
        node = tree
        parts = param_path(n).split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_jax_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _run(optim_kw, num_steps=STEPS, scale=1.0, seed=0):
    rng = np.random.RandomState(seed)
    params = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: (scale * (1 + 3 * (t % 3)) * rng.randn(*s)).astype(np.float32)
              for n, s in SHAPES.items()} for t in range(num_steps)]
    jcfg = jc.OptimConfig(**optim_kw)
    tx = jmake(jcfg, num_steps)
    jp = _jax_tree({n: jnp.asarray(v) for n, v in params.items()})
    js = tx.init(jp)
    port = make_optimizer(tc.OptimConfig(**optim_kw), num_steps)
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    ts = port.init(tp)
    for g in grads:
        u, js = tx.update(_jax_tree({n: jnp.asarray(v) for n, v in g.items()}),
                          js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = port.update({n: torch.from_numpy(v) for n, v in g.items()},
                             ts, tp)
        for n in tp:
            tp[n] = tp[n] + tu[n]
        got = {param_path(n): t.numpy() for n, t in tp.items()}
        want = _jax_flat(jp)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    return params, tp


@pytest.mark.parametrize("schedule,warmup", [("constant", 0), ("constant", 3),
                                             ("cosine", 2), ("step", 0),
                                             ("plateau", 2)])
@pytest.mark.parametrize("optimizer,wd", [("adam", 0.0), ("adam", 0.01),
                                          ("sgd", 0.0)],
                         ids=["adam", "adamw", "sgd"])
def test_optimizer_matches_optax(optimizer, wd, schedule, warmup):
    _run(dict(optimizer=optimizer, weight_decay=wd, schedule=schedule,
              warmup_steps=warmup, learning_rate=3e-2, step_decay_every=2,
              step_decay_factor=0.5, grad_clip_norm=10.0), scale=2.0)


def test_freeze_keeps_params_bitwise_and_lr_scale_scales():
    params, tp = _run(dict(freeze="visual", lr_scale="head=0.5,audio=2.0",
                           weight_decay=0.01, learning_rate=1e-2))
    for n, v in params.items():
        if n.startswith("visual."):
            assert np.array_equal(tp[n].numpy(), v), n
        else:
            assert not np.array_equal(tp[n].numpy(), v), n


@pytest.mark.parametrize("k", [2, 3])
def test_multisteps_accumulation_matches_optax(k):
    _run(dict(accumulate_steps=k, learning_rate=1e-2, schedule="cosine",
              warmup_steps=1), num_steps=3 * k)


@pytest.mark.parametrize("spec,err", [("vizual", "match no"),
                                      ("visual=0.5,visual/stem=2", "overlap"),
                                      ("head", "prefix=factor")])
def test_prefix_checks(spec, err):
    """A prefix matching nothing fails at init, a malformed or overlapping
    lr_scale when the optimizer is made, as in the reference."""
    kw = {"freeze": spec} if "=" not in spec and spec != "head" else {"lr_scale": spec}
    with pytest.raises(ValueError, match=err):
        make_optimizer(tc.OptimConfig(**kw)).init(
            {n: torch.zeros(s) for n, s in SHAPES.items()})


def test_unknown_optimizer_and_schedule_raise():
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(tc.OptimConfig(optimizer="lamb"))
    with pytest.raises(ValueError, match="schedule"):
        make_optimizer(dataclasses.replace(tc.OptimConfig(), schedule="linear"))
