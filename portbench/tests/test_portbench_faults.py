"""A run with the timed path broken underneath must come out not correct.

Each test drives the rest of a run (the runner's set-up, window and
comparison, at a tiny width on the CPU, in float32, where a sound run
passes) with one fault planted in the program: an answer altered where it
is produced, a serving forward that leaves half of its batch out, a train
step that leaves its state unchanged, a train step whose loss leaves half
of the batch out."""

import numpy as np
import pytest

from m3f_torch.models.m3f import M3F
from m3f_torch.train import loop, optim
from portbench_tiny import cell, run


def test_sound_runs_are_correct():
    assert run(cell("serve")).correct
    assert run(cell("train")).correct


def test_an_altered_answer_is_caught(monkeypatch):
    orig = loop.Trainer._collect_eval

    def altered(self, pending):
        out = orig(self, pending)
        out["pred"] = out["pred"].copy()
        out["pred"][len(out["pred"]) // 2] += 0.2
        return out
    monkeypatch.setattr(loop.Trainer, "_collect_eval", altered)
    assert not run(cell("serve")).correct


def test_half_of_a_serving_batch_left_out_is_caught(monkeypatch):
    orig = M3F.forward

    def half(self, *args, **kw):
        out = orig(self, *args, **kw).clone()
        out[(len(out) + 1) // 2:] = 0.0
        return out
    monkeypatch.setattr(M3F, "forward", half)
    assert not run(cell("serve")).correct


def test_a_step_that_leaves_its_state_unchanged_is_caught(monkeypatch):
    orig = optim.Optimizer.update

    def still(self, grads, state, params):
        upd, new = orig(self, grads, state, params)
        return {n: u * 0.0 for n, u in upd.items()}, new
    monkeypatch.setattr(optim.Optimizer, "update", still)
    r = run(cell("train"))
    assert r.checks["change_gap"]["value"] == pytest.approx(1.0)
    assert not r.correct


def test_half_the_batch_left_out_is_caught(monkeypatch):
    orig = loop.Trainer._loss_fn

    def half(self, batch, generator=None):
        _, preds = orig(self, batch, generator)
        n = len(batch["labels"]) // 2
        return self.loss_fn(preds[:n], batch["labels"][:n],
                            batch["mask"][:n]), preds
    monkeypatch.setattr(loop.Trainer, "_loss_fn", half)
    r = run(cell("train"))
    assert not r.correct
    assert np.isfinite(r.host["readings"]["loss_gap"])
