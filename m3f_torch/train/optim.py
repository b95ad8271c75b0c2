"""The optimizer: a small functional mirror of the reference's optax chain.

Counterpart of ``make_optimizer`` in ``m3f/pytorch_tpu/train/loop.py``:

    clip_by_global_norm → adam | adamw | sgd(momentum 0.9) with the
    learning-rate schedule → lr_scale masks → freeze mask [→ MultiSteps]

Each transform follows optax's formulas and order of operations in fp32
(``tests/test_torch_optim.py`` holds it against optax step by step): the
clip is optax's ``g / ‖g‖ · max`` when ``‖g‖ ≥ max`` (no ``+1e-6``), Adam's
bias correction divides the moments, the schedule counts applied updates,
and ``MultiSteps`` keeps the running mean of the micro-step gradients and
applies the inner chain every k-th step. The state is a plain dict of
tensors and ints, checkpointed under ``.opt_state/`` in the layout of the
reference's optax state (``train/checkpoint.py`` ``_optax_leaves``).

Parameters are addressed by their ``/``-joined reference path (the port's
``visual.stem.conv1.weight`` is ``visual/stem/conv1/weight``), so ``freeze``
and ``lr_scale`` prefixes are the reference's.

Under tensor parallelism (``tp``, ``parallel/mesh.py``) a sharded
parameter's gradient, moments and accumulator are this rank's blocks; every
transform is elementwise except the clip's global norm, which adds the
blocks' squares over the model axis (``global_norm``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from m3f_torch.config import OptimConfig
from m3f_torch.parallel.mesh import TensorParallel, axis_sum

Tensors = Dict[str, torch.Tensor]

B1, B2, EPS = 0.9, 0.999, 1e-8        # optax.adam defaults
MOMENTUM = 0.9


def param_path(name: str) -> str:
    """The reference's '/'-joined tree path of a port parameter name."""
    return name.replace(".", "/")


def prefix_match(names: List[str], prefixes: Tuple[str, ...]) -> Dict[str, bool]:
    """name → True iff its path equals or is nested under a prefix; a prefix
    matching nothing raises (catches typos before a run fine-tunes the
    wrong subtree)."""
    hits = {p: 0 for p in prefixes}
    out = {}
    for n in names:
        key = param_path(n)
        m = False
        for p in prefixes:
            if key == p or key.startswith(p + "/"):
                m = True
                hits[p] += 1
        out[n] = m
    missing = sorted(p for p, c in hits.items() if c == 0)
    if missing:
        tops = sorted({param_path(n).split("/")[0] for n in names})
        raise ValueError(
            f"optim.freeze/lr_scale prefix(es) {missing} match no "
            f"parameter; top-level param groups are {tops}")
    return out


def parse_lr_scales(spec: str) -> Tuple[Tuple[str, float], ...]:
    """Parse "visual=0.1,head=2.0"; overlapping prefixes are refused."""
    pairs = []
    for item in (s for s in spec.split(",") if s.strip()):
        prefix, sep, factor = item.partition("=")
        if not sep:
            raise ValueError(
                f"optim.lr_scale entry {item!r} is not 'prefix=factor'")
        pairs.append((prefix.strip(), float(factor)))
    names = [p for p, _ in pairs]
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            if a == b or a.startswith(b + "/") or b.startswith(a + "/"):
                raise ValueError(
                    f"optim.lr_scale prefixes {a!r} and {b!r} overlap — "
                    "a param under both would be scaled twice")
    return tuple(pairs)


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def make_schedule(cfg: OptimConfig, num_steps: int) -> Callable[[int], torch.Tensor]:
    """count → fp32 learning rate, optax's schedules in fp32."""
    lr = cfg.learning_rate

    def linear(count: int, steps: int) -> torch.Tensor:
        # optax.linear_schedule(0, lr, steps)
        frac = 1.0 - _f32(min(max(count, 0), steps)) / _f32(steps)
        return -_f32(lr) * frac + _f32(lr)

    if cfg.schedule == "cosine":
        warm = max(cfg.warmup_steps, 1)
        decay = max(num_steps, cfg.warmup_steps + 1) - warm

        def sched(count: int) -> torch.Tensor:
            if count < warm:
                return linear(count, warm)
            c = _f32(min(float(count - warm), float(decay)))
            cos = 0.5 * (1 + torch.cos(_f32(math.pi) * c / _f32(float(decay))))
            return _f32(lr) * cos
        return sched
    if cfg.schedule == "step":
        every = cfg.step_decay_every or max(num_steps // 3, 1)
        bounds = list(range(every, num_steps, every))

        def sched(count: int) -> torch.Tensor:
            v = _f32(lr)
            for b in bounds:
                if count >= b:
                    v = _f32(cfg.step_decay_factor) * v
            return v
        return sched
    if cfg.schedule in ("constant", "plateau"):
        if cfg.warmup_steps:
            return lambda count: linear(count, cfg.warmup_steps)
        return lambda count: _f32(lr)
    raise ValueError(f"unknown optim.schedule {cfg.schedule!r} "
                     "(know: constant, cosine, step, plateau)")


def global_norm(tensors: Tensors,
                tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm) of
    ``tensors`` (by parameter name). Under the tensor-parallel layout
    ``tp`` a sharded leaf's squares are summed over the model axis and a
    replicated one's counted once, so the norm is the whole state's, the
    same on every rank."""
    sq = lambda t: torch.sum(t.float() * t.float())
    if tp is None:
        return torch.sqrt(sum(sq(t) for t in tensors.values()))
    whole = [sq(t) for n, t in tensors.items() if not tp.sharded(n)]
    blocks = [sq(t) for n, t in tensors.items() if tp.sharded(n)]
    return torch.sqrt(sum(whole) + axis_sum(sum(blocks), tp.axis))


class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``; updates are applied with ``p += u``."""

    def __init__(self, cfg: OptimConfig, num_steps: int = 100_000,
                 tp: Optional[TensorParallel] = None):
        if cfg.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg, num_steps)
        # a constant rate is optax's scale(-lr), without a schedule count
        self.scheduled = cfg.schedule in ("cosine", "step") or \
            (cfg.schedule in ("constant", "plateau") and cfg.warmup_steps > 0)
        self.lr_scales = parse_lr_scales(cfg.lr_scale)
        self.freeze = tuple(s.strip() for s in cfg.freeze.split(",") if s.strip())
        self.k = cfg.accumulate_steps
        self.tp = tp
        self._masks: Dict[str, Dict[str, bool]] = {}

    # -- state --------------------------------------------------------------

    def init(self, params: Tensors) -> dict:
        names = list(params)
        for prefix, _ in self.lr_scales:
            self._masks[f"scale:{prefix}"] = prefix_match(names, (prefix,))
        if self.freeze:
            self._masks["freeze"] = prefix_match(names, self.freeze)
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        inner = {"count": 0}
        if self.cfg.optimizer == "adam":
            inner.update(mu=zeros(), nu=zeros())
        else:
            inner["trace"] = zeros()
        if self.scheduled:
            inner["schedule_count"] = 0
        if self.k > 1:
            return {"mini_step": 0, "gradient_step": 0, "acc": zeros(),
                    "inner": inner}
        return inner

    # -- update -------------------------------------------------------------

    def _inner(self, grads: Tensors, st: dict, params: Tensors):
        cfg = self.cfg
        gn = global_norm(grads, self.tp)
        if not bool(gn < cfg.grad_clip_norm):
            grads = {n: (g / gn) * cfg.grad_clip_norm for n, g in grads.items()}
        new = dict(st)
        count = st["count"] + 1
        new["count"] = count
        if cfg.optimizer == "adam":
            mu = {n: (1 - B1) * g + B1 * st["mu"][n] for n, g in grads.items()}
            nu = {n: (1 - B2) * (g * g) + B2 * st["nu"][n] for n, g in grads.items()}
            c1 = 1 - _f32(B1) ** count
            c2 = 1 - _f32(B2) ** count
            upd = {n: (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + EPS) for n in grads}
            if cfg.weight_decay:
                upd = {n: u + cfg.weight_decay * params[n] for n, u in upd.items()}
            new["mu"], new["nu"] = mu, nu
        else:
            upd = {n: g + MOMENTUM * st["trace"][n] for n, g in grads.items()}
            new["trace"] = upd
        if self.scheduled:
            lr = self.schedule(st["schedule_count"])
            new["schedule_count"] = st["schedule_count"] + 1
            upd = {n: -lr.to(u.device) * u for n, u in upd.items()}
        else:
            upd = {n: (-cfg.learning_rate) * u for n, u in upd.items()}
        for prefix, factor in self.lr_scales:
            mask = self._masks[f"scale:{prefix}"]
            upd = {n: factor * u if mask[n] else u for n, u in upd.items()}
        if self.freeze:
            mask = self._masks["freeze"]
            upd = {n: torch.zeros_like(u) if mask[n] else u for n, u in upd.items()}
        return upd, new

    def update(self, grads: Tensors, state: dict, params: Tensors):
        if self.k <= 1:
            return self._inner(grads, state, params)
        n_acc = state["mini_step"]
        acc = {n: a + (grads[n] - a) / (n_acc + 1) for n, a in state["acc"].items()}
        if n_acc == self.k - 1:
            upd, inner = self._inner(acc, state["inner"], params)
            return upd, {"mini_step": 0,
                         "gradient_step": state["gradient_step"] + 1,
                         "acc": {n: torch.zeros_like(a) for n, a in acc.items()},
                         "inner": inner}
        return ({n: torch.zeros_like(g) for n, g in grads.items()},
                {"mini_step": n_acc + 1,
                 "gradient_step": state["gradient_step"], "acc": acc,
                 "inner": state["inner"]})


def make_optimizer(cfg: OptimConfig, num_steps: int = 100_000,
                   tp: Optional[TensorParallel] = None) -> Optimizer:
    return Optimizer(cfg, num_steps, tp)
