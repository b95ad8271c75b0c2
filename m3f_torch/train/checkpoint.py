"""Checkpoints: atomic, preemption-aware, and readable by the JAX package.

Counterpart of ``m3f/pytorch_tpu/train/checkpoint.py``. A checkpoint is one
``.npz`` of leaves keyed by their ``/``-joined tree path plus a JSON
``__meta__`` entry. The port writes the reference's TrainState layout for
the model, so the JAX package's ``load_model_checkpoint`` serves a
port-trained checkpoint: ``.params/…``, ``.bn_state/…``, ``.ema/…`` (EMA on),
``.step`` and ``.lr_mult`` (plateau schedule), each leaf in the reference's
layout (``to_jax_params``). The optimizer state (``train/optim.py``) is
written under ``.opt_state/…`` in the layout of the reference's optax chain
(``_optax_leaves``: Adam's ``1/0/.count``, ``.mu/…``, ``.nu/…``, SGD's
``1/0/.trace/…``, the schedule count, ``MultiSteps``' ``.mini_step``,
``.gradient_step``, ``.acc_grads/…`` and ``.inner_opt_state/…``; moments of
conv kernels transposed as the kernels are), so the JAX package's
``Checkpointer`` resumes a port-written run and the port resumes a
JAX-written one. Files of the port's earlier layout (meta ``opt_layout``
``m3f_torch/1``) still resume. ``Checkpointer`` writes atomically (mkstemp +
``os.replace``), keeps the last K, writes asynchronously (a snapshot on the
device, fetched and written on a thread), resumes from the newest usable
file (a corrupt one falls back to an older one; a config-hash mismatch, an
unknown layout and a key set that fits neither layout abort), keeps the best
by eval CCC and saves on SIGTERM. In a ``torch.distributed`` group only
rank 0 writes, prunes and saves on SIGTERM, and every rank reads (the
checkpoint directory must be shared), then checks that all restored the
same step. Under tensor parallelism (``TrainState.tp``) every leaf is
written whole: the writer gathers each sharded param, moment and EMA leaf
over its model axis first (every rank takes part), so the keys, shapes and
``opt_layout`` are those of a one-process file and of the JAX package's;
every rank reads the whole arrays and keeps its blocks. A checkpoint thus
resumes under any ``(num_data, num_model)``, the JAX package's included.

The load side reads a JAX checkpoint with numpy alone:
``read_model_checkpoint(path)`` gives the port's ``state_dict`` and step
(the serving path), ``load_model_checkpoint(state, path)`` a new
``TrainState`` on a template state (the reference's signature; ensemble
members), ``load_pretrained_init(state_dict, path)`` fills one branch or the
whole model from an import-script file (``model.init_from``). In each:

- module names mirror the reference's param tree, so a path
  ``visual/blocks/0/conv1/spatial/kernel`` is the key
  ``visual.blocks.0.conv1.spatial.weight``;
- params (``scale``/``bias``) and BN state (``mean``/``var``) merge into one
  dict (BN state is the modules' buffers);
- conv kernels (HWIO / DHWIO, 4-D and 5-D ``kernel`` leaves) become
  PyTorch's ``[O, I, *k]`` ``weight``; Dense kernels ``[in, out]`` and GRU
  weights (``w_ih`` [D, 3H], ``w_hh`` [H, 3H]) keep the reference layout.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import signal
import tempfile
import threading
import weakref
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from m3f_torch.config import ExperimentConfig
from m3f_torch.parallel.mesh import TensorParallel, agree, barrier, world_axis

# meta tag of the optimizer-state layout written here: the reference's optax
# chain (the JAX package tags nothing, and an untagged file is read so)
OPT_LAYOUT = "optax"
# the port's earlier layout (train/optim.py's nested dicts), still read
OWN_LAYOUT = "m3f_torch/1"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts / lists / tuples of arrays → {"a/b/0/c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _convert(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``/``-keyed reference leaves → the port's state dict (module doc)."""
    out: Dict[str, torch.Tensor] = {}
    for key, v in flat.items():
        parts = key.split("/")
        v = np.asarray(v, dtype=np.float32)
        if parts[-1] == "kernel" and v.ndim >= 4:
            nd = v.ndim
            v = v.transpose((nd - 1, nd - 2) + tuple(range(nd - 2)))
            parts[-1] = "weight"
        name = ".".join(parts)
        if name in out:
            raise ValueError(f"duplicate leaf {name!r} in params and state")
        out[name] = torch.from_numpy(np.array(v, order="C"))  # own copy
    return out


def _blocks(tensors: Dict[str, torch.Tensor],
            tp: Optional[TensorParallel]) -> Dict[str, torch.Tensor]:
    return tensors if tp is None else tp.blocks(tensors)


def from_jax_params(params: Any, bn_state: Any,
                    tp: Optional[TensorParallel] = None
                    ) -> Dict[str, torch.Tensor]:
    """The port's state dict from the JAX package's nested numpy pytrees
    (``M3F.init`` params and BN state, or their host copies); with a
    tensor-parallel layout ``tp``, this rank's blocks of the sharded leaves
    (the JAX arrays are whole: gathered on the host)."""
    flat = _flatten(params)
    for k, v in _flatten(bn_state).items():
        if k in flat:
            raise ValueError(f"leaf {k!r} is in both params and bn_state")
        flat[k] = v
    return _blocks(_convert(flat), tp)


def _model_leaves(path: str):
    """A JAX checkpoint's model leaves: ({params path: array}, {BN state
    path: array}, step or None, stray keys).

    The TrainState layout (``.params/…``, ``.bn_state/…``, ``.step``) gives
    the EMA shadow ``.ema/…`` in place of the params when it holds one, as
    the reference's eval does, and its step; its optimizer state is never
    read. The import-script layout (``params/…``, ``state/…``) has no step,
    and every other key of it is stray."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files if k != "__meta__"}
    if data.keys() & {"step", ".step"}:
        params = ".ema" if any(k.startswith(".ema/") for k in data) \
            else ".params"
        groups = {params + "/": 0, ".bn_state/": 1}
        step = int(np.asarray(data[".step" if ".step" in data else "step"]))
    else:
        groups = {"params/": 0, "state/": 1}
        step = None
    out: Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]] = ({}, {})
    stray = []
    for k, v in data.items():
        for p, g in groups.items():
            if k.startswith(p):
                out[g][k[len(p):]] = v
                break
        else:
            stray.append(k)
    return out[0], out[1], step, stray


def read_model_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """(state dict, step) for serving from a JAX checkpoint ``.npz``.

    Accepts the full TrainState layout (``.params/…``, ``.bn_state/…``,
    ``.step``; the EMA shadow ``.ema/…`` is preferred when present, as the
    reference's eval does) and the import-script layout (``params/…``,
    ``state/…``; step 0). Optimizer state is never read.
    """
    params, state, step, _ = _model_leaves(path)
    flat = dict(params)
    for rest, v in state.items():
        if rest in flat:
            raise ValueError(f"checkpoint {path}: leaf {rest!r} is in "
                             "both params and state")
        flat[rest] = v
    if not flat:
        raise ValueError(f"checkpoint {path} holds no model leaves")
    return _convert(flat), step or 0


def _fit_to(template: Dict[str, torch.Tensor], flat: Dict[str, np.ndarray],
            path: str, tp: Optional[TensorParallel] = None
            ) -> Dict[str, torch.Tensor]:
    """``/``-keyed leaves converted onto ``template``'s names, shapes and
    dtypes (host tensors; this rank's blocks under ``tp``); raises on a
    leaf the template lacks, on a template name the leaves lack and on a
    leaf of another shape (an r3d_18 file on an mc3_18 template has the
    same names), all before any tensor is returned."""
    conv = _convert(flat)
    extra = sorted(conv.keys() - template.keys())
    if extra:
        raise ValueError(f"checkpoint {path} has model leaves the eval model "
                         f"lacks: {extra[:5]} — architecture mismatch")
    missing = sorted(template.keys() - conv.keys())
    if missing:
        raise ValueError(f"checkpoint {path} missing model leaf "
                         f"{missing[0]} (and {len(missing) - 1} more)")
    conv = _blocks(conv, tp)
    shape = sorted(n for n, t in template.items()
                   if tuple(conv[n].shape) != tuple(t.shape))
    if shape:
        raise ValueError(f"checkpoint {path}: leaves of another shape than "
                         f"the model's: {shape[:5]} — architecture mismatch")
    return {n: conv[n].to(t.dtype) for n, t in template.items()}


def load_model_checkpoint(state, path: str):
    """A new ``TrainState`` for eval from a JAX checkpoint ``.npz``, with
    the reference's signature: the params (the EMA shadow ``.ema/…`` when
    the file holds one) and the BN state of ``path``, on ``state``'s names,
    shapes and dtypes, as host tensors (``Trainer.commit_state`` puts them
    on the device); the step of a TrainState file, else ``state``'s; the
    optimizer state and ``lr_mult`` of ``state``. The EMA shadow, if
    ``state`` has one, is a copy of the loaded params. A tensor-parallel
    state (``state.tp``) gets this rank's blocks. Both layouts load
    (``read_model_checkpoint``); a model leaf the template lacks, a missing
    one and (import layout) any other key raise ``ValueError``."""
    params, bn, step, stray = _model_leaves(path)
    if step is None and stray:
        raise ValueError(f"checkpoint mismatch: {path} has keys outside "
                         f"params/ and state/: {sorted(stray)[:5]}")
    new_params = _fit_to(state.params, params, path, state.tp)
    return replace(
        state, params=new_params,
        bn_state=_fit_to(state.bn_state, bn, path),
        ema=None if state.ema is None else
        {n: t.clone() for n, t in new_params.items()},
        step=state.step if step is None else step)


# ``kind`` of an import-script file (its meta) → the model branch it fills
_INIT_BRANCHES = {"m3f": "", "r2plus1d": "visual", "audio_cnn": "audio"}


def load_pretrained_init(state_dict: Dict[str, torch.Tensor],
                         path: str) -> Dict[str, torch.Tensor]:
    """``state_dict`` with one branch (or all) replaced by the weights of an
    import-script file (``params/…``, ``state/…``; ``model.init_from``).

    The file's meta ``kind`` picks the target: ``m3f`` the whole model,
    ``r2plus1d`` the ``visual.*`` branch, ``audio_cnn`` the ``audio.*``
    branch; without one it is inferred from the key prefixes, as the
    reference does. A branch file's paths lack the branch prefix. Every
    other tensor keeps its value. Raises ``ValueError`` on a branch the
    model lacks and on missing or extra leaves."""
    kind = load_meta(path).get("kind")
    with np.load(path) as z:
        keys = [k for k in z.files if k != "__meta__"]
        data = {k: z[k] for k in keys}
    if kind is None:
        if any(k.startswith("params/gru") for k in keys):
            kind = "m3f"
        elif any(k.startswith("params/stem") for k in keys):
            kind = "r2plus1d"
        else:
            kind = "audio_cnn"
    if kind not in _INIT_BRANCHES:
        raise ValueError(f"init_from {path}: unknown kind {kind!r} (one of "
                         f"{sorted(_INIT_BRANCHES)})")
    branch = _INIT_BRANCHES[kind]
    prefix = branch + "." if branch else ""
    template = {n: t for n, t in state_dict.items() if n.startswith(prefix)}
    if branch and not template:
        have = sorted({n.split(".")[0] for n in state_dict})
        raise ValueError(f"init_from kind={kind} needs model branch "
                         f"'{branch}', but the model has {have}")
    flat: Dict[str, np.ndarray] = {}
    stray = []
    for k, v in data.items():
        group, _, rest = k.partition("/")
        name = f"{branch}/{rest}" if branch else rest
        if group not in ("params", "state") or not rest or name in flat:
            stray.append(k)
        flat[name] = v
    conv = _convert(flat)
    missing = sorted(template.keys() - conv.keys())
    extra = sorted(conv.keys() - template.keys()) + stray
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: {path} does not fit the "
                         f"model's {branch or 'whole model'}: "
                         f"missing={missing[:5]} extra={extra[:5]}")
    out = dict(state_dict)
    for n, t in template.items():
        out[n] = conv[n].to(device=t.device, dtype=t.dtype).reshape(t.shape)
    return out


def _kernel_perm(nd: int, to_jax: bool) -> tuple:
    """The permutation of a conv kernel's axes: [O, I, *k] → [*k, I, O]
    (``to_jax``) or back."""
    return tuple(range(2, nd)) + (1, 0) if to_jax \
        else (nd - 1, nd - 2) + tuple(range(nd - 2))


def _is_conv(name: str, ndim: int) -> bool:
    """Whether a port tensor is a conv ``weight`` (4-D or 5-D)."""
    return name.split(".")[-1] == "weight" and ndim >= 4


def _jax_name(name: str, ndim: int) -> str:
    """The reference path of a port tensor name: ``/``-joined, a conv
    ``weight`` named ``kernel``."""
    parts = name.split(".")
    if _is_conv(name, ndim):
        parts[-1] = "kernel"
    return "/".join(parts)


def to_jax_params(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``_convert``: the port's names → ``/``-joined reference
    paths, conv ``weight`` [O, I, *k] → ``kernel`` [*k, I, O], every other
    leaf as is (fp32 numpy)."""
    out: Dict[str, np.ndarray] = {}
    for name, t in tensors.items():
        v = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        if _is_conv(name, v.ndim):
            v = v.transpose(_kernel_perm(v.ndim, True))
        out[_jax_name(name, v.ndim)] = np.ascontiguousarray(v, dtype=np.float32)
    return out


def save_pytree(leaves: Dict[str, np.ndarray], path: str,
                meta: Optional[dict] = None) -> None:
    """Atomically write ``/``-keyed leaves (and ``meta`` as ``__meta__``) to
    ``path`` (.npz): a temporary file in the same directory, then
    ``os.replace``."""
    leaves = dict(leaves)
    if meta:
        leaves["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **leaves)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_meta(path: str) -> dict:
    with np.load(path) as z:
        if "__meta__" in z.files:
            return json.loads(bytes(z["__meta__"]).decode())
    return {}


def _flatten_opt(tree: Any, prefix: str = ".opt_state") -> Dict[str, Any]:
    """The optimizer state's nested dicts → {".opt_state/a/b": leaf} (the
    port's earlier layout, ``OWN_LAYOUT``)."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(_flatten_opt(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _optax_leaves(opt: dict, adamw: bool) -> Iterator[Tuple[str, tuple]]:
    """(key under ``.opt_state/``, path into ``opt``) of every leaf that the
    reference's optax chain keeps for the optimizer whose port state is
    ``opt``: ``clip_by_global_norm`` (no leaves) → adam / adamw
    (``scale_by_adam``: count, mu, nu) or sgd (``trace``) → the schedule's
    count where the learning rate is scheduled (slot 2 under adamw, whose
    ``add_decayed_weights`` takes slot 1) → the lr_scale and freeze masks
    (no leaves), all under ``MultiSteps`` when accumulating. The port's SGD
    count has no leaf (optax's trace counts nothing)."""
    if "mini_step" in opt:
        yield ".mini_step", ("mini_step",)
        yield ".gradient_step", ("gradient_step",)
        for n, t in opt["acc"].items():
            yield f".acc_grads/{_jax_name(n, t.dim())}", ("acc", n)
        inner, pre, base = opt["inner"], ".inner_opt_state/1/", ("inner",)
    else:
        inner, pre, base = opt, "1/", ()
    if "mu" in inner:
        yield pre + "0/.count", base + ("count",)
        groups: Tuple[str, ...] = ("mu", "nu")
    else:
        groups = ("trace",)
    for g in groups:
        for n, t in inner[g].items():
            yield f"{pre}0/.{g}/{_jax_name(n, t.dim())}", base + (g, n)
    if "schedule_count" in inner:
        yield f"{pre}{2 if adamw else 1}/.count", base + ("schedule_count",)


def _leaf(tree: dict, path: tuple):
    for p in path:
        tree = tree[p]
    return tree


def _optax_snapshot(opt: dict, adamw: bool, cp) -> Dict[str, Any]:
    """{".opt_state/<optax key>": leaf} of ``opt`` (tensors through ``cp``,
    which takes the parameter name and the leaf; conv moments as permuted
    views, in the reference's axis order)."""
    out: Dict[str, Any] = {}
    for key, path in _optax_leaves(opt, adamw):
        v = _leaf(opt, path)
        if isinstance(v, torch.Tensor):
            v = cp(path[-1], v)
            if _is_conv(path[-1], v.dim()):
                v = v.permute(_kernel_perm(v.dim(), True))
        out[".opt_state/" + key] = v
    return out


def _file_adamw(opt: dict, data: Dict[str, np.ndarray]) -> bool:
    """Whether a file's schedule count sits at adamw's slot."""
    pre = ".opt_state/.inner_opt_state/1/" if "mini_step" in opt \
        else ".opt_state/1/"
    return pre + "2/.count" in data


def _snapshot(state, clone: bool, adamw: bool) -> Dict[str, Any]:
    """The state's leaves by checkpoint key, whole (the sharded ones
    gathered over the model axis: a collective under ``state.tp``), still
    on their device (copies when ``clone``); converted by ``_to_arrays``."""
    tp = state.tp

    def cp(name: str, t: torch.Tensor) -> torch.Tensor:
        if tp is not None and tp.sharded(name):
            return tp.full(name, t.detach())
        return t.detach().clone() if clone else t.detach()
    snap: Dict[str, Any] = {"params": {n: cp(n, t) for n, t in state.params.items()},
                            "bn_state": {n: cp(n, t) for n, t in state.bn_state.items()},
                            "ema": None if state.ema is None else
                            {n: cp(n, t) for n, t in state.ema.items()},
                            "step": int(state.step), "lr_mult": state.lr_mult}
    snap["opt"] = _optax_snapshot(state.opt_state, adamw, cp)
    return snap


def _to_arrays(snap: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for group in ("params", "bn_state", "ema"):
        if snap[group] is not None:
            for k, v in to_jax_params(snap[group]).items():
                out[f".{group}/{k}"] = v
    for k, v in snap["opt"].items():
        out[k] = np.ascontiguousarray(v.cpu().numpy()) \
            if isinstance(v, torch.Tensor) else np.asarray(v, np.int32)
    out[".step"] = np.asarray(snap["step"], np.int32)
    if snap["lr_mult"] is not None:
        out[".lr_mult"] = np.asarray(snap["lr_mult"], np.float32)
    return out


def _model_keys(state) -> set:
    keys = {".step"} | ({".lr_mult"} if state.lr_mult is not None else set())
    for group in ("params", "bn_state", "ema"):
        tensors = getattr(state, group)
        if tensors is not None:
            keys |= {f".{group}/{_jax_name(n, t.dim())}"
                     for n, t in tensors.items()}
    return keys


def _fill_optax(opt: dict, data: Dict[str, np.ndarray], adamw: bool,
                step: int, path: str,
                tp: Optional[TensorParallel] = None) -> None:
    """Copy a file's optax leaves into the port's state ``opt`` in place
    (counts as ints; this rank's blocks under ``tp``); SGD's count, which
    optax does not keep, becomes the number of updates applied."""
    for key, at in _optax_leaves(opt, adamw):
        v = data[".opt_state/" + key]
        cur = _leaf(opt, at)
        if not isinstance(cur, torch.Tensor):
            _leaf(opt, at[:-1])[at[-1]] = int(np.asarray(v))
            continue
        t = torch.from_numpy(np.asarray(v, np.float32))
        if key.endswith("/kernel") and t.dim() >= 4:
            t = t.permute(_kernel_perm(t.dim(), False))
        if tp is not None:
            t = tp.block(at[-1], t)
        if tuple(t.shape) != tuple(cur.shape):
            raise ValueError(f"checkpoint {path}: optimizer leaf {key} has "
                             f"shape {tuple(np.shape(v))}, the state's "
                             f"{'/'.join(map(str, at))} {tuple(cur.shape)}")
        cur.copy_(t)
    inner = opt.get("inner", opt)
    if "trace" in inner:
        inner["count"] = inner.get(
            "schedule_count", opt["gradient_step"] if "inner" in opt else step)


def _restore(state, data: Dict[str, np.ndarray], path: str,
             layout: str) -> None:
    """Copy a checkpoint's leaves into ``state`` in place (same device and
    tensors; this rank's blocks of the whole arrays under ``state.tp``);
    raise ``ValueError`` naming the missing and extra leaves when the
    file's keys are not the state's in ``layout``."""
    tp = state.tp
    adamw = _file_adamw(state.opt_state, data)
    if layout == OWN_LAYOUT:
        opt_keys = set(_flatten_opt(state.opt_state))
    else:
        opt_keys = {".opt_state/" + k
                    for k, _ in _optax_leaves(state.opt_state, adamw)}
    want, have = _model_keys(state) | opt_keys, set(data)
    if want != have:
        raise ValueError(
            f"checkpoint {path} ({layout} optimizer layout) does not fit the "
            f"state: missing={sorted(want - have)[:5]} "
            f"extra={sorted(have - want)[:5]}")
    for group in ("params", "bn_state", "ema"):
        tensors = getattr(state, group)
        if tensors is None:
            continue
        conv = _blocks(_convert({k[len(group) + 2:]: v
                                 for k, v in data.items()
                                 if k.startswith(f".{group}/")}), tp)
        for n, t in tensors.items():
            t.data.copy_(conv[n].reshape(t.shape))
    state.step = int(data[".step"])
    if state.lr_mult is not None:
        state.lr_mult = float(data[".lr_mult"])
    if layout != OWN_LAYOUT:
        _fill_optax(state.opt_state, data, adamw, state.step, path, tp)
        return

    def fill(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}"
            if isinstance(v, dict):
                fill(v, key)
            elif isinstance(v, torch.Tensor):
                whole = torch.from_numpy(data[key])
                if tp is not None:
                    whole = tp.block(k, whole)
                v.copy_(whole.reshape(v.shape))
            else:
                tree[k] = int(data[key])
    fill(state.opt_state, ".opt_state")


_LIVE_CHECKPOINTERS: "weakref.WeakSet[Checkpointer]" = weakref.WeakSet()
_ATEXIT_INSTALLED = False


def _drain_all_checkpointers():
    """At exit: join every live checkpointer's writer (failures printed, so
    the remaining ones still drain)."""
    for ck in list(_LIVE_CHECKPOINTERS):
        try:
            ck.wait()
        except Exception as e:     # noqa: BLE001 — exit path, keep draining
            print(f"checkpoint write failed during exit drain: {e}")


@dataclass(eq=False)
class Checkpointer:
    directory: str
    keep: int = 3
    cfg: Optional[ExperimentConfig] = None
    _sigterm_state: Any = field(default=None, repr=False)

    def __post_init__(self):
        global _ATEXIT_INSTALLED
        os.makedirs(self.directory, exist_ok=True)
        # the trainer's optimizer config, when ``cfg`` is None: learned in
        # maybe_restore(state, trainer)
        self._optim = None
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[tuple] = None     # (path, exception)
        _LIVE_CHECKPOINTERS.add(self)
        if not _ATEXIT_INSTALLED:
            atexit.register(_drain_all_checkpointers)
            _ATEXIT_INSTALLED = True

    # -- naming -------------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    def all_steps(self):
        steps = []
        for f in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_path(self) -> Optional[str]:
        steps = self.all_steps()
        return self._path(steps[-1]) if steps else None

    def best_path(self) -> str:
        return os.path.join(self.directory, "best.npz")

    # -- save ---------------------------------------------------------------

    @staticmethod
    def _primary() -> bool:
        """Only rank 0 writes: every leaf it writes is whole there (the
        replicated ones are the same on every rank, the sharded ones are
        gathered over the model axis first, ``_gathered``), so every rank's
        write would be the same file, and keep-K prunes would interleave.
        Every rank reads (``maybe_restore``), so the directory must be
        shared storage."""
        return world_axis().rank == 0

    def _adamw(self, opt: dict) -> bool:
        """Whether the optimizer is adamw, whose schedule count takes slot
        2 of the optax chain; only an Adam state with a schedule count
        needs the config to tell."""
        optim = self.cfg.train.optim if self.cfg is not None else self._optim
        if optim is not None:
            return optim.optimizer == "adam" and bool(optim.weight_decay)
        inner = opt.get("inner", opt)
        if "mu" in inner and "schedule_count" in inner:
            raise ValueError(
                "a scheduled Adam state is written at adam's or adamw's slot "
                "of the optax chain: give the Checkpointer the config "
                "(cfg=...) or restore through it first")
        return False

    def _gathered(self, state, clone: bool) -> Optional[Dict[str, Any]]:
        """The snapshot the writer writes, None on the other ranks; under
        tensor parallelism every rank takes part in the gathers."""
        if state.tp is None and not self._primary():
            return None
        snap = _snapshot(state, clone, self._adamw(state.opt_state))
        return snap if self._primary() else None

    def _meta(self, step: int) -> dict:
        meta = {"step": step, "opt_layout": OPT_LAYOUT}
        if self.cfg is not None:
            meta["config_hash"] = self.cfg.config_hash()
            meta["config"] = self.cfg.to_dict()
        return meta

    def save(self, state) -> str:
        """Write ``state`` now (after any write in flight) and prune."""
        self.wait()
        path = self._path(int(state.step))
        snap = self._gathered(state, clone=False)
        if snap is None:
            return path
        save_pytree(_to_arrays(snap), path, self._meta(int(state.step)))
        self._prune()
        return path

    def save_async(self, state) -> str:
        """Snapshot ``state`` on its device now (the next steps update it in
        place), then fetch, write and prune on a background thread; one
        write in flight at a time."""
        self.wait()
        path = self._path(int(state.step))
        snap = self._gathered(state, clone=True)
        if snap is None:
            return path
        self._start_writer(snap, path, self._meta(int(state.step)),
                           prune=True)
        return path

    def save_best(self, state, metric: float) -> str:
        """best.npz, written like ``save_async``."""
        self.wait()
        snap = self._gathered(state, clone=True)
        if snap is None:
            return self.best_path()
        meta = {"step": int(state.step), "metric": float(metric),
                "opt_layout": OPT_LAYOUT}
        if self.cfg is not None:
            meta["config_hash"] = self.cfg.config_hash()
        self._start_writer(snap, self.best_path(), meta)
        return self.best_path()

    def _start_writer(self, snap, path: str, meta: dict,
                      prune: bool = False) -> None:
        """Background fetch and write; a failure is re-raised by the next
        ``wait()``."""
        def _write():
            try:
                save_pytree(_to_arrays(snap), path, meta)
                snap.clear()                      # free the device snapshot
                if prune:
                    self._prune()
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                self._writer_error = (path, e)

        self._writer = threading.Thread(target=_write, daemon=True)
        self._writer.start()

    def wait(self) -> None:
        """Block until the write in flight has finished; raise if it
        failed."""
        w = self._writer
        if w is not None and w.is_alive():
            w.join()
        self._writer = None
        err, self._writer_error = self._writer_error, None
        if err is not None:
            path, exc = err
            raise RuntimeError(
                f"async checkpoint write of {path} failed: {exc}") from exc

    def _prune(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            try:
                os.unlink(self._path(s))
            except FileNotFoundError:
                pass

    # -- restore ------------------------------------------------------------

    def seed_from(self, path: str) -> None:
        """Copy a full-state checkpoint into this directory under its own
        step, so ``maybe_restore`` resumes from it; ignored (with a notice)
        when the directory already holds checkpoints. In a process group
        rank 0 copies, and every rank waits for it."""
        if self._primary():
            self._seed(path)
        barrier(world_axis())

    def _seed(self, path: str) -> None:
        if self.all_steps():
            print(f"resume-from {path} ignored: {self.directory} already has "
                  "checkpoints (auto-resume from the newest takes precedence)")
            return
        with np.load(path) as z:
            keys = {"step", ".step"} & set(z.files)
            if not keys:
                raise ValueError(
                    f"{path} is not a full TrainState checkpoint (no step "
                    "leaf) — model-only weights load into Trainer.model")
            step = int(np.asarray(z[next(iter(keys))]))
        dst = self._path(step)
        tmp = dst + ".tmp"
        shutil.copyfile(path, tmp)
        os.replace(tmp, dst)
        print(f"seeded {self.directory} from {path} (step {step})")

    def maybe_restore(self, state, trainer=None):
        """Resume ``state`` in place from the newest usable checkpoint and
        return it (as is when there is none). A corrupt file (one that does
        not load) falls back to an older one; a config-hash mismatch, an
        optimizer layout other than ``OPT_LAYOUT`` (or none: the JAX
        package's files) and ``OWN_LAYOUT``, and a key set that does not fit
        the state raise instead. ``trainer`` gives the optimizer config
        later saves write by, when the checkpointer has none. In a process
        group every rank reads, then all check they restored one step."""
        if trainer is not None and self.cfg is None:
            self._optim = trainer.cfg.train.optim
        self._restore_newest(state)
        agree(int(state.step), world_axis(),
              f"the step restored from {self.directory}")
        return state

    def _restore_newest(self, state) -> None:
        for step in reversed(self.all_steps()):
            p = self._path(step)
            try:
                meta = load_meta(p)
                with np.load(p) as z:
                    data = {k: z[k] for k in z.files if k != "__meta__"}
            except Exception as e:     # noqa: BLE001 — corrupt file: try older
                print(f"checkpoint {p} unusable ({e}); trying older")
                continue
            if (self.cfg is not None and meta.get("config_hash") not in
                    (None, self.cfg.config_hash())):
                raise RuntimeError(
                    f"checkpoint {p} was written by a different config "
                    f"(hash {meta.get('config_hash')} != "
                    f"{self.cfg.config_hash()}). Refusing to resume silently "
                    "— point checkpoint_dir at a fresh directory or restore "
                    "the original config.")
            layout = meta.get("opt_layout", OPT_LAYOUT)
            if layout not in (OPT_LAYOUT, OWN_LAYOUT):
                raise ValueError(
                    f"checkpoint {p} holds an optimizer state of layout "
                    f"{layout!r}, which is neither the optax chain's "
                    f"({OPT_LAYOUT!r}, or no tag: the JAX package's) nor "
                    f"{OWN_LAYOUT!r}")
            _restore(state, data, p, layout)
            return

    # -- preemption -----------------------------------------------------------

    def install_preemption_handler(self, get_state) -> None:
        """Save ``get_state()`` on SIGTERM, then exit with 143; a failing
        save is reported and never masks the exit."""
        def handler(signum, frame):
            try:
                st = get_state()
                if st is not None:
                    self.save(st)
            except Exception as e:     # noqa: BLE001 — the exit must happen
                print(f"preemption save failed ({e}); exiting without it")
            raise SystemExit(143)
        signal.signal(signal.SIGTERM, handler)
