"""Carry weights trained by the JAX package into the port (load side).

Counterpart of the load half of ``m3f/pytorch_tpu/train/checkpoint.py``.
A JAX checkpoint is one ``.npz`` of pytree leaves keyed by their
``/``-joined tree path; this module reads it with numpy alone and returns
the port's ``state_dict``:

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

from typing import Any, Dict, Tuple

import numpy as np
import torch


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


def from_jax_params(params: Any, bn_state: Any) -> Dict[str, torch.Tensor]:
    """The port's state dict from the JAX package's nested numpy pytrees
    (``M3F.init`` params and BN state, or their host copies)."""
    flat = _flatten(params)
    for k, v in _flatten(bn_state).items():
        if k in flat:
            raise ValueError(f"leaf {k!r} is in both params and bn_state")
        flat[k] = v
    return _convert(flat)


def load_model_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """(state dict, step) for serving from a JAX checkpoint ``.npz``.

    Accepts the full TrainState layout (``.params/…``, ``.bn_state/…``,
    ``.step``; the EMA shadow ``.ema/…`` is preferred when present, as the
    reference's eval does) and the import-script layout (``params/…``,
    ``state/…``; step 0). Optimizer state is never read.
    """
    with np.load(path) as z:
        data = {k: z[k] for k in z.files if k != "__meta__"}
    if data.keys() & {"step", ".step"}:
        params = ".ema" if any(k.startswith(".ema/") for k in data) \
            else ".params"
        prefixes = (params + "/", ".bn_state/")
        step = int(np.asarray(data[".step" if ".step" in data else "step"]))
    else:
        prefixes = ("params/", "state/")
        step = 0
    flat = {}
    for k, v in data.items():
        for p in prefixes:
            if k.startswith(p):
                rest = k[len(p):]
                if rest in flat:
                    raise ValueError(f"checkpoint {path}: leaf {rest!r} is in "
                                     "both params and state")
                flat[rest] = v
    if not flat:
        raise ValueError(f"checkpoint {path} holds no model leaves under "
                         f"{prefixes}")
    return _convert(flat), step
