"""Average model weights across checkpoints (stochastic weight averaging).

Counterpart of ``scripts/average_checkpoints.py`` (pure numpy; the same
file out, ``tests/test_torch_convert.py``). Averaging the last K (or the K
best) checkpoints of a run usually beats any single one. Accepts every
checkpoint layout of the port and the JAX package — full TrainState
``ckpt_*.npz`` / ``best.npz`` and the ``{params, state}`` layout of
``import_torch_checkpoint`` — and writes a ``{params, state}`` model-only
.npz that ``python -m m3f_torch.main eval/predict --checkpoint`` and
``--init-from`` read:

    python -m m3f_torch.scripts.average_checkpoints ckpt_0001000.npz \
        ckpt_0002000.npz best.npz --out averaged.npz

Floating-point leaves are averaged in float64 and cast back; integer leaves
(none in the model tree today) must agree across inputs. BN running
statistics are averaged along with the weights — the standard SWA caveat
that they should ideally be re-estimated is the user's call.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def model_leaves(path: str) -> dict:
    """Read one checkpoint → {normalized key: array} for params + bn_state.

    Full-TrainState layout flattens NamedTuple fields as ``.params/...`` /
    ``.bn_state/...``; the import-script layout uses ``params/...`` /
    ``state/...``. Normalized to the latter.
    """
    with np.load(path) as z:
        data = {k: z[k] for k in z.files if k != "__meta__"}
    # a train.ema_decay checkpoint carries an EMA shadow under ".ema/" —
    # those are the weights every eval/best-selection scored, so THEY are
    # what gets averaged (raw ".params/" are the lagging online weights)
    params_prefix = ".ema/" if any(k.startswith(".ema/") for k in data) \
        else ".params/"
    out = {}
    for k, v in data.items():
        if k.startswith(params_prefix):
            out["params/" + k[len(params_prefix):]] = v
        elif k.startswith(".bn_state/"):
            out["state/" + k[len(".bn_state/"):]] = v
        elif k.startswith(("params/", "state/")):
            out[k] = v
        # .opt_state/.step and anything else: not model weights, dropped
    if not out:
        raise SystemExit(f"{path}: no model leaves found (params/bn_state)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoints", nargs="+")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if len(args.checkpoints) < 2:
        raise SystemExit("need at least 2 checkpoints to average")

    trees = [model_leaves(p) for p in args.checkpoints]
    keys = set(trees[0])
    for p, t in zip(args.checkpoints[1:], trees[1:]):
        if set(t) != keys:
            diff = sorted(keys ^ set(t))[:5]
            raise SystemExit(f"{p}: leaf mismatch vs {args.checkpoints[0]}: {diff}")

    avg = {}
    for k in sorted(keys):
        leaves = [t[k] for t in trees]
        if not np.issubdtype(leaves[0].dtype, np.floating):
            for p, l in zip(args.checkpoints[1:], leaves[1:]):
                if not np.array_equal(l, leaves[0]):
                    raise SystemExit(f"non-float leaf {k} differs in {p}")
            avg[k] = leaves[0]
            continue
        avg[k] = np.mean([l.astype(np.float64) for l in leaves],
                         axis=0).astype(leaves[0].dtype)

    avg["__meta__"] = np.frombuffer(json.dumps({
        "kind": "m3f", "source": "average_checkpoints",
        "n": len(args.checkpoints)}).encode(), dtype=np.uint8)
    with open(args.out, "wb") as f:
        np.savez(f, **avg)
    print(f"averaged {len(args.checkpoints)} checkpoints "
          f"({sum(1 for k in keys if k.startswith('params/'))} param leaves) "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
