"""Export a checkpoint npz to a torch-layout state_dict (.pt).

Counterpart of ``scripts/export_torch_checkpoint.py``, the inverse of
``import_torch_checkpoint``:

    python -m m3f_torch.scripts.export_torch_checkpoint ckpt_00001000.npz out.pt

The input is a trainer checkpoint (the TrainState layout the port and the
JAX package write; its EMA shadow is exported when it holds one) or a
``{params, state}`` file of the import script. The output loads into a
reference-shaped torch model (torchvision VideoResNet visual backbone,
nn.GRU, nn.Linear head) via ``model.load_state_dict(torch.load(out.pt))``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from m3f_torch.train.convert import export_m3f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("npz_ckpt")
    ap.add_argument("out_pt")
    args = ap.parse_args(argv)

    import torch

    with np.load(args.npz_ckpt) as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}

    # reassemble the nested tree from path keys ("params/visual/stem/...")
    def assemble(prefix: str) -> dict:
        tree: dict = {}
        for k, v in flat.items():
            if not k.startswith(prefix):
                continue
            parts = k[len(prefix):].split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return _listify(tree)

    def _listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [_listify(node[str(i)]) for i in range(len(node))]
            return {k: _listify(v) for k, v in node.items()}
        return node

    # trainer checkpoints hold ".params/…" and ".bn_state/…"; the import
    # script's file "params/…" / "state/…". ".ema/" (the train.ema_decay
    # shadow) wins over ".params/": it is what every eval used
    for pp, sp in ((".ema/", ".bn_state/"), (".params/", ".bn_state/"),
                   ("params/", "state/")):
        if any(k.startswith(pp) for k in flat):
            params, state = assemble(pp), assemble(sp)
            break
    else:
        raise SystemExit("unrecognized checkpoint layout (no params keys)")

    sd = export_m3f(params, state)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               args.out_pt)
    print(f"wrote {args.out_pt}: {len(sd)} tensors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
