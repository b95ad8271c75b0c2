"""Import a torch checkpoint (.pt/.pth/Lightning .ckpt) into the reference's
``{params, state}`` npz layout.

Counterpart of ``scripts/import_torch_checkpoint.py``; writes the same file
(``tests/test_torch_convert.py``), which ``train.checkpoint.
load_model_checkpoint`` / ``read_model_checkpoint`` and ``model.init_from``
read:

    python -m m3f_torch.scripts.import_torch_checkpoint model.pth out.npz \
        [--kind r2plus1d|audio_cnn|m3f] [--prefix backbone.]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from m3f_torch.train import convert
from m3f_torch.train.checkpoint import _flatten, save_pytree


def load_state_dict(path: str, prefix: str = "") -> dict:
    import torch
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:   # Lightning .ckpt
        obj = obj["state_dict"]
    sd = {}
    for k, v in obj.items():
        if prefix and not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        sd[k] = v.numpy() if hasattr(v, "numpy") else np.asarray(v)
    return sd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("torch_ckpt")
    ap.add_argument("out_npz")
    ap.add_argument("--kind", default="r2plus1d",
                    choices=["r2plus1d", "audio_cnn", "m3f"])
    ap.add_argument("--prefix", default="",
                    help="strip this key prefix (e.g. 'model.backbone.')")
    args = ap.parse_args(argv)

    sd = load_state_dict(args.torch_ckpt, args.prefix)
    if not sd:
        print(f"no keys (after prefix filter '{args.prefix}')", file=sys.stderr)
        return 1
    meta = {"source": args.torch_ckpt, "kind": args.kind}
    mode = ""
    if args.kind == "r2plus1d":
        mode = convert.detect_visual_mode(sd)
        params, state = convert.convert_r2plus1d(sd)
    elif args.kind == "audio_cnn":
        params, state = convert.convert_audio_cnn(sd)
    else:
        mode = convert.detect_visual_mode(sd, "visual")
        params, state = convert.convert_m3f(sd)
    if mode:
        # surfaced so users of r3d_18/mc3_18 checkpoints know to set
        # model.visual.conv_mode — otherwise the later template load fails
        # with a generic key-mismatch error
        meta["conv_mode"] = mode
    save_pytree(_flatten({"params": params, "state": state}), args.out_npz,
                meta=meta)
    n = sum(int(np.prod(a.shape)) for a in _flatten(params).values())
    hint = (f"; set model.visual.conv_mode={mode} to load it"
            if mode and mode != "2plus1d" else "")
    print(f"wrote {args.out_npz}: {n/1e6:.2f}M params ({args.kind}, "
          f"conv family {mode or 'n/a'}{hint})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
