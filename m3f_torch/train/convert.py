"""Converter between the reference's torch ``state_dict`` schema and the
JAX-layout parameter tree.

Counterpart of ``m3f/pytorch_tpu/train/convert.py`` with numpy in place of
``jnp`` (``tests/test_torch_convert.py`` holds every array equal). A torch
``state_dict`` (as ``{name: numpy array}``) maps onto the nested params /
state tree of the reference's layout, which the port's checkpoints use
(``train/checkpoint.py`` reads it into the port's modules):

- ``nn.Linear``   weight [out, in]        → Dense kernel [in, out]       (transpose)
- ``nn.Conv2d``   weight OIHW             → Conv kernel HWIO             (2,3,1,0)
- ``nn.Conv3d``   weight OIDHW            → Conv kernel DHWIO            (2,3,4,1,0)
- ``nn.BatchNorm*`` weight/bias           → scale/bias; running stats → state
- ``nn.GRU``      weight_ih_l{k}[_reverse] [3H, D] → w_ih [D, 3H] (transpose;
  gate order (r, z, n) is the same)

Visual-backbone key schema follows torchvision ``video/resnet.py`` VideoResNet
(``stem.0/1/3/4``, ``layerN.M.conv1.0.0 …``) so IG-65M / Kinetics R(2+1)D-18
checkpoints convert directly. ``export_m3f`` is the inverse.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

Array = np.ndarray
SD = Mapping[str, Array]


def _j(a: Array) -> np.ndarray:
    return np.asarray(a, np.float32)


def _k(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def convert_dense(sd: SD, prefix: str) -> Dict:
    p = {"kernel": _j(sd[_k(prefix, "weight")]).T}
    if _k(prefix, "bias") in sd:
        p["bias"] = _j(sd[_k(prefix, "bias")])
    return p


def convert_conv(sd: SD, prefix: str) -> Dict:
    w = np.asarray(sd[_k(prefix, "weight")])
    if w.ndim == 4:       # OIHW → HWIO
        k = w.transpose(2, 3, 1, 0)
    elif w.ndim == 5:     # OIDHW → DHWIO
        k = w.transpose(2, 3, 4, 1, 0)
    else:
        raise ValueError(f"unsupported conv rank {w.ndim} at {prefix}")
    p = {"kernel": _j(k)}
    if _k(prefix, "bias") in sd:
        p["bias"] = _j(sd[_k(prefix, "bias")])
    return p


def convert_bn(sd: SD, prefix: str) -> Tuple[Dict, Dict]:
    params = {"scale": _j(sd[_k(prefix, "weight")]),
              "bias": _j(sd[_k(prefix, "bias")])}
    state = {"mean": _j(sd[_k(prefix, "running_mean")]),
             "var": _j(sd[_k(prefix, "running_var")])}
    return params, state


def convert_gru(sd: SD, prefix: str, num_layers: int = 1,
                bidirectional: bool = True) -> Dict:
    """torch nn.GRU state_dict → models.gru.BiGRU / GRU params."""
    def one(layer: int, rev: bool) -> Dict:
        sfx = f"l{layer}" + ("_reverse" if rev else "")
        return {
            "w_ih": _j(sd[_k(prefix, f"weight_ih_{sfx}")]).T,  # [3H, D] → [D, 3H]
            "w_hh": _j(sd[_k(prefix, f"weight_hh_{sfx}")]).T,  # [3H, H] → [H, 3H]
            "b_ih": _j(sd[_k(prefix, f"bias_ih_{sfx}")]),
            "b_hh": _j(sd[_k(prefix, f"bias_hh_{sfx}")]),
        }

    if not bidirectional:
        assert num_layers == 1, "unidirectional multi-layer not used by M3F"
        return one(0, False)
    return {"layers": [{"fwd": one(k, False), "bwd": one(k, True)}
                       for k in range(num_layers)]}


# ---------------------------------------------------------------------------
# Whole-model converters
# ---------------------------------------------------------------------------

def detect_visual_mode(sd: SD, prefix: str = "") -> str:
    """Infer the backbone conv family from the key schema.

    r2plus1d_18 has the two-conv stem (``stem.3``) and nested block convs
    (``conv1.0.0``); r3d_18 / mc3_18 share the one-conv BasicStem and plain
    ``conv1.0`` convs, distinguished by stage-2's temporal kernel extent.
    """
    pf = prefix and prefix + "."
    if f"{pf}stem.3.weight" in sd:
        return "2plus1d"
    w2 = sd.get(f"{pf}layer2.0.conv1.0.weight")
    if w2 is not None and np.asarray(w2).shape[2] == 1:
        return "mc3"
    return "3d"


def detect_blocks_per_stage(sd: SD, prefix: str = "") -> Tuple[int, ...]:
    """Infer the stage depths from ``layer{s}.{b}`` keys (18 vs 34 etc.)."""
    pf = prefix and prefix + "."

    def has_conv1(s, b):
        return (f"{pf}layer{s}.{b}.conv1.0.0.weight" in sd       # (2+1)d
                or f"{pf}layer{s}.{b}.conv1.0.weight" in sd)     # 3d / mc3

    stages = []
    s = 1
    while has_conv1(s, 0):
        b = 0
        while has_conv1(s, b):
            b += 1
        stages.append(b)
        s += 1
    if not stages:
        raise ValueError(f"no layer{{s}}.{{b}} conv keys under prefix '{prefix}'")
    return tuple(stages)


def detect_gru_layers(sd: SD, prefix: str = "") -> int:
    """Infer nn.GRU num_layers from ``weight_ih_l{k}`` keys."""
    k = 0
    while _k(prefix, f"weight_ih_l{k}") in sd:
        k += 1
    if k == 0:
        raise ValueError(f"no GRU weight keys under prefix '{prefix}'")
    return k


def convert_r2plus1d(sd: SD, prefix: str = "",
                     blocks_per_stage=None) -> Tuple[Dict, Dict]:
    """torchvision VideoResNet(R(2+1)D) state_dict → R2Plus1D (params, state).

    Key schema (torchvision video/resnet.py):
      stem.0 spatial conv, stem.1 BN, stem.3 temporal conv, stem.4 BN
      layer{s}.{b}.conv1.0.0 spatial, .conv1.0.1 BN_mid, .conv1.0.3 temporal,
      .conv1.1 BN;  conv2 likewise;  .downsample.0 conv, .downsample.1 BN

    ``blocks_per_stage=None`` auto-detects the depth from the keys, so
    depth-18 and depth-34 checkpoints both import without flags.
    """
    if blocks_per_stage is None:
        blocks_per_stage = detect_blocks_per_stage(sd, prefix)
    mode = detect_visual_mode(sd, prefix)
    pf = prefix and prefix + "."
    params = {"stem": {}, "blocks": []}
    state = {"stem": {}, "blocks": []}
    params["stem"]["conv1"] = convert_conv(sd, f"{pf}stem.0")
    params["stem"]["bn1"], state["stem"]["bn1"] = convert_bn(sd, f"{pf}stem.1")
    if mode == "2plus1d":
        params["stem"]["conv2"] = convert_conv(sd, f"{pf}stem.3")
        params["stem"]["bn2"], state["stem"]["bn2"] = convert_bn(sd, f"{pf}stem.4")

    for s, n in enumerate(blocks_per_stage, start=1):
        for b in range(n):
            base = f"{pf}layer{s}.{b}"
            bp: Dict = {}
            bs: Dict = {}
            for cname in ("conv1", "conv2"):
                if mode == "2plus1d":
                    bn_mid_p, bn_mid_s = convert_bn(sd, f"{base}.{cname}.0.1")
                    bp[cname] = {
                        "spatial": convert_conv(sd, f"{base}.{cname}.0.0"),
                        "bn_mid": bn_mid_p,
                        "temporal": convert_conv(sd, f"{base}.{cname}.0.3"),
                    }
                    bs[cname] = {"bn_mid": bn_mid_s}
                else:  # 3d / mc3: conv1.0 IS the conv, no inner BN
                    bp[cname] = convert_conv(sd, f"{base}.{cname}.0")
            bp["bn1"], bs["bn1"] = convert_bn(sd, f"{base}.conv1.1")
            bp["bn2"], bs["bn2"] = convert_bn(sd, f"{base}.conv2.1")
            if f"{base}.downsample.0.weight" in sd:
                bp["down"] = convert_conv(sd, f"{base}.downsample.0")
                bp["bn_down"], bs["bn_down"] = convert_bn(sd, f"{base}.downsample.1")
            if f"{base}.se.0.weight" in sd:
                # SE side branch (golden schema se.0 / se.2 Linear pair)
                bp["se"] = {"fc1": convert_dense(sd, f"{base}.se.0"),
                            "fc2": convert_dense(sd, f"{base}.se.2")}
            params["blocks"].append(bp)
            state["blocks"].append(bs)
    return params, state


def convert_audio_cnn(sd: SD, prefix: str = "", num_stages: int = 4) -> Tuple[Dict, Dict]:
    """Golden audio CNN (convs.{i} / bns.{i} / head) → AudioCNN (params, state)."""
    pf = prefix and prefix + "."
    params = {"conv": [], "bn": [], "head": convert_dense(sd, f"{pf}head")}
    state = {"bn": []}
    for i in range(num_stages):
        params["conv"].append(convert_conv(sd, f"{pf}convs.{i}"))
        bp, bs = convert_bn(sd, f"{pf}bns.{i}")
        params["bn"].append(bp)
        state["bn"].append(bs)
    return params, state


def convert_m3f(sd: SD, use_audio: bool = True, use_video: bool = True,
                num_gru_layers: int = None) -> Tuple[Dict, Dict]:
    """Full reference-shaped model state_dict → M3F (params, state).

    Expects submodule prefixes ``visual.'' (torchvision schema), ``audio.'',
    ``gru.'' (nn.GRU), ``head.'' (nn.Linear).  GRU layer count and backbone
    depth auto-detect from the keys when not given — a 2-layer-GRU or
    depth-34 torch checkpoint imports without flags instead of silently
    dropping layers.
    """
    if num_gru_layers is None:
        num_gru_layers = detect_gru_layers(sd, "gru")
    params: Dict = {}
    state: Dict = {}
    if use_video:
        params["visual"], state["visual"] = convert_r2plus1d(sd, "visual")
    if use_audio:
        params["audio"], state["audio"] = convert_audio_cnn(sd, "audio")
    params["gru"] = convert_gru(sd, "gru", num_layers=num_gru_layers)
    params["head"] = convert_dense(sd, "head")
    return params, state


# ---------------------------------------------------------------------------
# Export (reference layout → torch-layout numpy), the inverse of the above
# ---------------------------------------------------------------------------

def export_dense(p: Dict, prefix: str, out: Dict[str, Array]):
    out[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def export_conv(p: Dict, prefix: str, out: Dict[str, Array]):
    k = np.asarray(p["kernel"])
    if k.ndim == 4:
        out[f"{prefix}.weight"] = k.transpose(3, 2, 0, 1)
    else:
        out[f"{prefix}.weight"] = k.transpose(4, 3, 0, 1, 2)
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def export_bn(p: Dict, s: Dict, prefix: str, out: Dict[str, Array]):
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])
    out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
    out[f"{prefix}.running_var"] = np.asarray(s["var"])
    # torch BatchNorm state_dicts carry this int64 counter and a STRICT
    # load_state_dict reports it missing otherwise; 0 is torch's fresh
    # value and it only influences running stats under momentum=None
    # (which this framework's EMA-style BN never uses)
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def export_gru(p: Dict, prefix: str, out: Dict[str, Array]):
    layers = p["layers"] if "layers" in p else [{"fwd": p}]
    for k, layer in enumerate(layers):
        for key, sfx in (("fwd", f"l{k}"), ("bwd", f"l{k}_reverse")):
            if key not in layer:
                continue
            q = layer[key]
            out[_k(prefix, f"weight_ih_{sfx}")] = np.asarray(q["w_ih"]).T
            out[_k(prefix, f"weight_hh_{sfx}")] = np.asarray(q["w_hh"]).T
            out[_k(prefix, f"bias_ih_{sfx}")] = np.asarray(q["b_ih"])
            out[_k(prefix, f"bias_hh_{sfx}")] = np.asarray(q["b_hh"])


def export_r2plus1d(params: Dict, state: Dict, prefix: str = "",
                    out: Dict[str, Array] = None,
                    blocks_per_stage=None) -> Dict[str, Array]:
    """R2Plus1D (params, state) → torchvision VideoResNet state_dict arrays.

    Inverse of convert_r2plus1d; same key schema, so the result loads into
    ``torchvision.models.video.r2plus1d_18`` (or the golden) directly.

    ``blocks_per_stage=None`` derives the stage boundaries from the params:
    every stage after the first begins with a projection-shortcut block
    ("down" present), so depth-18 and depth-34 trees both export with
    correct ``layer{s}.{b}`` keys (a hardcoded (2,2,2,2) silently scrambled
    deeper backbones).
    """
    out = {} if out is None else out
    if blocks_per_stage is None:
        stages, count = [], 0
        for i, bp in enumerate(params["blocks"]):
            if i > 0 and "down" in bp:
                stages.append(count)
                count = 0
            count += 1
        stages.append(count)
        blocks_per_stage = tuple(stages)
    pf = prefix and prefix + "."
    export_conv(params["stem"]["conv1"], f"{pf}stem.0", out)
    export_bn(params["stem"]["bn1"], state["stem"]["bn1"], f"{pf}stem.1", out)
    if "conv2" in params["stem"]:      # (2+1)d two-conv stem
        export_conv(params["stem"]["conv2"], f"{pf}stem.3", out)
        export_bn(params["stem"]["bn2"], state["stem"]["bn2"], f"{pf}stem.4", out)
    flat = list(zip(params["blocks"], state["blocks"]))
    i = 0
    for s, n in enumerate(blocks_per_stage, start=1):
        for b in range(n):
            bp, bs = flat[i]
            i += 1
            base = f"{pf}layer{s}.{b}"
            for cname in ("conv1", "conv2"):
                if "spatial" in bp[cname]:     # factorized (2+1)d unit
                    export_conv(bp[cname]["spatial"], f"{base}.{cname}.0.0", out)
                    export_bn(bp[cname]["bn_mid"], bs[cname]["bn_mid"],
                              f"{base}.{cname}.0.1", out)
                    export_conv(bp[cname]["temporal"], f"{base}.{cname}.0.3", out)
                else:                           # plain 3d / no-temporal conv
                    export_conv(bp[cname], f"{base}.{cname}.0", out)
            export_bn(bp["bn1"], bs["bn1"], f"{base}.conv1.1", out)
            export_bn(bp["bn2"], bs["bn2"], f"{base}.conv2.1", out)
            if "down" in bp:
                export_conv(bp["down"], f"{base}.downsample.0", out)
                export_bn(bp["bn_down"], bs["bn_down"],
                          f"{base}.downsample.1", out)
            if "se" in bp:
                export_dense(bp["se"]["fc1"], f"{base}.se.0", out)
                export_dense(bp["se"]["fc2"], f"{base}.se.2", out)
    return out


def export_audio_cnn(params: Dict, state: Dict, prefix: str = "",
                     out: Dict[str, Array] = None) -> Dict[str, Array]:
    """AudioCNN (params, state) → golden-schema state_dict arrays."""
    out = {} if out is None else out
    pf = prefix and prefix + "."
    for i, (cp, bp, bs) in enumerate(zip(params["conv"], params["bn"],
                                         state["bn"])):
        export_conv(cp, f"{pf}convs.{i}", out)
        export_bn(bp, bs, f"{pf}bns.{i}", out)
    export_dense(params["head"], f"{pf}head", out)
    return out


def export_m3f(params: Dict, state: Dict) -> Dict[str, Array]:
    """Full M3F (params, state) → reference-shaped torch state_dict arrays.

    Inverse of convert_m3f ("checkpoint-compatible weights" both ways).
    """
    out: Dict[str, Array] = {}
    if "visual" in params:
        export_r2plus1d(params["visual"], state["visual"], "visual", out)
    if "audio" in params:
        export_audio_cnn(params["audio"], state["audio"], "audio", out)
    export_gru(params["gru"], "gru", out)
    export_dense(params["head"], "head", out)
    return out
