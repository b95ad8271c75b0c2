"""What every run shares: the cell's files, the program's configuration,
seeds, the weights made from the seed, the device line and the guards.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<name>.json``: the model as it is run, and the
limits of ``correct`` for each runner that runs it) and a traffic mix
(``traffic/<name>.json``: the runner that generates it, the program's
preset and the mix's parameters). The program's configuration
is the mix's preset with the configuration's model and the mix's
overrides applied. Per-layer metrics are ``metrics/<name>.py``, each with
``read(run) -> float | None``.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "m3f")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: str, name: str) -> Cell:
    """The workload ``name`` of ``<root>/BENCHMARK.json`` with its
    configuration and traffic files, and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if name in m.get("workloads", ())
           or ("workloads" not in m and m["moves"] in names)]
    return Cell(name, w["chips"], config, traffic, e2e, per)


def program_config(cell: Cell, extra: Optional[dict] = None):
    """The program's ``ExperimentConfig`` for the cell: the mix's preset,
    the configuration's model, the mix's overrides, then ``extra``."""
    from m3f_torch import config
    cfg = config.PRESETS[cell.traffic["preset"]]()
    flat = _flatten("model", cell.config["model"])
    flat.update(cell.traffic.get("overrides", {}))
    flat.update(extra or {})
    return config.apply_overrides(cfg, flat)


def checks(values: Dict[str, float], cell: Cell) -> Dict[str, Dict[str, float]]:
    """Each number compared for ``correct`` beside its limit: the limits
    the cell's configuration sets for the cell's runner."""
    limits = cell.config["limits"][cell.traffic["runner"]]
    return {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}


def _flatten(prefix: str, d: dict) -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}"
        if isinstance(v, dict):
            out.update(_flatten(key, v))
        else:
            out[key] = v
    return out


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    h = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def process_start() -> float:
    """The wall-clock time this process started (its set-up begins there)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def require_cards(chips: int) -> None:
    """Exit without a result unless ``chips`` CUDA cards are visible."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), found {n}",
              file=sys.stderr)
        raise SystemExit(2)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``m3f_torch`` is not ``m3f``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[float]:
    """The card's power limit in W, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def device_line(chips: int, peak: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak),
            "power_limit_w": power_limit()}


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, Any]:
    """Random weights of the model from ``seed``, made on ``device`` in one
    draw: every conv and Dense kernel and GRU matrix uniform with variance
    1 / fan-in, biases uniform within 1 / sqrt(fan-in), BatchNorm scales in
    [0.8, 1.2] and shifts in [-0.1, 0.1], except the scale of each residual
    branch's last BatchNorm, in [0.2, 0.4] (a trained ResNet's damped
    residual branches; at 1 each block amplifies rounding, and bf16 reads
    nearly the float8 control's gap); running statistics 0 and 1 until
    ``calibrate`` sets them. All float32."""
    import math

    import torch
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for name, shape in shapes.items():
        k = math.prod(shape)
        x = u[off:off + k].view(shape)
        off += k
        base, _, leaf = name.rpartition(".")
        if leaf == "scale" and ".blocks." in name and base.endswith(".bn2"):
            x = 0.3 + 0.1 * x          # a residual branch's last BatchNorm
        elif leaf == "scale":
            x = 1.0 + 0.2 * x
        elif leaf == "mean":
            x = torch.zeros_like(x)
        elif leaf == "var":
            x = torch.ones_like(x)
        elif leaf == "bias" and base + ".scale" in shapes:
            x = 0.1 * x
        elif leaf == "bias":
            x = x / math.sqrt(shapes[base + ".kernel"][0])
        elif leaf in ("weight", "kernel", "w_ih", "w_hh"):
            fan_in = math.prod(shape[1:]) if leaf == "weight" else shape[0]
            x = x * math.sqrt(3.0 / fan_in)
        elif leaf in ("b_ih", "b_hh"):
            x = x / math.sqrt(shape[0] // 3)
        else:
            raise ValueError(f"no rule to make weight {name} {shape}")
        out[name] = x.contiguous()
    return out


def calibrate(weights: dict, model: dict, seed: int, device,
              clips: int = 16) -> None:
    """Set every BatchNorm's running statistics, in place, to the batch
    statistics of a seeded batch of the traffic's kind (uniform uint8
    clips, Gaussian wav of std 0.1) through the plain reference, as a
    trained model's would be: eval then sees normalised activations."""
    import torch

    from portbench.reference.model import Net
    frames, size = model["visual"]["frames"], model["visual"]["size"]
    spw = (model["audio"]["mel_frames_per_window"] - 1) \
        * model["mel"]["hop_length"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "calib"))
    video = torch.randint(0, 256, (clips, frames, size, size, 3),
                          dtype=torch.uint8, generator=g, device=device)
    wav = 0.1 * torch.randn(clips, spw, generator=g, device=device)
    rec: Dict[str, tuple] = {}
    with torch.no_grad(), fp32_exact():
        net = Net(weights, model, train=True, record=rec)
        net.visual(video)
        net.audio(wav)
    for name, (mean, var) in rec.items():
        weights[name + ".mean"] = mean.clone()
        weights[name + ".var"] = var.clone()


class fp32_exact:
    """TF32 off in cuDNN and cuBLAS while inside (the reference's products
    and convolutions in full float32)."""

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
            self.saved


@dataclass
class Run:
    """What a runner hands back: the end-to-end values, the work done in the
    window, the comparison's numbers and what the readers need."""
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    memory_peak: int
    e2e: Dict[str, float]
    checks: Dict[str, Dict[str, float]]
    model: dict
    counts: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None
    host: Dict[str, Any] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            c["value"] <= c["limit"] for c in self.checks.values())


def read_per_layer(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    """Each per-layer metric's reader (``metrics/<name>.py``) on ``run``;
    a reader that finds nothing returns None and its metric is left out."""
    out = {}
    for m in metrics:
        path = os.path.join(HERE, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is None:
            print(f"portbench: metric {m['name']} found nothing to read",
                  file=sys.stderr)
        else:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def runner(name: str):
    return importlib.import_module(f"portbench.runners.{name}")
