"""The per-layer readers' arithmetic, shared by the files of ``metrics/``.

Each reader takes a runner's ``harness.Run`` and returns the metric, or None
where the run has nothing to read (no trace, no launch of the layer's
kernels): the metric is then left out of the result line.
"""

from __future__ import annotations

import os
from typing import Optional

from portbench import work
from portbench.devtrace import _short, kernel_names

# The fused conv units' kernels (rows 3-8, m3f_torch/csrc/conv_bn.cu): the
# forward, data- and filter-gradient walks and their channel-sum passes.
CONV_UNIT_KERNELS = frozenset((
    "spatial_fwd_kernel", "temporal_fwd_kernel", "spatial_data_kernel",
    "spatial_filter_kernel", "temporal_data_kernel", "temporal_filter_kernel",
    "colsum_kernel", "slice_sum_kernel"))


def _geometry(run):
    v = run.model["visual"]
    return v, v["frames"], v["size"]


def idle_share(run) -> Optional[float]:
    """100 x (1 - device busy / window), busy the union of the trace's
    device intervals."""
    if run.trace is None:
        return None
    busy = run.trace.busy_s()
    return 100.0 * (1.0 - busy / run.window_s) if busy > 0 else None


def mfu_serve(run) -> Optional[float]:
    """Model FLOPs of the windows scored (padding left out) over the
    window, as a share of the peak in the model's precision."""
    n = run.counts.get("windows", 0)
    if not n:
        return None
    _, frames, size = _geometry(run)
    flops = n * work.window_flops(run.model, frames, size)
    return 100.0 * flops / run.window_s / work.peak_flops(run.model)


def mfu_train(run) -> Optional[float]:
    """Model FLOPs (forward and backward) of the clips trained over the
    window, as a share of the peak in the model's precision."""
    clips = run.counts.get("steps", 0) * run.counts.get("clips_per_step", 0)
    if not clips:
        return None
    _, frames, size = _geometry(run)
    flops = clips * work.train_clip_flops(run.model, frames, size)
    return 100.0 * flops / run.window_s / work.peak_flops(run.model)


def conv_units_s(run) -> float:
    return run.trace.device_s(lambda n, op: _short(n) in CONV_UNIT_KERNELS)


def conv_units_roofline_serve(run) -> Optional[float]:
    """Least time of every unit launch of the window's forwards over their
    device time."""
    if run.trace is None:
        return None
    t = conv_units_s(run)
    v, frames, size = _geometry(run)
    bound = work.units_forward_s(v, run.counts.get("forward_clips", ()),
                                 frames, size)
    return 100.0 * bound / t if t > 0 and bound > 0 else None


def conv_units_roofline_train(run) -> Optional[float]:
    """Least time of the window's train steps' unit launches (forward, data
    and filter gradients) over their device time."""
    if run.trace is None:
        return None
    t = conv_units_s(run)
    v, frames, size = _geometry(run)
    bound = run.counts.get("steps", 0) * work.units_train_s(
        v, run.counts.get("clips_per_step", 0), frames, size)
    return 100.0 * bound / t if t > 0 and bound > 0 else None


def _port_kernels():
    import m3f_torch
    return set(kernel_names(os.path.join(os.path.dirname(m3f_torch.__file__),
                                         "csrc")))


def library_conv_ms_per_kframe(run) -> Optional[float]:
    """Device ms of the convolutions the library runs (launched under a
    host conv op: cuDNN's stem, strided, downsample and audio convs) per
    1000 frames scored."""
    if run.trace is None or not run.counts.get("frames"):
        return None
    port = _port_kernels()
    s = run.trace.device_s(lambda n, op: _short(n) not in port
                           and "conv" in op.lower())
    return 1e3 * s / (run.counts["frames"] / 1e3) if s > 0 else None


def other_device_ms_per_step(run) -> Optional[float]:
    """Device ms a train step outside the port's own kernels: library
    convs, elementwise BatchNorm and ReLU, the GRU's gradient, optimizer,
    copies."""
    if run.trace is None or not run.counts.get("steps"):
        return None
    port = _port_kernels()
    s = run.trace.device_s(lambda n, op: _short(n) not in port)
    return 1e3 * s / run.counts["steps"] if s > 0 else None

