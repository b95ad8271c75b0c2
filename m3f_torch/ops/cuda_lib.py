"""Build, load and count the port's hand-written CUDA kernels.

Each ``m3f_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, under
``build/kernels/`` at the repository root, and loaded with ``ctypes``. A
library's file name carries a hash of its source and of the compiler flags,
so an edited source builds anew and an unchanged one is reused. ``build()``
starts one ``nvcc`` per source, all at once; ``library(name)`` builds one on
first use. Nothing is built or loaded when this module is imported.

``launches`` counts kernel launches, one entry per kernel: each wrapper adds
one where it launches its kernel and nowhere else, so a caller can show that
a run went through the kernels (``reset_launches`` before, read after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
SOURCES = ("melspec", "gru", "conv_bn", "conv_bn_f32", "packed_conv")

launches: Dict[str, int] = {"melspec": 0, "melspec_dft": 0, "gru": 0,
                            "gru_stream": 0,
                            "conv_spatial": 0, "conv_temporal": 0,
                            "conv_spatial_f32": 0, "conv_temporal_f32": 0,
                            "conv_spatial_bwd_data": 0,
                            "conv_spatial_bwd_filter": 0,
                            "conv_temporal_bwd_data": 0,
                            "conv_temporal_bwd_filter": 0,
                            "conv_spatial_bwd_data_f32": 0,
                            "conv_spatial_bwd_filter_f32": 0,
                            "conv_temporal_bwd_data_f32": 0,
                            "conv_temporal_bwd_filter_f32": 0,
                            "packed_conv": 0, "ablate_slabs": 0,
                            "ablate_matmul": 0, "packed_conv_chunked": 0}

_loaded: Dict[str, ctypes.CDLL] = {}

P = ctypes.c_void_p
I = ctypes.c_int
Fl = ctypes.c_float
# C signatures of the exported entry points (every one returns cudaError_t)
SIGNATURES = {
    "melspec": {"m3f_log_mel": [P, I, I, I, P, I, I, I, I, P, P, P, P, P,
                                I, I, I, I, I, Fl, P, I, P],
                "m3f_log_mel_dft": [P, I, I, I, P, I, I, I, I, P, P, P, I, I,
                                    I, Fl, P, I, P]},
    "gru": {"m3f_gru_cluster_fwd": [P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                                    P],
            "m3f_gru_stream_fwd": [P, P, P, P, P, I, I, I, I, I, I, P]},
    "conv_bn": {"m3f_conv_unit_fwd": [P, P, P, P, P, P, P, P, I, I, I, I, I,
                                      I, I, I, I, I, I, I, P],
                "m3f_conv_unit_bwd_data": [P, P, P, P, P, P, P, P, P, P, P, P,
                                           I, I, I, I, I, I, I, I, I, I, I,
                                           I, I, P],
                "m3f_conv_unit_bwd_filter": [P, P, P, P, P, P, P, P, P, I, I,
                                             I, I, I, I, I, I, I, I, I, P]},
    "conv_bn_f32": {"m3f_conv_unit_fwd_f32": [P, P, P, P, P, P, P, P, I, I, I,
                                              I, I, I, I, P],
                    "m3f_spatial_fwd_f32": [P, P, P, P, P, P, P, P, I, I, I, I,
                                            I, I, I, I, I, P],
                    "m3f_temporal_fwd_f32": [P, P, P, P, P, P, P, P, I, I, I,
                                             I, I, I, I, I, P],
                    "m3f_conv_unit_bwd_data_f32": [P] * 12 + [I] * 7 + [P],
                    "m3f_conv_unit_bwd_filter_f32": [P] * 9 + [I] * 8 + [P],
                    "m3f_spatial_filter_f32": [P, P, P, P, P, P, P, P, P, P, I,
                                               I, I, I, I, I, I, I, I, I, P],
                    "m3f_spatial_data_f32": [P] * 13 + [I] * 10 + [P],
                    "m3f_temporal_data_f32": [P] * 12 + [I] * 9 + [P],
                    "m3f_temporal_filter_f32": [P] * 9 + [I] * 10 + [P]},
    "packed_conv": {"m3f_packed_ablate": [P, P, P, I, I, I, I, I, I, I, I, I,
                                          I, I, I, I, P],
                    "m3f_packed_conv_tma": [P, P, P, I, I, I, I, I, I, I, I, I,
                                            I, I, I, P]},
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if not path:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, one ``nvcc`` process
    each, all running at once; raise with the compiler's output on failure.
    Returns the library path of every named source."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = []
    for n in todo:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, paths[n])
        else:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n}.cu:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's guard: every tensor on the same CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
