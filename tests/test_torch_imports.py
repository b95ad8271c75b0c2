"""Import and device hygiene of the port: ``m3f_torch`` and every submodule
import without JAX or the JAX package, entry points refuse a missing GPU
instead of falling back to the CPU, and ``chip_smoke.py`` fails (printing no
result) without a GPU or without the package beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import m3f_torch
names = [m.name for m in pkgutil.walk_packages(m3f_torch.__path__, "m3f_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "m3f" or m.startswith("m3f."))
new = {"m3f_torch.main", "m3f_torch.data.affwild2", "m3f_torch.data.doctor",
       "m3f_torch.data.native_loader", "m3f_torch.data.windowing",
       "m3f_torch.train.convert", "m3f_torch.scripts.import_torch_checkpoint",
       "m3f_torch.scripts.export_torch_checkpoint",
       "m3f_torch.scripts.average_checkpoints", "m3f_torch.parallel.mesh",
       "m3f_torch.parallel.seqpar"}
assert new <= set(names), sorted(new - set(names))
print(len(names), bad)
"""

_LOADER = """
import sys
from m3f_torch.data import native_loader
assert native_loader.native_available()
maps = open("/proc/self/maps").read()
assert "libm3f_loader.so" not in maps, "loaded the JAX package's library"
assert str(native_loader.BUILD_DIR) in maps
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "m3f" or m.startswith("m3f."))
print(native_loader.backend(), bad)
"""


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 41          # every module of the port was imported
    assert bad == "[]"


def test_port_loader_is_its_own_build():
    """The data layer loads the port's loader from build/loader, never the
    JAX package's native/loader/libm3f_loader.so, and imports no JAX."""
    env = _env()
    env.pop("M3F_LOADER_SO", None)
    out = subprocess.run([sys.executable, "-c", _LOADER], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    decoder, bad = out.stdout.split()
    assert decoder in ("libjpeg", "own")        # either of the port's builds
    assert bad == "[]"


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    from m3f_torch.infer import Predictor
    from m3f_torch.models.m3f import M3F
    from m3f_torch.config import ModelConfig, fusion
    from m3f_torch.train.loop import Trainer
    if torch.cuda.is_available():
        assert Predictor().model.head.kernel.is_cuda
        assert Trainer(fusion()).model.head.kernel.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Predictor()
        with pytest.raises(RuntimeError, match="cuda"):
            M3F(ModelConfig())
        with pytest.raises(RuntimeError, match="cuda"):
            Trainer(fusion())
    assert not Trainer(fusion(), device="cpu").model.head.kernel.is_cuda


def test_chip_smoke_fails_without_gpu_or_package(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in [alone] + ([] if torch.cuda.is_available() else [REPO]):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env={k: v for k, v in os.environ.items()
                                  if k != "PYTHONPATH"},
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
