"""ctypes bindings of the port's native JPEG loader, and a prefetching batch
pipeline.

Counterpart of ``m3f/pytorch_tpu/data/native_loader.py``:

- ``decode_jpeg_batch``: one ctypes call into ``csrc/loader.cc`` decodes and
  resizes a whole batch on a C++ thread pool, with the GIL released for the
  whole call;
- ``Prefetcher``: a background thread keeps ``depth`` ready batches in a
  bounded queue, so host decode overlaps the card's steps.

The library is the port's own, built on first use with ``g++ -O3
-std=c++17 -fPIC -pthread -shared`` into ``build/loader/`` at the
repository root, its file name keyed by a hash of the source and the flags
(an edited source builds anew). ``backend()`` says which decoder it was
built with:

- ``libjpeg`` where ``jpeglib.h`` is on the compiler's path (``-ljpeg``):
  the reference's decode, bit for bit on the same libjpeg;
- ``own`` where it is not (``-DM3F_LOADER_OWN``; the card's hosts ship no
  libjpeg headers): the port's own baseline decoder, libjpeg's decode bit
  for bit on sequential Huffman 8-bit grey / YCbCr streams (the crops of
  the ABAW distribution). A batch holding any other stream (progressive,
  ...) raises ``RuntimeError`` naming it rather than decode it
  differently;
- ``cv2`` without ``g++``: the reference's cv2 path, with a notice.

``M3F_LOADER_SO`` names a prebuilt library to load instead. A build that
was tried and failed raises with the compiler's output, and a library that
was built or named but does not load or fails its self test raises with
its path; neither falls back to cv2.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "loader"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_checked = False
_backend = ""


def _has_header(cxx: str, header: str) -> bool:
    probe = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                           input=f"#include <cstdio>\n#include <{header}>\n".encode(),
                           stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return probe.returncode == 0


def _toolchain() -> Optional[Tuple[str, str, Tuple[str, ...]]]:
    """(decoder, compiler, flags after the source) of the build this host
    can make: libjpeg when ``jpeglib.h`` is found, else the port's own
    decoder; None without ``g++``."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    if _has_header(cxx, "jpeglib.h"):
        return "libjpeg", cxx, ("-ljpeg",)
    return "own", cxx, ("-DM3F_LOADER_OWN",)


def _lib_path(libs: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()
                       + " ".join(CXX_FLAGS + libs).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libm3f_loader_{h}.so"


def build() -> Optional[Path]:
    """Build ``csrc/loader.cc`` for this host's decoder (``_toolchain``)
    unless it is built already; the library's path, or None when this host
    cannot build it. A failed compile raises ``RuntimeError`` with the
    compiler's output."""
    global _backend
    chain = _toolchain()
    if chain is None:
        return None
    decoder, cxx, libs = chain
    path = _lib_path(libs)
    _backend = decoder
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp, *libs]
    out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the JPEG loader failed ({' '.join(cmd)}):"
                           f"\n{out.stdout.decode(errors='replace')}")
    os.replace(tmp, path)
    return path


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked, _backend
    if _lib_checked:
        return _lib
    # the env is read here (not at import), so setting it later still works;
    # a named library that does not exist is a deployment mistake: say so
    override = os.environ.get("M3F_LOADER_SO", "")
    if override and not os.path.exists(override):
        print(f"WARNING: M3F_LOADER_SO={override} does not exist; "
              f"falling back to the port's own build / cv2", flush=True)
        override = ""
    path = os.path.abspath(override) if override else build()
    if path is None:
        print("WARNING: this host cannot build the JPEG loader (no g++); "
              "decoding with cv2", flush=True)
        _lib_checked, _backend = True, "cv2"
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"the JPEG loader {path} does not load: {e}") from e
    test = getattr(lib, "m3f_loader_self_test", None)
    if test is None or test() != 42 or not hasattr(lib, "m3f_decode_jpeg_batch"):
        raise RuntimeError(f"the JPEG loader {path} fails its self test")
    lib.m3f_decode_jpeg_batch.restype = ctypes.c_int
    lib.m3f_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    if override:
        _backend = "M3F_LOADER_SO"
    _lib, _lib_checked = lib, True
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


def backend() -> str:
    """The decoder ``decode_jpeg_batch`` uses: ``libjpeg``, ``own``,
    ``M3F_LOADER_SO`` (a prebuilt library) or ``cv2``."""
    _load_lib()
    return _backend


def _present(paths: Sequence[str]) -> list:
    """``paths`` with "" for each file that does not exist, from one
    listing of each directory rather than a stat a path (slow where system
    calls are, as on the card's hosts: ``scripts/loader_bench.py``)."""
    listed = {}
    for d in {os.path.dirname(p) for p in paths if p}:
        try:
            listed[d] = set(os.listdir(d or "."))
        except OSError:
            listed[d] = set()
    return [p if p and os.path.basename(p) in listed[os.path.dirname(p)]
            else "" for p in paths]


def decode_jpeg_batch(paths: Sequence[str], size: int,
                      n_threads: int = 0,
                      out: Optional[np.ndarray] = None) -> tuple:
    """Decode and resize a batch of JPEGs → (uint8 [n, size, size, 3] RGB,
    ok mask). A missing or undecodable file gives a zeroed slot with
    ok=False (the caller marks those frames invalid). A stream the ``own``
    decoder does not take raises ``RuntimeError`` naming it."""
    n = len(paths)
    if out is None:
        out = np.empty((n, size, size, 3), dtype=np.uint8)
    lib = _load_lib()
    paths = _present(paths)
    if lib is not None:
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        ok_u8 = np.zeros(n, dtype=np.uint8)
        n_threads = n_threads or min(8, os.cpu_count() or 1)
        lib.m3f_decode_jpeg_batch(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            size, size, n_threads,
            ok_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        declined = [paths[i] for i in np.flatnonzero(ok_u8 == 2)]
        if declined:
            raise RuntimeError(
                f"the port's own JPEG decoder (this host has no libjpeg "
                f"headers) takes only sequential 8-bit grey / YCbCr JPEGs; "
                f"{len(declined)} of the batch are not, e.g. {declined[:3]}")
        return out, ok_u8.astype(bool)
    ok = np.ones(n, dtype=bool)
    import cv2
    for i, p in enumerate(paths):
        img = cv2.imread(p, cv2.IMREAD_COLOR) if p else None
        if img is None:
            out[i] = 0
            ok[i] = False
            continue
        if img.shape[:2] != (size, size):
            img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
        out[i] = img[..., ::-1]  # BGR → RGB
    return out, ok


class Prefetcher:
    """Background-thread prefetch of an iterator through a queue of at most
    ``depth`` items. An error of the producer is raised on the consumer side
    when it reaches that point of the stream; ``close()`` stops the producer
    even when it is blocked on a full queue."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._run, args=(it,), daemon=True)
        self._thread.start()

    def _run(self, it):
        try:
            for item in it:
                # a bounded put, so close() can interrupt a producer blocked
                # on a full queue (the consumer stopped early)
                while not self._stop:
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop:
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            while not self._stop:
                try:
                    self._q.put(self._DONE, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop:
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the producer thread and drop its buffered batches;
        idempotent, and the Prefetcher is unusable after."""
        self._stop = True
        for _ in range(2):           # once to unblock, once after it exits
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5.0)
