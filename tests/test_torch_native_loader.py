"""The port's JPEG loader (``m3f_torch/csrc/loader.cc`` built by
``m3f_torch/data/native_loader.py``) against the JAX package's
(``native/loader``): the same decode, bit for bit, of the committed
fixtures (``tests/data/torch_crops``, whose committed reference decode is
the JAX decoder's) and of images that need a resize; missing and corrupt
files give zeroed slots with ok=False; the build is keyed by the source
and refuses loudly when the compiler fails, and a library that does not
load or fails its self test raises; a host without ``jpeglib.h`` builds
the port's own baseline decoder (``-DM3F_LOADER_OWN``), which gives
libjpeg's decode bit for bit for every chroma sampling, odd sizes, grey,
restart intervals, optimized tables, another encoder's files and truncated
files, and raises on a progressive one; ``Prefetcher`` keeps order,
raises its producer's error on the consumer side and ``close()`` unblocks
a producer stuck on a full queue."""

import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from m3f.pytorch_tpu.data import native_loader as jnl
from m3f_torch.data import native_loader as tnl

FIXTURES = Path(__file__).resolve().parent / "data" / "torch_crops"
PATHS = [str(FIXTURES / f"{i:05d}.jpg") for i in range(1, 17)]


@pytest.fixture(scope="module")
def reference():
    with np.load(FIXTURES / "reference_decode.npz") as z:
        return z["frames"], [str(n) for n in z["names"]]


def test_port_builds_its_own_library():
    assert tnl.native_available() and tnl.backend() == "libjpeg"
    lib = tnl._lib_path(tnl._toolchain()[2])
    assert lib.exists() and lib.parent == tnl.BUILD_DIR
    assert "native" not in lib.parts


def test_fixtures_decode_to_the_committed_reference(reference):
    frames, names = reference
    assert names == [os.path.basename(p) for p in PATHS]
    got, ok = tnl.decode_jpeg_batch(PATHS, 112)
    want, jok = jnl.decode_jpeg_batch(PATHS, 112)
    assert ok.all() and jok.all()
    np.testing.assert_array_equal(want, frames)    # the JAX decoder's decode
    np.testing.assert_array_equal(got, frames)


@pytest.mark.parametrize("size", [56, 112, 160])
def test_resized_decode_equal(tmp_path, size):
    import cv2
    rng = np.random.RandomState(size)
    paths = []
    for i, shape in enumerate([(64, 80), (112, 112), (131, 97), (1, 5)]):
        p = str(tmp_path / f"{i}.jpg")
        assert cv2.imwrite(p, rng.randint(0, 256, shape + (3,), np.uint8))
        paths.append(p)
    got, ok = tnl.decode_jpeg_batch(paths, size, n_threads=3)
    want, jok = jnl.decode_jpeg_batch(paths, size, n_threads=3)
    assert ok.all() and jok.all()
    np.testing.assert_array_equal(got, want)


def _samples(tmp_path):
    """The fixtures plus images of every chroma sampling, odd sizes (some
    needing a resize at 112), grey, restart intervals, optimized tables,
    another encoder's (PIL) files and truncated files; and progressive
    ones, apart."""
    import cv2
    from PIL import Image
    samplings = [getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}")
                 for s in ("420", "422", "444", "440", "411")]
    rng = np.random.RandomState(5)
    paths, progressive = list(PATHS), []
    for k, (h, w) in enumerate([(113, 97), (17, 33), (3, 5), (1, 1), (2, 7)]):
        img = np.clip(rng.randn(h, w, 3) * 60 + 128, 0, 255).astype(np.uint8)
        for q in (30, 95):
            def save(tag, im=img, **flags):
                p = str(tmp_path / f"{k}_{q}_{tag}.jpg")
                params = [cv2.IMWRITE_JPEG_QUALITY, q]
                for key, v in flags.items():
                    params += [getattr(cv2, f"IMWRITE_JPEG_{key}"), v]
                assert cv2.imwrite(p, im, params)
                return p
            paths += [save(f"s{j}", SAMPLING_FACTOR=sf)
                      for j, sf in enumerate(samplings)]
            paths += [save("grey", im=img[..., 0]),
                      save("rst", RST_INTERVAL=2), save("opt", OPTIMIZE=1)]
            p = str(tmp_path / f"{k}_{q}_pil.jpg")
            Image.fromarray(img).save(p, quality=q)
            paths.append(p)
            progressive.append(save("prog", PROGRESSIVE=1))
    for src, cuts in ((PATHS[0], (200, 700, 2500)),
                      (paths[len(PATHS) + 6], (300, 900))):  # restarts
        data = open(src, "rb").read()
        for cut in cuts:
            p = str(tmp_path / f"cut{cut}.jpg")
            open(p, "wb").write(data[:cut])
            paths.append(p)
    return paths, progressive


def _no_jpeglib(monkeypatch, tmp_path):
    """This host as the card's: no jpeglib.h, so the own decoder's build."""
    monkeypatch.setattr(tnl, "_has_header", lambda cxx, h: False)
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_lib_checked", False)
    monkeypatch.delenv("M3F_LOADER_SO", raising=False)


def test_own_build_where_libjpeg_headers_are_missing(monkeypatch, tmp_path):
    """Without jpeglib.h the library is built with -DM3F_LOADER_OWN
    (another file name) and loads; with no compiler nothing is built."""
    _no_jpeglib(monkeypatch, tmp_path)
    decoder, _, flags = tnl._toolchain()
    assert (decoder, flags) == ("own", ("-DM3F_LOADER_OWN",))
    assert tnl._lib_path(flags) != tnl._lib_path(("-ljpeg",))
    assert tnl.native_available() and tnl.backend() == "own"
    assert tnl._lib_path(flags).exists()
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert tnl._toolchain() is None


def test_own_decoder_is_libjpegs(monkeypatch, tmp_path):
    """The own build gives the JAX loader's frames and ok mask bit for bit
    (libjpeg), and raises on a batch holding a progressive stream."""
    pytest.importorskip("cv2")
    paths, progressive = _samples(tmp_path)
    want = {size: jnl.decode_jpeg_batch(paths, size) for size in (112, 40)}
    _no_jpeglib(monkeypatch, tmp_path)
    for size, (frames, jok) in want.items():
        got, ok = tnl.decode_jpeg_batch(paths, size, n_threads=3)
        assert ok.tolist() == jok.tolist() and ok[:-5].all()
        np.testing.assert_array_equal(got, frames)
    with pytest.raises(RuntimeError, match=r"1 of the batch .*_prog\.jpg"):
        tnl.decode_jpeg_batch(PATHS[:2] + progressive[:1], 112)


def test_progressive_streams_decode_with_libjpeg(tmp_path):
    """The libjpeg build takes what the own decoder declines."""
    pytest.importorskip("cv2")
    _, progressive = _samples(tmp_path)
    got, ok = tnl.decode_jpeg_batch(progressive, 112)
    want, jok = jnl.decode_jpeg_batch(progressive, 112)
    assert ok.all() and jok.all()
    np.testing.assert_array_equal(got, want)


def test_own_build_missing_and_corrupt_files(monkeypatch, tmp_path):
    corrupt = str(tmp_path / "bad.jpg")
    with open(corrupt, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0not really a jpeg")
    paths = [PATHS[0], "/nonexistent/x.jpg", corrupt, "",
             str(tmp_path / "gone.jpg"), PATHS[1]]
    want, jok = jnl.decode_jpeg_batch(paths, 112)
    _no_jpeglib(monkeypatch, tmp_path)
    out = np.full((6, 112, 112, 3), 7, np.uint8)
    got, ok = tnl.decode_jpeg_batch(paths, 112, out=out)
    assert got is out and ok.tolist() == jok.tolist() == [1, 0, 0, 0, 0, 1]
    np.testing.assert_array_equal(got, want)


def test_a_library_that_does_not_load_raises(monkeypatch, tmp_path):
    """A named or built library that does not load, fails its self test or
    has no decode entry raises with its path, every time: never cv2."""
    import subprocess
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_lib_checked", False)
    junk = tmp_path / "junk.so"
    junk.write_text("not a library")
    monkeypatch.setenv("M3F_LOADER_SO", str(junk))
    for _ in range(2):
        with pytest.raises(RuntimeError, match=f"{junk} does not load: .*junk"):
            tnl.decode_jpeg_batch(PATHS[:1], 112)
    assert not tnl._lib_checked
    for k, ret in enumerate((41, 42)):      # 42, but no decode entry
        src, so = tmp_path / "lib.cc", tmp_path / f"lib{k}.so"
        src.write_text(f'extern "C" int m3f_loader_self_test() {{ return {ret}; }}\n')
        subprocess.run(["g++", "-shared", "-fPIC", str(src), "-o", str(so)],
                       check=True)
        monkeypatch.setenv("M3F_LOADER_SO", str(so))
        with pytest.raises(RuntimeError, match=f"{so} fails its self test"):
            tnl.native_available()
    monkeypatch.setenv("M3F_LOADER_SO", str(tmp_path / "b.so"))
    monkeypatch.setattr(tnl, "build", lambda: str(junk))   # a built library
    with pytest.raises(RuntimeError, match="does not load"):
        tnl.backend()


def test_missing_and_corrupt_files(tmp_path):
    corrupt = str(tmp_path / "bad.jpg")
    with open(corrupt, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0not really a jpeg")
    truncated = str(tmp_path / "trunc.jpg")
    with open(truncated, "wb") as f:
        f.write(open(PATHS[0], "rb").read()[:200])
    paths = [PATHS[0], "/nonexistent/x.jpg", corrupt, "", truncated, PATHS[1]]
    out = np.full((6, 112, 112, 3), 7, np.uint8)
    got, ok = tnl.decode_jpeg_batch(paths, 112, out=out)
    want, jok = jnl.decode_jpeg_batch(paths, 112)
    assert got is out
    assert ok.tolist() == jok.tolist()
    assert ok[[0, 5]].all() and not ok[[1, 2, 3]].any()
    assert (got[[1, 2, 3]] == 0).all()
    np.testing.assert_array_equal(got, want)


def test_cv2_path_only_where_the_loader_cannot_be_built(monkeypatch, tmp_path,
                                                        reference):
    """No compiler: the cv2 decode, with a notice (within
    ±2 levels of the reference); a build that runs and fails raises with
    the compiler's output."""
    pytest.importorskip("cv2")
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_lib_checked", False)
    monkeypatch.setattr(tnl, "_toolchain", lambda: None)
    got, ok = tnl.decode_jpeg_batch(PATHS[:4], 112)
    assert ok.all() and not tnl.native_available() and tnl.backend() == "cv2"
    diff = np.abs(got.astype(int) - reference[0][:4].astype(int))
    assert diff.max() <= 2
    monkeypatch.setattr(tnl, "_lib_checked", False)
    monkeypatch.setattr(tnl, "_toolchain",                   # exits 1
                        lambda: ("libjpeg", "false", ("-ljpeg",)))
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="building the JPEG loader failed"):
        tnl.decode_jpeg_batch(PATHS[:1], 112)
    with pytest.raises(RuntimeError):               # and again: never cv2
        tnl.decode_jpeg_batch(PATHS[:1], 112)


def test_env_override_is_honoured(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_lib_checked", False)
    monkeypatch.setenv("M3F_LOADER_SO", str(tmp_path / "missing.so"))
    assert tnl.native_available()          # the port's own build instead
    assert "does not exist" in capsys.readouterr().out
    built = str(tnl._lib_path(tnl._toolchain()[2]))
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_lib_checked", False)
    monkeypatch.setenv("M3F_LOADER_SO", built)
    monkeypatch.setattr(tnl, "build", lambda: pytest.fail("built anew"))
    assert tnl.native_available() and tnl.backend() == "M3F_LOADER_SO"


def test_prefetcher_order_and_exception():
    assert list(tnl.Prefetcher(iter(range(5)), depth=2)) == list(range(5))

    def boom():
        yield 1
        yield 2
        raise ValueError("producer failed")

    pf = tnl.Prefetcher(boom(), depth=1)
    assert next(pf) == 1 and next(pf) == 2
    with pytest.raises(ValueError, match="producer failed"):
        next(pf)


def test_prefetcher_close_unblocks_producer():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    pf = tnl.Prefetcher(endless(), depth=2)
    assert next(pf) == 0
    time.sleep(0.3)                       # producer now blocked on the queue
    n = len(produced)
    t0 = time.time()
    pf.close()
    assert time.time() - t0 < 3.0
    assert not pf._thread.is_alive()
    time.sleep(0.3)
    assert len(produced) <= n + 1
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()                            # idempotent


def test_prefetcher_close_after_exhaustion_and_threads():
    pf = tnl.Prefetcher(iter([1]), depth=1)
    assert list(pf) == [1]
    pf.close()
    assert not any(t is pf._thread for t in threading.enumerate())
