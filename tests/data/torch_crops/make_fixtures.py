"""Write the JPEG fixtures of the port's loader tests and ``chip_smoke.py``.

Sixteen seeded 112x112 face-crop stand-ins (smooth colour gradients plus
noise, ~5 KB each, encoded with cv2 at quality 90) and
``reference_decode.npz``: their decode at 112 by the JAX package's native
loader, the bytes every decode of the port is held to. Run from the
repository root (needs cv2 and ``native/loader/libm3f_loader.so``):

    python tests/data/torch_crops/make_fixtures.py
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N, SIZE = 16, 112


def image(rng: np.random.RandomState) -> np.ndarray:
    y, x = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / (SIZE - 1)
    a, b, c = rng.uniform(-1, 1, 3), rng.uniform(-1, 1, 3), rng.uniform(40, 215, 3)
    img = c + 60 * (a * x[..., None] + b * y[..., None])
    img += 25 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * (x + y))[..., None]
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> int:
    import cv2
    sys.path.insert(0, os.path.abspath(os.path.join(HERE, "..", "..", "..")))
    from m3f.pytorch_tpu.data.native_loader import (decode_jpeg_batch,
                                                     native_available)
    assert native_available(), "build native/loader first"
    rng = np.random.RandomState(17)
    paths = []
    for i in range(N):
        p = os.path.join(HERE, f"{i + 1:05d}.jpg")
        assert cv2.imwrite(p, image(rng)[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 90])
        paths.append(p)
    frames, ok = decode_jpeg_batch(paths, SIZE)
    assert ok.all()
    np.savez_compressed(os.path.join(HERE, "reference_decode.npz"),
                        frames=frames,
                        names=np.array([os.path.basename(p) for p in paths]))
    print(f"wrote {N} JPEGs ({sum(os.path.getsize(p) for p in paths)} bytes) "
          "and reference_decode.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
