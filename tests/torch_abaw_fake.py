"""A small fake Aff-Wild2 (ABAW) tree on disk for the port's data-layer and
CLI tests: JPEG crops written with cv2, PCM16 wavs with ``wave``, annotation
txts with -5 rows, in the challenge layout the data layer reads.

    train  vid_a   40 frames, 30 fps wav, frame 4 labelled -5, last crop missing
           vid_b   48 frames, 30 fps wav with a 60 ms tail (must read 30)
           vid_25  50 frames, a wav that makes it 25 fps
    val    vid_v   36 frames, 30 fps, frame 4 labelled -5
    test   vid_t   30 crops, no annotation, crops 11-15 missing

``add_containers`` adds MJPG containers under ``videos/`` (skipped by the
caller when cv2 has no MJPG writer).
"""

import os
import wave

import numpy as np

SR = 16_000
ANN = ("annotations", "VA_Estimation_Challenge")
TRAIN = {"vid_a": (40, 30.0, 0.0), "vid_b": (48, 30.0, 0.06),
         "vid_25": (50, 25.0, 0.0)}
VAL = {"vid_v": (36, 30.0, 0.0)}
TEST = {"vid_t": 30}
TEST_GAP = range(11, 16)          # 1-based crop stems missing in vid_t


def write_wav(path, samples, rate=SR):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())


def _crop(rng, size, i):
    y, x = np.mgrid[0:size, 0:size] / max(size - 1, 1)
    base = 60 + 120 * (0.5 + 0.5 * np.sin(0.3 * i + 3 * x + 2 * y))
    img = base[..., None] + rng.randint(-20, 21, (size, size, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _crops(cv2, root, vid, n, size, rng, skip=()):
    d = os.path.join(root, "cropped_aligned", vid)
    os.makedirs(d, exist_ok=True)
    for i in range(1, n + 1):
        if i not in skip:
            assert cv2.imwrite(os.path.join(d, f"{i:05d}.jpg"),
                               _crop(rng, size, i))


def _labelled(cv2, root, split, vid, n, fps, tail, size, rng, skip=()):
    _crops(cv2, root, vid, n, size, rng, skip)
    t = np.arange(n) / fps
    with open(os.path.join(root, *ANN, split, vid + ".txt"), "w") as f:
        f.write("valence,arousal\n")
        for i in range(n):
            if i == 3:
                f.write("-5,-5\n")
            else:
                f.write(f"{0.8 * np.sin(1.3 * t[i]):.3f},"
                        f"{0.7 * np.cos(0.9 * t[i]):.3f}\n")
    m = int(round((n / fps + tail) * SR))
    wav = 0.2 * np.sin(2 * np.pi * 440 * np.arange(m) / SR) \
        + 0.05 * rng.randn(m)
    write_wav(os.path.join(root, "audio", vid + ".wav"), wav)


def make_tree(root, size=16, seed=0):
    """Build the tree above under ``root``; returns ``root``."""
    import cv2
    rng = np.random.RandomState(seed)
    for split in ("Train_Set", "Validation_Set"):
        os.makedirs(os.path.join(root, *ANN, split), exist_ok=True)
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    for vid, (n, fps, tail) in TRAIN.items():
        _labelled(cv2, root, "Train_Set", vid, n, fps, tail, size, rng,
                  skip=(n,) if vid == "vid_a" else ())
    for vid, (n, fps, tail) in VAL.items():
        _labelled(cv2, root, "Validation_Set", vid, n, fps, tail, size, rng)
    for vid, n in TEST.items():
        _crops(cv2, root, vid, n, size, rng, skip=TEST_GAP)
        write_wav(os.path.join(root, "audio", vid + ".wav"),
                  0.1 * rng.randn(int(round(n / 30.0 * SR))))
    return root


def add_containers(root, size=16):
    """MJPG containers: vid_a at 25 fps (the container's rate wins over the
    wav's) and vid_t with 34 frames (the test timeline reaches past the
    last crop). Returns False when cv2 cannot write MJPG."""
    import cv2
    os.makedirs(os.path.join(root, "videos"), exist_ok=True)
    for vid, fps, n in (("vid_a", 25.0, 40), ("vid_t", 30.0, 34)):
        vw = cv2.VideoWriter(os.path.join(root, "videos", vid + ".avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), fps, (size, size))
        if not vw.isOpened():
            return False
        for _ in range(n):
            vw.write(np.zeros((size, size, 3), np.uint8))
        vw.release()
    return True


def narrow(root, size=16):
    """CLI overrides of a narrow fusion model (fp32) on the tree."""
    return ["data.synthetic=false", f"data.root={root}",
            f"data.image_size={size}",
            "model.visual.block_channels=[8,16]",
            "model.visual.blocks_per_stage=[2,1]",
            "model.visual.stem_channels=8", "model.visual.feature_dim=16",
            "model.audio.channels=[4,8]", "model.audio.feature_dim=8",
            "model.gru.hidden_size=8", "model.compute_dtype=float32",
            "window.windows_per_clip=2", "train.batch_size=2",
            "train.mesh.num_data=1"]
