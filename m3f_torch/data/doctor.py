"""Dataset pre-flight: find data problems before they become silent desyncs.

Counterpart of ``m3f/pytorch_tpu/data/doctor.py`` (same rows, same return
code; ``tests/test_torch_doctor.py``). Wavs at the wrong sample rate,
audio/frame duration drift, off-rate videos and missing crops are
per-video faults that otherwise surface one at a time, deep in a training
run. ``python -m m3f_torch.main doctor`` scans the whole ABAW tree up front
(header reads only, no JPEG or audio decode) and prints a per-video report
and a summary.

Checks per video:
  ann        annotation txt parses; row count > 0
  crops      crop dir exists; missing-crop fraction (1-based 5-digit stems)
  wav        present, mono, sample rate == mel.sample_rate
  duration   |wav_duration − n_frames/fps_derived| (always ~0 by
             construction when fps derives from the wav; reported for
             container-probed / fallback rates where it is informative)
  fps        derived rate (container → rows/wav-duration → default), with
             the off-rate flag when it escapes the half-hop snap band
"""

from __future__ import annotations

import json
import os
import wave
from typing import Dict, List

from m3f_torch.config import ExperimentConfig
from m3f_torch.data.affwild2 import AffWild2Dataset


def check_video(ds: AffWild2Dataset, vid: str) -> Dict:
    """Header-only checks for one video; returns a report row."""
    row: Dict = {"video": vid, "errors": [], "warnings": []}
    cfg, mel = ds.cfg, ds.mel

    # annotations / timeline length (test split: crop-stem/container count)
    try:
        n = ds.num_frames(vid)
        row["frames"] = n
        if n <= 0:
            row["errors"].append("empty timeline (no annotation rows/crops)")
    except Exception as e:  # noqa: BLE001 — report, don't crash the scan
        what = "crop dir" if ds._ann_dir is None else "annotation"
        row["errors"].append(f"{what} unreadable: {e}")
        return row

    # crop coverage (stems only, no decode)
    crop_dir = ds._crop_dir(vid)
    if not os.path.isdir(crop_dir):
        row["errors"].append("crop dir missing")
    else:
        stems = {int(os.path.splitext(f)[0])
                 for f in os.listdir(crop_dir)
                 if f.endswith(".jpg") and os.path.splitext(f)[0].isdigit()}
        missing = n - len(stems & set(range(1, n + 1)))
        row["missing_crops"] = missing
        if n and missing / n > 0.5:
            row["warnings"].append(
                f"{missing}/{n} frames have no crop (>50% dropout)")

    # wav header
    wav_path = os.path.join(cfg.root, "audio", vid + ".wav")
    if not os.path.exists(wav_path):
        row["warnings"].append("no wav (audio branch will see silence)")
    else:
        try:
            with wave.open(wav_path, "rb") as w:
                rate, ch = w.getframerate(), w.getnchannels()
                dur = w.getnframes() / float(rate)
            row["wav_seconds"] = round(dur, 3)
            if rate != mel.sample_rate:
                row["errors"].append(
                    f"wav rate {rate} != mel.sample_rate {mel.sample_rate} "
                    "(re-extract with scripts/extract_audio.py)")
            if ch != 1:
                row["errors"].append(f"wav has {ch} channels, expected mono")
        except Exception as e:  # noqa: BLE001
            row["errors"].append(f"wav unreadable: {e}")

    # frame rate + duration drift
    fps = ds.video_fps(vid, n_frames=n)
    row["fps"] = round(fps, 4)
    if fps != cfg.fps:
        row["warnings"].append(
            f"off-rate video ({fps:.3f} fps vs default {cfg.fps:g}); "
            "audio aligns to its own clock")
    if "wav_seconds" in row and fps > 0:
        drift = abs(row["wav_seconds"] - n / fps)
        row["duration_drift_s"] = round(drift, 3)
        if drift > 1.0:
            row["warnings"].append(
                f"wav/frame duration drift {drift:.2f}s — check the "
                "extraction or the annotation file")
    return row


def run_doctor(cfg: ExperimentConfig, splits=("train", "val", "test"),
               log=print, as_json: bool = False) -> int:
    """Scan the dataset tree; returns 0 when no video has errors."""
    total_err = total_warn = total_vids = 0
    for split in splits:
        ds = AffWild2Dataset(cfg.data, cfg.model.mel, split=split)
        ids = ds.video_ids()
        rows: List[Dict] = [check_video(ds, vid) for vid in ids]
        total_vids += len(ids)
        n_err = sum(1 for r in rows if r["errors"])
        n_warn = sum(1 for r in rows if r["warnings"] and not r["errors"])
        off_rate = sum(1 for r in rows if r.get("fps") not in
                       (None, float(cfg.data.fps)))
        total_err += n_err
        total_warn += n_warn
        if as_json:
            for r in rows:
                log(json.dumps(r))
        else:
            for r in rows:
                for e in r["errors"]:
                    log(f"  ERROR {split}/{r['video']}: {e}")
                for w in r["warnings"]:
                    log(f"  warn  {split}/{r['video']}: {w}")
        log(f"{split}: {len(ids)} videos, {n_err} with errors, "
            f"{n_warn} with warnings, {off_rate} off-rate")
    if total_vids == 0:
        log(f"no videos found under {cfg.data.root} — wrong --preset/root?")
        return 1
    return 1 if total_err else 0
