"""Console lines and metric files of a run: JSONL and CSV always,
TensorBoard when it imports.

Counterpart of ``m3f/pytorch_tpu/utils/logging.py``. Only rank 0 writes:
rank 0 of ``torch.distributed`` when a process group is initialised, else
the one process (the reference asks ``jax.process_index()``). TensorBoard
goes through ``torch.utils.tensorboard``, which needs the ``tensorboard``
package; without it the writer keeps to JSONL and CSV, silently, as the
reference's does.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict

import torch


def process_index() -> int:
    """This process's rank in ``torch.distributed``, 0 without a group."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def console_log(msg: str) -> None:
    """Print ``msg`` on rank 0 only; with ``M3F_LOG_ALL_PROCESSES=1`` every
    other rank prints it too, prefixed with its rank."""
    idx = process_index()
    if idx == 0:
        print(msg, flush=True)
    elif os.environ.get("M3F_LOG_ALL_PROCESSES"):
        print(f"[p{idx}] {msg}", flush=True)


class MetricWriter:
    """Append scalar metrics to ``<name>.jsonl`` and ``<name>.csv`` in
    ``directory`` (and TensorBoard's ``tb/`` when available). The CSV header
    grows as new metric names appear (the file is rewritten only then); a
    resumed run adopts the header already on disk."""

    def __init__(self, directory: str, name: str = "train",
                 tensorboard: bool = True):
        self._active = process_index() == 0
        if not self._active:
            return
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self._jsonl = open(os.path.join(directory, f"{name}.jsonl"), "a")
        self._csv_path = os.path.join(directory, f"{name}.csv")
        self._csv_fields: list = []
        if os.path.exists(self._csv_path):
            try:
                with open(self._csv_path, newline="") as f:
                    self._csv_fields = list(csv.DictReader(f).fieldnames or [])
            except (OSError, csv.Error, UnicodeDecodeError):
                self._csv_fields = []
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(directory, "tb"))
            except Exception:  # noqa: BLE001 — an optional sink; a missing
                self._tb = None  # or broken tensorboard must not stop a run

    def _rewrite_csv_with_header(self):
        """Re-read the CSV and rewrite it under the grown header (rows are
        not kept in memory between writes)."""
        rows = []
        if os.path.exists(self._csv_path):
            try:
                with open(self._csv_path, newline="") as f:
                    rows = [dict(r) for r in csv.DictReader(f)]
            except (OSError, csv.Error, UnicodeDecodeError):
                rows = []
        with open(self._csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields)
            w.writeheader()
            for r in rows:
                w.writerow({k: r.get(k, "") for k in self._csv_fields})

    def write(self, step: int, metrics: Dict[str, float]):
        if not self._active:
            return
        row = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        new_keys = [k for k in row if k not in self._csv_fields]
        if new_keys:
            self._csv_fields.extend(new_keys)
            self._rewrite_csv_with_header()
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields)
            if f.tell() == 0:
                w.writeheader()
            w.writerow({k: row.get(k, "") for k in self._csv_fields})
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        if not self._active:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
