"""Metric logging: JSONL always, TensorBoard when it is installed
(counterpart of ``edge_diffusion_tts_tpu/utils/logging.py``).

``metrics.jsonl`` in the run directory is the record; TensorBoard
(``torch.utils.tensorboard``, imported best-effort) is a mirror.  A metric
that is a 0-d tensor on the card is read here, at the logging cadence only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, run_dir: str, use_tensorboard: bool = True):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(run_dir, "tb"))
            except Exception:
                self._tb = None

    def write(self, step: int, metrics: Dict, prefix: str = "") -> dict:
        """Append one record; returns it (the floats written)."""
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                rec[key] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
            if self._tb is not None:
                self._tb.add_scalar(key, rec[key], int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        return rec

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
