"""Structured metric logging to JSONL (port of
dpot_tpu/utils/metrics_logging.py, without its TensorBoard mirror).

Scalar names are the reference's SummaryWriter tags (train_loss_step,
train_loss_full, test_loss_step_{path}, test_loss_full_{path}), so curves of
the two packages and of the reference compare directly.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Optional


class MetricWriter:
    def __init__(self, log_dir: Optional[str], echo: bool = True):
        """Scalars to log_dir/metrics.jsonl and text to log_dir/logs.txt
        (nothing without a log_dir); text is also printed when `echo` (off
        on the ranks other than 0 of a multi-process run)."""
        self.log_dir = log_dir
        self.echo = echo
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)

    def scalar(self, tag: str, value: float, step: int):
        if not self._jsonl:
            return
        v = float(value)
        # strict JSON: a non-finite value is written as null and named
        rec = {"t": time.time(), "tag": tag,
               "value": v if math.isfinite(v) else None, "step": int(step)}
        if not math.isfinite(v):
            rec["nonfinite"] = repr(v)
        self._jsonl.write(json.dumps(rec) + "\n")

    def text(self, msg: str):
        if self.echo:
            print(msg, flush=True)
        if self.log_dir:
            with open(os.path.join(self.log_dir, "logs.txt"), "a") as f:
                f.write(msg + "\n")

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
