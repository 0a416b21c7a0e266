"""Loss logging (counterpart of ``visualdet3d_tpu/utils/logger.py``):
``AverageMeter``, ``LossLogger`` and a scalar writer that uses TensorBoard
where ``torch.utils.tensorboard`` imports and a JSON-lines file
(``metrics.jsonl``) where it does not."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class MetricWriter:
    """Scalar/text writer: TensorBoard if available, JSONL fallback."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tb = None
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package
            self._jsonl = open(os.path.join(log_dir, 'metrics.jsonl'), 'a')
        else:
            self._tb = SummaryWriter(log_dir=log_dir)

    def _write(self, record: dict) -> None:
        self._jsonl.write(json.dumps({'t': time.time(), **record}) + '\n')
        self._jsonl.flush()

    def add_scalar(self, name: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)
        else:
            self._write({'name': name, 'value': float(value), 'step': int(step)})

    def add_text(self, name: str, text: str, step: int = 0):
        if self._tb is not None:
            self._tb.add_text(name, text, step)
        else:
            self._write({'name': name, 'text': text, 'step': int(step)})

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


class LossLogger:
    """Accumulate loss dicts, flush their averages to the writer."""

    def __init__(self, recorder: Optional[MetricWriter], data_split: str = 'train'):
        self.recorder = recorder
        self.data_split = data_split
        self.reset()

    def reset(self):
        self.loss_stats: Dict[str, AverageMeter] = {}

    def update(self, loss_dict: Dict[str, object]):
        for key, value in loss_dict.items():
            if key not in self.loss_stats:
                self.loss_stats[key] = AverageMeter()
            self.loss_stats[key].update(float(np.asarray(value).mean()))

    def log(self, step: int):
        if self.recorder is None:
            return
        for key, meter in self.loss_stats.items():
            self.recorder.add_scalar(f'{key}/{self.data_split}', meter.avg, step)
