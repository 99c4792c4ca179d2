"""Training observability: loss lines on screen and in a file, rolling
means, and the error curves.

The counterpart of the JAX package's ``utils/logging.py``: the reference
logs every loss to screen and a text file and keeps rolling-1000-step
means (trainBRDF.py:296-331, utils.py:18-61).  :meth:`MetricLogger.log`
takes host floats; :meth:`MetricLogger.log_device` takes a step's detached
device scalars, stacks them on the device (no sync), and every
``flush_steps`` steps pulls one [flush_steps, K] tensor to the host and
writes the buffered lines in order: one host sync per ``flush_steps``
steps instead of one per metric a step.  The lines are the same either
way.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, Optional

import numpy as np
import torch


class MetricLogger:
    def __init__(self, log_path: Optional[str] = None, window: int = 1000,
                 flush_steps: int = 1):
        self.history: Dict[str, list] = {}
        self.window = window
        self.flush_steps = max(1, int(flush_steps))
        self._pend: list = []
        self.file = open(log_path, "a") if log_path else None

    def append(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(float(v))

    def rolling_mean(self, key: str) -> float:
        h = self.history.get(key, [])
        return float(np.mean(h[-self.window :])) if h else float("nan")

    def log(self, epoch: int, step: int, metrics: Dict[str, float]):
        self.append(metrics)
        parts = []
        for k in sorted(metrics):
            parts.append(
                f"{k} {metrics[k]:.6f} (avg {self.rolling_mean(k):.6f})"
            )
        line = f"[{epoch}/{step}] " + " | ".join(parts)
        print(line)
        if self.file:
            self.file.write(line + "\n")
            self.file.flush()

    def log_device(self, epoch: int, step: int, metrics: Dict):
        """Buffered :meth:`log` of a step's device scalars (a host
        scalar among them, such as the bilateral step's vertex counts,
        joins the others' device)."""
        keys = sorted(metrics)
        dev = metrics[keys[0]].device
        vec = torch.stack([metrics[k].detach().to(dev, torch.float32)
                           .reshape(()) for k in keys])
        self._pend.append((epoch, step, keys, vec))
        if len(self._pend) >= self.flush_steps:
            self.flush()

    def flush(self):
        if not self._pend:
            return
        if all(p[2] == self._pend[0][2] for p in self._pend):
            rows = torch.stack([v for (_, _, _, v) in self._pend]).cpu()
        else:  # mixed key sets: one pull a step
            rows = [v.cpu() for (_, _, _, v) in self._pend]
        for (epoch, step, keys, _), row in zip(self._pend, rows):
            self.log(epoch, step, dict(zip(keys, row.tolist())))
        self._pend = []

    def save_curves(self, out_dir: str, epoch: int):
        """The full error history as .npy (trainBRDF.py:386-389)."""
        self.flush()
        for k, h in self.history.items():
            np.save(osp.join(out_dir, f"{k}Error_{epoch}.npy"), np.array(h))

    def close(self):
        self.flush()
        if self.file:
            self.file.close()
