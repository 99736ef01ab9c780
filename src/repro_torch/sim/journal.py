"""Run journal and straggler monitor for the offload backend's stage
checkpoints.

(Copied from ``repro/train/fault_tolerance.py`` so this package imports
nothing of the JAX package; only the module docstring differs.)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class StragglerMonitor:
    """EWMA step-time monitor. Flags steps slower than ``threshold`` x the
    moving average."""

    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 3
    ewma: float = 0.0
    n: int = 0
    flagged: List[int] = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            self.ewma = dt if self.ewma == 0.0 else 0.5 * (self.ewma + dt)
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.flagged.append(step)
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


@dataclass
class RunJournal:
    """Crash-safe run journal: records progress so a restarted job can verify
    it resumed from the right step (and count restarts)."""

    path: str

    def read(self) -> Dict:
        if not os.path.exists(self.path):
            return {"restarts": 0, "last_step": -1}
        with open(self.path) as f:
            return json.load(f)

    def _write(self, d: Dict) -> None:
        # tmp + fsync + rename: os.replace alone is NOT crash-safe — after a
        # power loss the rename can survive while the data blocks don't,
        # leaving a truncated/empty journal. fsync the tmp file first so the
        # rename only ever publishes durable bytes.
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def update(self, step: int, **extra) -> None:
        d = self.read()
        d["last_step"] = step
        d.update(extra)
        self._write(d)

    def mark_restart(self) -> int:
        d = self.read()
        d["restarts"] = d.get("restarts", 0) + 1
        self._write(d)
        return d["restarts"]
