"""Fault-tolerance utilities for LM training: straggler detection and
restart bookkeeping (the twin of ``repro/train/fault_tolerance.py``).

The port keeps one copy of both classes, in :mod:`repro_torch.sim.journal`,
where the offload backend's stage checkpoints use them; this module is the
name ``launch/train.py`` imports them by.
"""

from __future__ import annotations

from ..sim.journal import RunJournal, StragglerMonitor

__all__ = ["RunJournal", "StragglerMonitor"]
