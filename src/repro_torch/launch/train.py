"""End-to-end LM training driver; the port of ``repro.launch.train``.

Builds the model for ``--arch`` (optionally the reduced smoke config) on one
device, the synthetic data pipeline, and a checkpointed, fault-tolerant
training loop (auto-resume from the latest checkpoint, straggler monitor,
crash journal). Weights are drawn from ``--seed`` (a ``torch.Generator`` on
the device). Runs on the card unless given ``--device cpu``. Data and
model parallelism over ranks (``--data-par``/``--model-par`` above 1) are
not ported yet: :class:`~repro_torch.launch.steps.ParallelismNotPorted`.

Each step waits for its loss, as the reference blocks on it, to time the
step; nothing else is read back except the metrics of a logged step.

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
      --steps 200 --global-batch 8 --seq 128 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from ..configs.registry import get_arch
from ..data.synthetic import SyntheticConfig, SyntheticDataset
from ..device import resolve_device
from ..models.transformer import Model
from ..optim import adamw
from ..train.checkpoint import CheckpointManager
from ..train.fault_tolerance import RunJournal, StragglerMonitor
from .steps import ParallelismNotPorted, build_model, make_train_step


@dataclass
class TrainRun:
    """What :func:`run` leaves: ``logged`` (each logged step's ``step``,
    ``dt`` and every metric as a float), the model and optimizer state at
    the end, the first step this call ran, tokens per second and the
    flagged stragglers."""

    model: Model
    opt_state: adamw.AdamWState
    start_step: int
    logged: List[Dict] = field(default_factory=list)
    tok_per_s: float = 0.0
    stragglers: List[int] = field(default_factory=list)

    @property
    def history(self) -> List[Dict]:
        """The reference's history: ``step``, ``loss`` and ``dt`` a logged step."""
        return [{"step": h["step"], "loss": h["loss"], "dt": h["dt"]} for h in self.logged]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> TrainRun:
    """Parse ``argv`` and train; returns the :class:`TrainRun`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data-par", type=int, default=0, help="0 = the one device")
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.data_par > 1 or args.model_par > 1:
        raise ParallelismNotPorted(
            f"--data-par {args.data_par} --model-par {args.model_par}: training over ranks "
            "is A14c of the port's roadmap; run with --data-par 0 or 1 and --model-par 1")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device, torch.Generator(device=device).manual_seed(args.seed))

    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps
    )
    params = dict(model.named_parameters())
    opt_state = adamw.init(opt_cfg, params)

    data = SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.global_batch, seed=args.seed,
    ))
    step_fn = make_train_step(model, opt_cfg, args.microbatches)

    start_step = 0
    ckpt = None
    journal = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        journal = RunJournal(os.path.join(args.ckpt_dir, "journal.json"))
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, {"params": params, "opt": opt_state})
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(state["params"][name])
            opt_state = state["opt"]
            del state
            start_step = latest
            n_restarts = journal.mark_restart()
            print(f"[resume] from step {latest} (restart #{n_restarts})")

    monitor = StragglerMonitor()
    out = TrainRun(model=model, opt_state=opt_state, start_step=start_step)
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(step).items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _sync(device)  # the reference's block_until_ready(metrics["loss"])
        dt = time.time() - t0
        if monitor.record(step, dt):
            print(f"[straggler] step {step} took {dt:.3f}s "
                  f"(ewma {monitor.ewma:.3f}s) — flagged")
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics.get('grad_norm', 0)):7.3f} "
                  f"lr {float(metrics.get('lr', 0)):.2e} {dt*1000:6.0f} ms")
            out.logged.append(dict({k: float(v) for k, v in metrics.items()}, step=step, dt=dt))
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
            journal.update(step + 1)
    if ckpt:
        ckpt.save(args.steps, {"params": params, "opt": opt_state}, blocking=True)
        journal.update(args.steps)
    total = time.time() - t_start
    tok_s = (args.steps - start_step) * args.global_batch * args.seq / max(total, 1e-9)
    print(f"done: {args.steps - start_step} steps in {total:.1f}s "
          f"({tok_s:,.0f} tok/s); stragglers flagged: {monitor.flagged}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"history": out.history, "tok_per_s": tok_s,
                       "stragglers": monitor.flagged}, f)
    out.opt_state, out.tok_per_s, out.stragglers = opt_state, tok_s, monitor.flagged
    return out


def main(argv=None) -> List[Dict]:
    """The reference's entry point: trains and returns the history."""
    return run(argv).history


if __name__ == "__main__":
    main()
