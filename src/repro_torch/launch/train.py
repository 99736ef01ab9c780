"""End-to-end LM training driver; the port of ``repro.launch.train``.

Builds the model for ``--arch`` (optionally the reduced smoke config) on one
device, the synthetic data pipeline, and a checkpointed, fault-tolerant
training loop (auto-resume from the latest checkpoint, straggler monitor,
crash journal). Weights are drawn from ``--seed`` (a ``torch.Generator`` on
the device). Runs on the card unless given ``--device cpu``.

Under ``torchrun`` it trains on a ``data x model`` mesh of the job's ranks
(``--data-par 0``: the world over ``--model-par``; ``--dist-backend`` as
in ``serve_llm``): parameters, gradients and moments sharded with the
reference's rules, each data shard taking its rows of every global batch.
A world of another size is refused on every rank. Only rank 0 prints and
writes ``--metrics-out`` and the journal; every rank takes part in a
checkpoint, which rank 0 writes in the one-device format (a run resumes on
another mesh).

Each step waits for its loss, as the reference blocks on it, to time the
step; nothing else is read back except the metrics of a logged step.

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
      --steps 200 --global-batch 8 --seq 128 --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2-1.5b --reduced --steps 20 --model-par 2 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from ..configs.registry import get_arch
from ..data.synthetic import SyntheticConfig, SyntheticDataset
from ..device import resolve_device
from ..models.parallel import collective_bytes, reset_collectives
from ..models.transformer import Model
from ..optim import adamw
from ..train.checkpoint import CheckpointManager
from ..train.fault_tolerance import RunJournal, StragglerMonitor
from . import dist as launch_dist
from .mesh import join_lm_mesh, print_peaks
from .steps import build_model, make_train_step


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
    collective_bytes: List[int] = field(default_factory=list)  # a step's, this rank's

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
    ap.add_argument("--data-par", type=int, default=0,
                    help="0 = the one device, or under torchrun the world over --model-par")
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="on a mesh: the process group's backend (nccl on cuda, one rank per "
                         "card; gloo on cpu)")
    args = ap.parse_args(argv)
    launched = all(v in os.environ for v in launch_dist.TORCHRUN_VARS) and \
        int(os.environ["WORLD_SIZE"]) > 1
    ctx = mesh = None
    if args.data_par > 1 or args.model_par > 1 or (args.data_par == 0 and launched):
        ctx, mesh = join_lm_mesh(ap, args.arch, args.data_par, args.model_par, args.dist_backend,
                                 args.device, "repro_torch.launch.train")
    elif args.dist_backend is not None:
        ap.error("--dist-backend needs a mesh: --data-par or --model-par above 1, under torchrun")
    try:
        # only rank 0 prints and writes the metrics and the journal
        quiet = ctx is not None and ctx.rank != 0
        with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
            return _train(args, ctx, mesh, writer=not quiet)
    finally:
        if ctx is not None:
            ctx.close()


def _train(args, ctx, mesh, writer: bool) -> TrainRun:
    device = resolve_device(args.device) if ctx is None else ctx.device
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if mesh is not None:
        print(f"mesh: data {mesh.shape[0]} x model {mesh.shape[1]} on {ctx.world} ranks "
              f"({ctx.backend})")
    model = build_model(cfg, device, torch.Generator(device=device).manual_seed(args.seed),
                        mesh=mesh)

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
            if writer:
                n_restarts = journal.mark_restart()
                print(f"[resume] from step {latest} (restart #{n_restarts})")

    monitor = StragglerMonitor()
    out = TrainRun(model=model, opt_state=opt_state, start_step=start_step)
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(step).items()}
        reset_collectives()
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _sync(device)  # the reference's block_until_ready(metrics["loss"])
        dt = time.time() - t0
        out.collective_bytes.append(collective_bytes())
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
            if writer:
                journal.update(step + 1)
    if ckpt:
        ckpt.save(args.steps, {"params": params, "opt": opt_state}, blocking=True)
        if writer:
            journal.update(args.steps)
    total = time.time() - t_start
    tok_s = (args.steps - start_step) * args.global_batch * args.seq / max(total, 1e-9)
    print(f"done: {args.steps - start_step} steps in {total:.1f}s "
          f"({tok_s:,.0f} tok/s); stragglers flagged: {monitor.flagged}")
    if mesh is not None:
        print("collective bytes per rank a step: "
              + ", ".join(str(b) for b in out.collective_bytes))
        print_peaks(device)
    if args.metrics_out and writer:
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
