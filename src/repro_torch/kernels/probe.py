"""Card-side probes of the two hand-written kernels on the main path's ops.

    python -m repro_torch.kernels.probe [--n 30] [--L 28] [--R 2]

Plans ``ising(n)`` (the main path's circuit), compiles it on the card and
times its kernels on a random complex64 state of 2^n amplitudes:

* every ``fused`` width k of the plan: ``fused_apply`` beside one
  ``torch.matmul`` of the same product on rows that already hold the
  target bits lowest (the library yardstick; the port never calls it);
* the widest ``shm`` group, swept over its member count (a copy — one
  0-bit diagonal member —, 1, 8, all) on its own window and on the same
  members moved to the lowest bits 0..a-1: copy time against member time,
  high-bit against low-bit addressing.

Before those it runs the circuit itself: six ``run_packed`` calls, wall
time each (the first one builds what the engine and the wrappers keep
between runs).

Prints what ``ptxas`` reported for each kernel, then one line per figure.
``chip_smoke.py`` prints the same sweep as a diagnostic line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def ptxas_lines(build) -> List[str]:
    """The registers / shared memory / spill lines ``ptxas -v`` printed."""
    out = []
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                out.append(f"{name}: {line.strip()}")
    return out


def main_path_ops(engine):
    """The plan's ``fused`` ops, widest first, and its widest ``shm`` group
    (None when it has none)."""
    tops = [op for prog in engine.cc.programs for op in prog.ops]
    fused = sorted((op for op in tops if op.kind == "fused"), key=lambda op: -len(op.local_bits))
    shm = max((op for op in tops if op.kind == "shm"),
              key=lambda op: (len(op.local_bits), len(op.gates)), default=None)
    return fused, shm


def fused_rows(ops, engine, x: torch.Tensor,
               check: Optional[Callable[..., Dict]] = None,
               skip: Sequence[int] = (), ps=None) -> List[Dict]:
    """``fused_apply`` and one ``torch.matmul`` in full fp32 (TF32 off) at
    each width k of the plan that is not in ``skip``, on the first op of
    each width, with the operands of the pass ``ps`` (default: the
    engine's own run over all its shards; ``x`` holds that pass's shards).
    ``check(u, vidx, bits)``, where given, runs before the timings and its
    dict joins the row."""
    L = engine.L
    fused, _ = main_path_ops(engine)
    rows, seen = [], set(skip)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for op in fused:
            k = len(op.local_bits)
            if k in seen:
                continue
            seen.add(k)
            u, vidx = engine.consts[op.uid], engine.backend.kernel_vidx(op, ps)
            bits = op.local_bits
            row = {"k": k, "bits": list(bits), "V": int(u.shape[0])}
            if check is not None:
                row.update(check(u, vidx, bits))
            row["ms"] = time_ms(lambda: ops.fused_apply(x, u, vidx, bits, L))
            xt = x.view(-1, 1 << k)
            ut = u[0].transpose(0, 1).contiguous()
            row["matmul_ms"] = time_ms(lambda: torch.matmul(xt, ut))
            rows.append(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return rows


def _lowered(window: Sequence[int], members):
    where = {b: i for i, b in enumerate(sorted(window))}
    return ([where[b] for b in sorted(window)],
            [(kind, tuple(where[b] for b in bits), op, v) for kind, bits, op, v in members])


def shm_sweep(ops, window: Sequence[int], members, L: int, x: torch.Tensor,
              counts=(0, 1, 8, None)) -> List[Dict]:
    """``shm_apply`` on ``window`` and on the lowest a bits, with the first
    m members (``None``: all; 0: a copy, one 0-bit diagonal member of 1)."""
    vidx = members[0][3]
    ones = torch.ones(int(vidx.max()) + 1, 1, dtype=torch.complex64, device=x.device)
    copy = [("diag", (), ones, vidx)]
    rows = []
    for place, (win, mem) in (("window", (sorted(window), list(members))),
                              ("low", _lowered(window, members))):
        for m in counts:
            sub = copy if m == 0 else mem[:m] if m is not None else mem
            ms = time_ms(lambda: ops.shm_apply(x, win, sub, L))
            rows.append({"place": place, "window": win, "members": 0 if m == 0 else len(sub),
                         "ms": ms})
    return rows


def run_seconds(engine, runs: int = 6) -> List[float]:
    """Wall seconds of each of ``runs`` calls of ``engine.run_packed()``."""
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = engine.run_packed()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        del state
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--L", type=int, default=28)
    ap.add_argument("--R", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe times the CUDA kernels: it needs a CUDA device")
    from ..core.generators import FAMILIES
    from ..core.partition import partition
    from ..sim.engine import ExecutionEngine
    from . import build, ops

    ops.load()
    for line in ptxas_lines(build):
        print(line)
    circ = FAMILIES["ising"](args.n)
    plan = partition(circ, args.L, args.R, 0)
    engine = ExecutionEngine(circ, plan, device="cuda")
    print(f"plan: {engine.op_counts()}")
    print("run_packed " + json.dumps({"seconds": run_seconds(engine)}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1 << args.n, dtype=torch.complex64, device="cuda", generator=gen)
    for row in fused_rows(ops, engine, x):
        print("fused " + json.dumps(row))
    _, shm = main_path_ops(engine)
    members = engine.backend.shm_members(shm)
    kinds = [kind for kind, _, _, _ in members]
    print(f"shm group: window {sorted(shm.local_bits)}, {len(members)} members "
          f"({kinds.count('mat')} mat, {kinds.count('diag')} diag; "
          f"bits per member {[len(b) for _, b, _, _ in members]})")
    for row in shm_sweep(ops, shm.local_bits, members, args.L, x):
        print("shm " + json.dumps(row))


if __name__ == "__main__":
    main()
