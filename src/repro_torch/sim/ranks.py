"""Run one function on ``world`` local ranks of a gloo ``torch.distributed`` job.

The shardmap backend needs one process per device of the bit-mesh. On one
host (the CPU, or several ranks on one card over gloo) this module starts
them: :func:`run_ranks` spawns ``world`` processes (the ``spawn`` start
method), each of which joins a process group through a file rendezvous,
calls ``target(rank, *args)`` and sends back its result. Every wait is
bounded: the rendezvous has a timeout, and a run that overruns its own
``timeout`` has its processes killed and raises, so a hung collective fails
the caller instead of holding it forever. What ``target`` returns, and its
arguments, are pickled.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


_POOL_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class RanksFailed(RuntimeError):
    """A rank raised, died, or the run overran its timeout."""


def _rank_entry(target: Callable, rank: int, world: int, rendezvous: str, args: Sequence,
                results, init_timeout: float, threads: Optional[int]) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=init_timeout))
        try:
            out = target(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(target: Callable, world: int, rendezvous_dir: str, *, args: Sequence = (),
              timeout: float = 600.0, init_timeout: float = 120.0,
              threads: Optional[int] = None) -> List[Any]:
    """``[target(0, *args), ..., target(world - 1, *args)]``, each called in
    its own spawned process inside a gloo process group of ``world`` ranks
    (several ranks may share one card: NCCL would refuse them), rendezvous
    in a fresh file under ``rendezvous_dir``.
    ``target`` must be importable by the child (a module-level function).
    ``init_timeout`` bounds the rendezvous and each collective, ``timeout``
    the whole run; ``threads`` sets each rank's thread count (torch's
    intra-op pool, and BLAS and OpenMP through the children's environment).
    Raises :class:`RanksFailed` with the failing ranks' tracebacks."""
    os.makedirs(rendezvous_dir, exist_ok=True)
    rendezvous = os.path.join(rendezvous_dir, f"rendezvous-{os.getpid()}-{time.time_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(target, r, world, rendezvous, args, results,
                                                   init_timeout, threads), daemon=True)
             for r in range(world)]
    # the native thread pools (BLAS, OpenMP) size themselves when a child
    # imports them, from its environment: set it for the children only
    saved = {k: os.environ.get(k) for k in _POOL_VARS}
    if threads is not None:
        os.environ.update({k: str(threads) for k in _POOL_VARS})
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out: dict = {}
    failed: dict = {}
    deadline = time.monotonic() + timeout
    try:
        # drain the queue before joining: a child blocks on exit until its
        # result is read
        while len(out) < world and not failed:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RanksFailed(f"{world} ranks overran {timeout:.0f} s; finished: "
                                  f"{sorted(out)}")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                # a rank that died without a word (its message, if any, was
                # flushed before it exited: look once more)
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if not dead:
                    continue
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    failed.update({r: f"exited with {procs[r].exitcode}" for r in dead})
                    continue
            (out if ok else failed)[rank] = value
    finally:
        # ranks that all answered exit on their own; after a failure the
        # others may wait in a collective that never completes
        grace = 10.0 if len(out) == world else 0.0
        for p in procs:
            p.join(timeout=grace)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        if os.path.exists(rendezvous):
            os.remove(rendezvous)
    if failed:
        raise RanksFailed("\n".join(f"rank {r}:\n{tb}" for r, tb in sorted(failed.items())))
    return [out[r] for r in range(world)]
