"""Serving on the shardmap backend: rank 0 runs the service, every other rank
follows it, batch by batch.

In the reference one process owns every device of the bit-mesh, so a batch
is one ``run_sweep`` on a global array. In the port each device is a rank,
a process of its own (``launch/dist.py``). The queue, the batcher and the
front end live on rank 0 (:class:`~repro_torch.serve.SimulationService`
with ``backend="shardmap"``); every other rank runs :func:`follow`. For
each batch rank 0 decides alone what only it can decide (deadlines, riders
with a bad binding or measurement, the breaker) and broadcasts one
:class:`Step`: the leader's circuit with L/R/G, rank 0's admission of its
structure, the live requests' points and measurement specs, the batch's
``verify``. Then every rank calls :func:`run_step`, one function, so the
ranks cannot drift apart: the engine's build (agreed in one all-gather
before any other collective of it), the batch's rows on the rank's
``2^L`` shard through the hand kernels, one at a time (only the live
points: no bucket padding, so no ``sweep_rows_padding``), each request
measured in batch order as its row is done
(:class:`~repro_torch.sim.measure.ShardedMeasurer`), or one run for a dedup
group; the transient retry and the integrity guard decide alike on every
rank (their norms are all-reduced). A closing all-gather carries every
rank's tally. Only rank 0 builds responses.

Each rank makes its collectives on one thread: rank 0 on the service's one
worker (``workers`` must be 1), the others in :func:`follow`. Rank 0 sends
an idle step when no step has gone out for :data:`IDLE_STEP_S` (a waiting
rank would otherwise reach the group's collective timeout) and a stop step when
the service stops. A rank that dies, or an error that leaves the ranks out
of step, ends the group: :class:`RanksOutOfStep` on rank 0, the collective's
error (within the group's timeout) on the others. Nothing continues on
fewer ranks, another backend or the plain versions.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.circuit import Circuit
from ..launch.dist import INIT_TIMEOUT_S
from ..sim import collective
from ..sim.faults import FaultError

#: the figures of a rank's tally, in the order the closing all-gather sends them
TALLY = ("runs", "fused", "shm") + tuple(f"k{k}" for k in range(1, 8)) + (
    "remaps", "remap_bytes_sent", "remap_s", "execute_s", "measure_s", "ilp", "greedy", "dp",
    "shm_schedules", "cache_misses", "peak_bytes")
HISTORY = 64  # batch steps kept in the snapshot
#: rank 0 sends an idle step after this many seconds without a step: a fifth
#: of the group's collective timeout, which a follower waiting for the next
#: step would otherwise reach (a process that shortens the timeout sets it)
IDLE_STEP_S = INIT_TIMEOUT_S / 5


class RanksOutOfStep(FaultError):
    """A step failed in a way the ranks may not all have seen (a rank died,
    a collective failed or timed out, an error on one rank only): the group
    can no longer run in step, and the service stops."""


def check_shardmap_config(cfg, world: int) -> None:
    """What a shardmap service needs, checked alike on every rank: one
    worker (two would issue collectives on one group at once) and a group
    of ``2^(R+G)`` ranks for the default split."""
    if cfg.workers != 1:
        raise ValueError(f"the shardmap backend serves with workers=1 (got {cfg.workers}): "
                         "every batch runs on every rank in step, one at a time")
    if world != 1 << (cfg.R + cfg.G):
        nb = cfg.R + cfg.G
        raise ValueError(f"the shardmap backend with R={cfg.R}, G={cfg.G} runs one rank per "
                         f"device of a 2^{nb} bit-mesh: launch {1 << nb} ranks (torchrun "
                         f"--nproc-per-node {1 << nb}), not {world}")


def leader_mesh(cfg) -> "RankMesh":
    """Rank 0's :class:`RankMesh` for a shardmap service, after the checks
    every rank makes (:func:`check_shardmap_config`)."""
    from ..device import resolve_device

    in_group = dist.is_available() and dist.is_initialized()
    check_shardmap_config(cfg, dist.get_world_size() if in_group else 1 << (cfg.R + cfg.G))
    if not in_group:
        raise RuntimeError("the shardmap backend serves from rank 0 of an initialised "
                           "torch.distributed group of 2^(R+G) ranks (torchrun, or "
                           "repro_torch.sim.ranks.run_ranks), each other rank in follow()")
    if dist.get_rank() != 0:
        raise ValueError(f"rank {dist.get_rank()} follows the service (follow()); rank 0 "
                         "runs it")
    return RankMesh(resolve_device(cfg.device))


@dataclass
class RequestSpec:
    """One live request of a batch as every rank needs it: its binding
    (``{}`` in a dedup group) and its measurement spec."""

    point: Dict[str, float]
    shots: int = 0
    seed: int = 0
    marginals: Tuple = ()
    observables: Tuple = ()
    return_state: bool = False

    @property
    def wants_measure(self) -> bool:
        return bool(self.shots or self.marginals or self.observables)


@dataclass
class Step:
    """What rank 0 broadcasts: ``"batch"`` (every field), ``"idle"`` or
    ``"stop"``. ``circuit`` is the leader's: a symbolic skeleton whose
    requests carry points, or a bound circuit (a dedup group: one run)."""

    kind: str
    circuit: Optional[Circuit] = None
    L: int = 0
    R: int = 0
    G: int = 0
    admitted: bool = True
    wants_state: bool = False
    verify: bool = False
    requests: List[RequestSpec] = field(default_factory=list)

    @property
    def dedup(self) -> bool:
        return self.circuit.is_bound


@dataclass
class StepResult:
    """What a batch step gave this rank, by request index in
    ``step.requests``. ``error``: the build failed (on every rank, with one
    typed error); ``errors``: requests whose run failed (alike on every
    rank); ``results``: the measured requests (the same on every rank);
    ``amp0`` and ``states``: rank 0 only."""

    cache_hit: bool = False
    error: Optional[Exception] = None
    errors: Dict[int, Exception] = field(default_factory=dict)
    results: Dict[int, object] = field(default_factory=dict)
    amp0: Dict[int, complex] = field(default_factory=dict)
    states: Dict[int, np.ndarray] = field(default_factory=dict)
    provenance: Optional[Dict] = None
    bind_s: float = 0.0
    execute_s: float = 0.0
    measure_s: float = 0.0


class RankMesh:
    """This rank's place in the serving group (the default process group):
    the transport of its collectives, the step broadcast,
    each build's agreement, and each step's closing all-gather, whose
    figures rank 0 keeps for :meth:`snapshot` (read without a collective:
    the service's ``stats()`` runs on the event loop while a batch may be
    making collectives on the worker)."""

    def __init__(self, device):
        self.transport = collective.Transport(None, torch.device(device))
        self.rank, self.world = self.transport.rank, self.transport.world
        self.last_step_t = time.monotonic()
        self._lock = threading.Lock()
        self._steps = 0
        self._totals = np.zeros((self.world, len(TALLY)))
        self._history: deque = deque(maxlen=HISTORY)

    # ------------------------------------------------------------ steps
    def send(self, step: Step) -> None:
        """Rank 0: broadcast ``step`` to every rank."""
        dist.broadcast_object_list([step], src=0)
        self.last_step_t = time.monotonic()

    def receive(self) -> Step:
        """Ranks 1..: the next step rank 0 broadcasts (waits for it)."""
        box = [None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def agree(self, eng, error: Optional[BaseException] = None) -> None:
        """This rank's part in an engine build's agreement, made by the
        pool for every build (a hit, a failure, a new engine) with
        ``ShardMapBackend.setup``'s own turned off
        (:func:`repro_torch.sim.collective.agreement_by_caller`):
        :func:`repro_torch.sim.collective.agree_build`."""
        from ..sim.engine import _program_digest

        collective.agree_build(self.transport,
                               None if eng is None else _program_digest(eng.cc), error)

    # ------------------------------------------------------------ tally
    @staticmethod
    def counters(pool, engine=None) -> np.ndarray:
        """This process's figures now, in :data:`TALLY` order (the
        engine's runs and remaps where ``engine`` is given)."""
        from ..core import kernelization, staging
        from ..kernels import ops as kops

        c, by_k = kops.kernel_call_counts(), kops.fused_call_counts_by_k()
        tot = engine.backend.totals if engine is not None else {}
        dev = pool.device
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        return np.array(
            [tot.get("runs", 0), c["fused"], c["shm"]] + [by_k.get(k, 0) for k in range(1, 8)]
            + [tot.get("remaps", 0), tot.get("bytes_sent", 0), tot.get("seconds", 0.0), 0.0, 0.0,
               staging.SOLVER_CALLS["ilp"], staging.SOLVER_CALLS["greedy"],
               kernelization.SOLVER_CALLS["dp"], kops.SCHEDULE_CALLS["shm"],
               pool.metrics.counter("cache_misses"), peak], dtype=np.float64)

    def close_step(self, step: Step, delta: np.ndarray, trace: List[Dict]) -> None:
        """Every rank: one all-gather of the step's ``delta`` (its figures
        over the step, peak memory as it stands) and the bytes and seconds of
        each remap of its last run (``trace``, one program on every rank:
        the same length); rank 0 keeps them."""
        mine = np.concatenate([delta, np.array([[t["bytes_sent"], t["seconds"]]
                                                for t in trace], dtype=np.float64).reshape(-1)])
        parts = np.stack(self.transport.all_gather(mine))
        if self.rank:
            return
        figs, remaps = parts[:, :len(TALLY)], parts[:, len(TALLY):].reshape(self.world, -1, 2)
        record = {
            "requests": len(step.requests), "dedup": step.dedup,
            "per_rank": [_figures(f) for f in figs],
            "remaps": [{"slot": t["slot"], "m": t["m"], "permute": t["permute"],
                        "bytes_sent": [int(b) for b in remaps[:, i, 0]],
                        "seconds": float(remaps[:, i, 1].max())} for i, t in enumerate(trace)],
        }
        with self._lock:
            self._steps += 1
            record["step"] = self._steps
            peak = TALLY.index("peak_bytes")
            self._totals[:, :peak] += figs[:, :peak]
            self._totals[:, peak] = figs[:, peak]
            self._history.append(record)

    def snapshot(self) -> Dict:
        """Rank 0: every rank's figures summed over the batch steps so far
        (launches by kind, runs, remaps with their bytes and seconds,
        execute and measure seconds, solver calls, shm schedules, cache
        misses, peak device memory) and the last :data:`HISTORY` steps each
        rank's figures of each with its last run's remaps."""
        with self._lock:
            return {"world": self.world, "steps": self._steps,
                    "per_rank": [_figures(f) for f in self._totals],
                    "history": list(self._history)}


def _figures(f: np.ndarray) -> Dict:
    v = dict(zip(TALLY, f.tolist()))
    return {
        "runs": int(v["runs"]),
        "launches": {"fused": int(v["fused"]), "shm": int(v["shm"]),
                     "by_k": {k: int(v[f"k{k}"]) for k in range(1, 8) if v[f"k{k}"]}},
        "remaps": int(v["remaps"]), "remap_bytes_sent": int(v["remap_bytes_sent"]),
        "remap_s": v["remap_s"], "execute_s": v["execute_s"], "measure_s": v["measure_s"],
        "solver_calls": {k: int(v[k]) for k in ("ilp", "greedy", "dp")},
        "shm_schedules": int(v["shm_schedules"]), "cache_misses": int(v["cache_misses"]),
        "peak_bytes": int(v["peak_bytes"]),
    }


def run_step(step: Step, pool, batcher, metrics) -> StepResult:
    """Run one batch step on this rank, as every rank of the group does:
    build (or rebind) the engine with rank 0's admission, run the batch on
    the rank's shard, measure each request in batch order, close the step.
    Raises only for what the ranks may not have seen alike (the caller's
    group is then out of step)."""
    from ..sim.measure import Frame, measure_to_result, measurer_for
    from .batcher import SimRequest

    mesh = pool.mesh
    res = StepResult()
    before = mesh.counters(pool)
    leader = SimRequest(circuit=step.circuit, L=step.L, R=step.R, G=step.G)
    t0 = time.perf_counter()
    try:
        engine, res.cache_hit = pool.build(leader, step.admitted)
    except Exception as e:  # agreed: the build failed on every rank
        res.error = e
        res.bind_s = time.perf_counter() - t0
        mesh.close_step(step, _delta(mesh.counters(pool), before), [])
        return res
    res.bind_s = time.perf_counter() - t0
    # the engine's runs and remaps as they stood before this step's
    before[[TALLY.index(k) for k in ("runs", "remaps", "remap_bytes_sent", "remap_s")]] = [
        engine.backend.totals[k] for k in ("runs", "remaps", "bytes_sent", "seconds")]
    frame = engine.measurement_frame

    def measure(i: int, st: torch.Tensor) -> None:
        """Request ``i``'s measurements on its row ``st`` (this rank's shard)."""
        spec = step.requests[i]
        t0 = time.perf_counter()
        kw = dict(backend=engine.backend.name, shots=spec.shots, seed=spec.seed,
                  marginals=spec.marginals, observables=spec.observables)
        if not step.wants_state:
            res.results[i] = measure_to_result(measurer_for(st, frame, engine), **kw)
        else:
            # the logical state after the final remap: rank 0 holds amplitude 0
            whole = mesh.transport.gather_rows(st.reshape(1, -1)) if spec.return_state else None
            if mesh.rank == 0:
                res.amp0[i] = complex(st.reshape(-1)[0].item())
                if whole is not None:
                    res.states[i] = whole[0]
                    if spec.wants_measure:  # the reference measures the logical state whole
                        res.results[i] = measure_to_result(
                            measurer_for(torch.from_numpy(whole[0]), Frame.identity(engine.n)),
                            **kw)
        res.measure_s += time.perf_counter() - t0

    def timed_run(fn):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)
            res.execute_s += time.perf_counter() - t0

    with engine.lock:
        batcher._ensure_binding(engine, leader)
        if step.dedup:  # one run; every request measured on it
            reqs = [SimRequest(circuit=step.circuit, request_id=i)
                    for i in range(len(step.requests))]
            states: Dict[int, torch.Tensor] = {}
            timed_run(lambda: batcher._run_batch(
                engine, reqs, {r.request_id: {} for r in reqs}, True, step.wants_state,
                step.verify, states, res.errors, metrics))
            for i in range(len(reqs)):
                if i not in res.errors:
                    measure(i, states[i])
            del states
        else:
            # the live points row by row (the backend runs one state at a
            # time, so no bucket padding), each measured before the next runs:
            # a rank holds one row, and a row that fails past its retries
            # fails its request alone, as the reference's split would
            for i, spec in enumerate(step.requests):
                rows: Dict[int, torch.Tensor] = {}
                timed_run(lambda: batcher._run_alone(engine, i, spec.point, step.wants_state,
                                                     step.verify, rows, res.errors, metrics))
                if i in rows:
                    measure(i, rows.pop(i))
        if engine.provenance.get("degraded") or engine.provenance.get("integrity_retries"):
            res.provenance = dict(engine.provenance)
    delta = _delta(mesh.counters(pool, engine), before)
    delta[TALLY.index("execute_s")] = res.execute_s
    delta[TALLY.index("measure_s")] = res.measure_s
    mesh.close_step(step, delta, engine.backend.trace)
    return res


def _delta(after: np.ndarray, before: np.ndarray) -> np.ndarray:
    """A step's figures: each counter's growth, the peak as it stands."""
    out = after - before
    out[TALLY.index("peak_bytes")] = after[TALLY.index("peak_bytes")]
    return out


def follow(config, ctx) -> Dict:
    """Ranks 1..: run every step rank 0 broadcasts until it sends the stop
    step, on this rank's device (``ctx``, a
    :class:`~repro_torch.launch.dist.RankContext`) with the service's
    ``config``. Returns the steps run by kind. A step that fails in a way the
    ranks may not all have seen raises (the process should exit)."""
    from dataclasses import replace

    from .batcher import DynamicBatcher
    from .metrics import Metrics
    from .service import WarmPool

    cfg = replace(config, device=ctx.device)
    check_shardmap_config(cfg, ctx.world)
    metrics = Metrics()
    pool = WarmPool(cfg, metrics, RankMesh(ctx.device))
    batcher = DynamicBatcher(max_batch_size=cfg.max_batch_size, retry_max=cfg.retry_max,
                             retry_base_s=cfg.retry_base_s, retry_cap_s=cfg.retry_cap_s,
                             verify_norm=cfg.verify_norm)
    done = {"batch": 0, "idle": 0}
    while True:
        step = pool.mesh.receive()
        if step.kind == "stop":
            return done
        done[step.kind] += 1
        if step.kind == "batch":
            run_step(step, pool, batcher, metrics)
