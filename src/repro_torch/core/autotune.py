"""Plan autotuner: A/B-replay candidate partition plans, keep the fastest.

The port's copy of ``repro/core/autotune.py``. The cost model — analytic
or calibrated on the card — is still a *model*; the ground truth is wall
time on the device. This module closes the loop:

1. enumerate candidate planning knobs (:func:`default_candidates` — the
   calibrated vs the analytic cost model, kernelizer method, fusion-size
   caps, ILP communication weights, pre-staging circuit optimizer on/off);
2. build an engine per candidate and **replay** the same workload end to
   end on each warm engine (:func:`autotune_engine`), best-of-N timing
   after warmup; every candidate runs through the same hand kernels;
3. pick the fastest and **alias it into the compile cache under the
   default-knob** :class:`~repro_torch.sim.engine.CircuitKey`, so every
   later ``engine_for(circuit, ...)`` call with default arguments returns
   the tuned engine — no staging or kernelization solve, no ``compile_plan``.

Winners are also registered in the in-process :data:`TUNED` table keyed by
``(CircuitKey digest, device-fingerprint digest)``.

Tuning is explicitly opt-in (it pays ~len(candidates) plan + build +
replay costs up front); nothing here runs on the default path. A candidate
engine keeps its plan, compiled program and op tables between replays, but
no state: the tuning's device peak is one run's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .circuit import Circuit
from .cost_model import CostModel, DEFAULT_COST_MODEL


@dataclass(frozen=True)
class PlanCandidate:
    """One point in the plan search space: a named knob assignment."""

    name: str
    cost_model: CostModel
    staging_method: str = "ilp"
    kernelize_method: str = "dp"
    #: run the pre-staging circuit optimizer (repro_torch.core.optimize)
    #: before planning this candidate — the replay decides whether the
    #: rewrite pays on this workload and device
    optimize: bool = False

    def describe(self) -> Dict:
        return {
            "name": self.name,
            "staging_method": self.staging_method,
            "kernelize_method": self.kernelize_method,
            "max_fusion_qubits": self.cost_model.max_fusion_qubits,
            "comm_weight": self.cost_model.comm_weight,
            "optimize": self.optimize,
        }


def default_candidates(
    base: Optional[CostModel] = None,
    R: int = 0,
    G: int = 0,
    device=None,
) -> List[PlanCandidate]:
    """The standard candidate sweep. The FIRST candidate is always the
    default configuration (the baseline every speedup is reported against):
    the cost model resolved for ``device`` with dp kernelization. The rest
    vary one axis at a time — calibrated-vs-analytic model, kernelizer
    method, the optimizer, fusion-size caps, and (only when a non-local
    tier exists) ILP comm weights."""
    from ..sim.profiler import resolve_cost_model

    resolved = base if base is not None else resolve_cost_model(device=device)
    cands = [PlanCandidate("default", resolved)]
    seen = {("ilp", "dp", resolved, False)}

    def add(name: str, cm: CostModel, sm: str = "ilp", km: str = "dp", opt: bool = False):
        if (sm, km, cm, opt) not in seen:
            seen.add((sm, km, cm, opt))
            cands.append(PlanCandidate(name, cm, sm, km, opt))

    if resolved != DEFAULT_COST_MODEL:
        add("analytic", DEFAULT_COST_MODEL)
    add("kernelize:ordered", resolved, km="ordered")
    add("kernelize:greedy", resolved, km="greedy")
    # pre-staging circuit optimizer on: fewer gates -> fewer stages/kernels,
    # but the rewrite only wins if the workload is cancellation-rich — let
    # the replay decide like every other knob
    add("optimize", resolved, opt=True)
    for cap in (2, 4):
        if cap < resolved.max_fusion_qubits:
            add(f"fusion_cap:{cap}", resolved.with_overrides(max_fusion_qubits=cap))
    if R + G > 0:
        for w in (1.0, 6.0):
            if w != resolved.comm_weight:
                add(f"comm_weight:{w:g}", resolved.with_overrides(comm_weight=w))
    return cands


@dataclass
class AutotuneResult:
    """Outcome of one tuning run — JSON-able via :meth:`to_dict` (the
    ``engine`` field carries the winner and is excluded)."""

    key_digest: str
    fingerprint: str
    chosen: str
    speedup_vs_default: float
    replay_us: Dict[str, float]
    candidates: List[Dict]
    tune_time_s: float
    cached: bool = False  # True when served from TUNED without replaying
    engine: Optional[object] = field(default=None, repr=False)

    def to_dict(self) -> Dict:
        return {
            "key_digest": self.key_digest[:12],
            "fingerprint": self.fingerprint,
            "chosen": self.chosen,
            "speedup_vs_default": self.speedup_vs_default,
            "replay_us": dict(self.replay_us),
            "candidates": list(self.candidates),
            "tune_time_s": self.tune_time_s,
            "cached": self.cached,
        }


#: (CircuitKey digest, device-fingerprint digest) -> winning AutotuneResult.
#: In-process registry: re-tuning the same request is a no-op lookup.
TUNED: Dict[Tuple[str, str], AutotuneResult] = {}


def tuned_outcomes() -> List[Dict]:
    return [r.to_dict() for r in TUNED.values()]


def clear_tuned() -> None:
    TUNED.clear()


def _default_params(circuit: Circuit) -> Dict[str, float]:
    # deterministic non-degenerate binding for symbolic circuits
    return {n: 0.1 + 0.05 * i for i, n in enumerate(circuit.param_names)}


def autotune_engine(
    circuit: Circuit,
    L: int,
    R: int = 0,
    G: int = 0,
    *,
    backend: str = "cuda",
    use_kernels: bool = True,
    peephole: bool = True,
    device=None,
    candidates: Optional[Sequence[PlanCandidate]] = None,
    repeats: int = 3,
    warmup: int = 1,
    psi0=None,
    runner: Optional[Callable] = None,
    cache=None,
    force: bool = False,
    min_speedup: float = 1.10,
    **plan_kw,
) -> AutotuneResult:
    """Tune the plan for ``circuit`` under this (backend, device, L/R/G)
    configuration and install the winner in the compile cache.

    Each candidate is planned and built fresh, warmed ``warmup`` times,
    then replayed ``repeats`` times (best-of, via ``runner(engine)`` —
    default: one full ``engine.run(psi0)``, which synchronises the device).
    The fastest engine is stored under the **default-knob**
    :class:`CircuitKey`, so a later ``engine_for(circuit, L, R, G,
    backend=..., device=...)`` with no tuning arguments is a pure cache hit:
    no staging or kernelization solve, no ``compile_plan``.

    A challenger only displaces the default plan when it wins by >=
    ``min_speedup`` at replay time (default 10%): replay timing is noisy,
    and installing a marginal winner trades a known-good plan for a coin
    flip. Results are memoized in :data:`TUNED` by ``(key digest, device
    fingerprint)``; a repeat call returns the recorded outcome without
    replaying (``force=True`` re-tunes)."""
    from ..device import resolve_device
    from ..sim import engine as se
    from ..sim.profiler import device_fingerprint, fingerprint_digest

    device = resolve_device(device)
    cache = se.DEFAULT_CACHE if cache is None else cache
    t0 = time.perf_counter()

    default_key = se.circuit_key_for(circuit, L, R, G, backend=backend,
                                     use_kernels=use_kernels, peephole=peephole,
                                     device=device, **plan_kw)
    fp = fingerprint_digest(device_fingerprint("complex64", device))
    memo_key = (default_key.digest, fp)
    prior = TUNED.get(memo_key)
    if prior is not None and not force and default_key in cache:
        return replace(prior, cached=True, engine=cache.peek(default_key))

    cands = list(candidates) if candidates is not None else (
        default_candidates(R=R, G=G, device=device))
    if not cands:
        raise ValueError("autotune_engine: empty candidate list")

    bind_params = None if circuit.is_bound else _default_params(circuit)
    if runner is None:
        def runner(eng):
            return eng.run(psi0)

    replay_us: Dict[str, float] = {}
    engines: Dict[str, object] = {}
    for cand in cands:
        eng = se.engine_for(
            circuit, L, R, G, backend=backend, use_kernels=use_kernels, peephole=peephole,
            staging_method=cand.staging_method, kernelize_method=cand.kernelize_method,
            cost_model=cand.cost_model, optimize=cand.optimize, cache=None, device=device,
            **plan_kw)
        if bind_params is not None:
            eng.bind(bind_params)
        for _ in range(max(warmup, 1)):
            runner(eng)
        best = float("inf")
        for _ in range(max(repeats, 1)):
            t = time.perf_counter()
            runner(eng)
            best = min(best, (time.perf_counter() - t) * 1e6)
        replay_us[cand.name] = best
        engines[cand.name] = eng

    # on the shardmap backend every rank replays every candidate, each timing
    # its own share: the choice reads the slowest rank's time, so every rank
    # installs the same plan (on one device the times are left as they are)
    names = list(replay_us)
    slowest = engines[names[0]].backend.slowest([replay_us[k] for k in names])
    replay_us = {k: float(v) for k, v in zip(names, slowest)}

    # hysteresis: a challenger must beat the default by >= min_speedup or
    # the default keeps the slot — replay noise must never install a plan
    # that is merely *measured* faster once but is not actually faster
    chosen = min(replay_us, key=replay_us.get)
    base_us = replay_us[cands[0].name]
    if base_us / max(replay_us[chosen], 1e-9) < min_speedup:
        chosen = cands[0].name
    winner = engines[chosen]
    result = AutotuneResult(
        key_digest=default_key.digest,
        fingerprint=fp,
        chosen=chosen,
        speedup_vs_default=base_us / max(replay_us[chosen], 1e-9),
        replay_us=replay_us,
        candidates=[c.describe() for c in cands],
        tune_time_s=time.perf_counter() - t0,
        engine=winner,
    )
    winner.provenance["autotune"] = result.to_dict()
    # plan alias: the tuned engine answers for the DEFAULT knobs from now on
    cache.put(default_key, winner)
    TUNED[memo_key] = result
    return result
