"""Structure-keyed dynamic batching: coalesce concurrent requests into one
engine call.

Atlas front-loads all expensive planning (ILP staging, DP kernelization,
stage compilation, the kernels' shm programs) behind a *structural* key, so
at serve time requests that share a circuit structure differ only in cheap
inputs: the parameter binding. The dominant serving shape — same ansatz,
different angles, many tenants — therefore coalesces losslessly: a batch of
P structure-identical requests is ONE ``run_sweep`` over their bindings
(every compiled op one kernel launch over all P rows; the oracle test in
``tests/test_torch_serve.py`` asserts the rows equal P sequential runs),
and P fully-identical concrete requests are ONE execution fanned out to P
responses.

Components:

* :class:`SimRequest` / :class:`SimResponse` — the wire-level request shape
  (circuit or symbolic family skeleton + binding + measurement spec + tenant).
* :class:`GroupKey` — what may share an engine call: the structural
  :class:`repro_torch.sim.engine.CircuitKey` digest, plus the binding
  signature for concrete no-params requests (those dedup rather than
  sweep), plus whether the caller wants the logical state (packed vs
  final-remapped execution).
* :class:`DynamicBatcher` — pulls a fair *leader* from the admission queue,
  harvests structure-matching riders, and flushes on **max batch size** or
  the **leader's max-wait deadline**, whichever comes first. Executed batch
  sizes are padded up to power-of-two buckets, as the reference pads them,
  so a structure runs a bounded set of row counts.

The port of ``repro/serve/batcher.py``: the key is the port's
:func:`repro_torch.sim.engine.circuit_key_for` (kernels and device instead
of Pallas), a batch's rows stay on the engine's device and are measured
there, and ``execute_s`` runs to the device's last op of the batch. On the
shardmap backend rank 0 executes each batch with every other rank, as one
step (:meth:`DynamicBatcher._execute_sharded`,
:mod:`repro_torch.serve.follower`).
"""

from __future__ import annotations

import asyncio
import itertools
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.circuit import Circuit

_req_ids = itertools.count()


@dataclass
class SimRequest:
    """One simulation request.

    ``circuit`` is either a symbolic skeleton (free :class:`Param` angles)
    with ``params`` carrying the binding — the coalescible shape — or a
    fully-bound concrete circuit with ``params=None`` (identical concrete
    requests deduplicate into one execution). Measurement is per-request:
    requests in the same batch may ask for different shots/marginals/
    observables; only the *execution* is shared.
    """

    circuit: Circuit
    params: Optional[Union[Dict[str, float], Sequence[float]]] = None
    tenant: str = "default"
    shots: int = 0
    marginals: Tuple = ()
    observables: Tuple = ()
    seed: int = 0
    return_state: bool = False
    L: Optional[int] = None  # None -> service default split
    R: Optional[int] = None
    G: Optional[int] = None
    deadline_s: Optional[float] = None  # None -> service default timeout
    verify: Optional[bool] = None  # ||psi|| guard; None -> service default
    request_id: int = field(default_factory=lambda: next(_req_ids))

    # stamped by the service / batcher (monotonic clock)
    arrival_t: float = 0.0
    picked_t: float = 0.0
    deadline_t: float = 0.0  # absolute monotonic deadline (0 = none)

    @property
    def wants_measure(self) -> bool:
        return bool(self.shots or self.marginals or self.observables)

    @property
    def wants_state(self) -> bool:
        # no measurement spec -> the response carries the |0..0> overlap
        # digest off the logical state, so those requests group with the
        # state-returning ones
        return self.return_state or not self.wants_measure


@dataclass
class SimResponse:
    request_id: int
    tenant: str
    result: Optional[object] = None  # repro_torch.sim.result.SimulationResult
    state: Optional[np.ndarray] = None  # logical [2^n] on the host, when return_state
    amp0: Optional[complex] = None  # <0..0|psi> digest (always cheap)
    batch_size: int = 1
    cache_hit: bool = False
    timings: Dict[str, float] = field(default_factory=dict)
    # planning-fallback / integrity-recovery record, present only when the
    # serving engine ran off its requested configuration (see README
    # "Robustness")
    provenance: Optional[Dict] = None


@dataclass(frozen=True)
class GroupKey:
    """Requests with equal keys may share one engine call."""

    digest: str  # structural CircuitKey digest (structure + L/R/G + knobs + device)
    binding: Optional[Tuple]  # binding_signature for concrete dedup groups
    wants_state: bool


def group_key_for(req: SimRequest, *, backend: str, use_kernels: bool,
                  staging_method: str, kernelize_method: str,
                  device=None) -> GroupKey:
    """Compute the coalescing key (the request's L/R/G must already be
    resolved by the service). Parameterized requests are keyed purely by
    structure; concrete no-params requests additionally carry their binding
    signature so only *identical* circuits deduplicate."""
    from ..sim.engine import circuit_key_for

    ck = circuit_key_for(
        req.circuit, req.L, req.R, req.G, backend=backend,
        use_kernels=use_kernels, staging_method=staging_method,
        kernelize_method=kernelize_method, device=device,
    )
    binding = None
    if req.params is None and req.circuit.is_bound:
        binding = req.circuit.binding_signature()
    return GroupKey(ck.digest, binding, req.wants_state)


@dataclass
class Batch:
    key: GroupKey
    requests: List[SimRequest]
    leader_arrival: float
    formed_t: float = 0.0
    flush_reason: str = ""  # "size" | "deadline" | "drain"


def bucket_size(p: int, max_batch: int) -> int:
    """Pad a batch of ``p`` to the next power-of-two bucket (capped at
    ``max_batch``): a bounded set of row counts per structure, the
    reference's buckets."""
    assert 1 <= p <= max_batch
    b = 1
    while b < p:
        b <<= 1
    return min(b, max_batch)


class DynamicBatcher:
    """Form and execute coalesced batches.

    ``form`` is async (it waits on the arrival event up to the flush
    deadline); ``execute`` is synchronous and runs on a worker thread — it
    holds the engine lock across bind + run so concurrent batches on the
    same structure serialize safely.
    """

    def __init__(self, max_batch_size: int = 16, max_wait_s: float = 0.004,
                 retry_max: int = 2, retry_base_s: float = 0.01,
                 retry_cap_s: float = 0.25, verify_norm: bool = True):
        assert max_batch_size >= 1
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_s
        self.retry_max = retry_max
        self.retry_base_s = retry_base_s
        self.retry_cap_s = retry_cap_s
        self.verify_norm = verify_norm
        self._backoff_rng = random.Random(0)

    # ------------------------------------------------------------- forming
    async def form(self, queue, arrival: asyncio.Event,
                   draining: bool = False) -> Optional[Batch]:
        """Pop a fair leader and coalesce same-key riders until the batch is
        full (size flush) or the leader has waited ``max_wait_s`` since
        arrival (deadline flush). The deadline is anchored at the leader's
        *arrival*, not at batch formation: a request that already sat out
        its wait in a backlogged queue flushes immediately with whatever
        riders are present."""
        popped = queue.pop_fair()
        if popped is None:
            return None
        key, leader = popped
        now = time.monotonic()
        leader.picked_t = now
        batch = Batch(key=key, requests=[leader],
                      leader_arrival=leader.arrival_t)
        self._harvest(queue, batch)
        flush_at = leader.arrival_t + self.max_wait_s
        while len(batch.requests) < self.max_batch_size and not draining:
            now = time.monotonic()
            if now >= flush_at:
                batch.flush_reason = "deadline"
                break
            arrival.clear()
            try:
                await asyncio.wait_for(arrival.wait(), flush_at - now)
            except asyncio.TimeoutError:
                batch.flush_reason = "deadline"
                break
            self._harvest(queue, batch)
        if not batch.flush_reason:
            batch.flush_reason = ("size" if len(batch.requests)
                                  >= self.max_batch_size else "drain")
        batch.formed_t = time.monotonic()
        return batch

    def _harvest(self, queue, batch: Batch) -> None:
        take = self.max_batch_size - len(batch.requests)
        if take > 0:
            riders = queue.take_matching(batch.key, take)
            now = time.monotonic()
            for r in riders:
                r.picked_t = now
            batch.requests.extend(riders)
        if len(batch.requests) >= self.max_batch_size:
            batch.flush_reason = "size"

    # ----------------------------------------------------------- execution
    def execute(self, batch: Batch, pool,
                metrics) -> List[Tuple[SimRequest, Union[SimResponse, Exception]]]:
        """Run one coalesced batch: acquire/rebind the engine from the warm
        pool, execute ONE ``run_sweep`` (or one deduplicated run), then
        measure each request against its own spec. Returns, in batch order,
        ``(request, SimResponse)`` on success or ``(request, Exception)``
        when that request failed — a typed error for one request must never
        poison the rest of its fused batch:

        * a request already past its deadline is rejected with
          :class:`RequestTimeout` before any work;
        * transient execution failures (:data:`TRANSIENT_ERRORS`) retry with
          exponential backoff + jitter;
        * a fused batch whose shared run fails past retries is **split** —
          each member re-executes individually so the blast radius of a
          poison member is that member alone;
        * when norm verification is on, a non-normalized row is re-run
          through the engine's own plan and kernels; only unrecoverable
          requests fail (typed :class:`IntegrityError`).

        The batch's rows stay on the engine's device: each request is
        measured where its row lies, and only a ``return_state`` request
        copies its state to the host.
        """
        if pool.mesh is not None:
            return self._execute_sharded(batch, pool, metrics)
        reqs = batch.requests
        errors: Dict[int, Exception] = {}  # request_id -> failure
        live = self._live(reqs, errors, metrics)
        if not live:
            return self._failed(reqs, errors)

        leader = live[0]
        try:
            with metrics.timer("bind_s") as t_bind:
                engine, cache_hit = pool.acquire(leader)
        except Exception as e:
            # build failure or quarantine: fails every live member of the
            # batch — they all need this engine
            return self._failed(reqs, errors, live, e, metrics)

        verify = self._effective_verify(live)
        wants_state = batch.key.wants_state
        states: Dict[int, object] = {}  # request_id -> state (a row on the engine's device)
        with engine.lock:
            # another worker may have rebound the shared engine between our
            # pool.acquire and taking the lock — re-assert the leader's
            # binding/skeleton (no-op in the common single-worker case)
            self._ensure_binding(engine, leader)
            with metrics.timer("execute_s") as t_exec:
                dedup = batch.key.binding is not None
                # per-request binding normalization is the first blast
                # wall: a rider with a malformed parameter vector fails
                # alone, before it can poison the fused sweep
                points: Dict[int, Dict[str, float]] = {}
                for r in live:
                    try:
                        points[r.request_id] = {} if dedup else self._point(
                            engine.circuit.param_names, r)
                    except Exception as e:
                        errors[r.request_id] = e
                runnable = [r for r in live if r.request_id in points]
                self._run_batch(engine, runnable, points, dedup, wants_state, verify,
                                states, errors, metrics)
                # execute_s runs to the device's last op of the batch
                if engine.device.type == "cuda":
                    torch.cuda.synchronize(engine.device)
            frame = engine.measurement_frame
            prov = (dict(engine.provenance)
                    if engine.provenance.get("degraded")
                    or engine.provenance.get("integrity_retries") else None)

        from ..sim.measure import Frame, measure_to_result, measurer_for

        fields: Dict[int, Dict] = {}  # request_id -> its SimResponse's measured fields
        with metrics.timer("measure_s"):
            for r in live:
                if r.request_id in errors:
                    continue
                st = states[r.request_id]
                f = fields[r.request_id] = {}
                if wants_state:
                    psi = st.reshape(-1)
                    f["amp0"] = complex(psi[0].item())
                    if r.return_state:
                        f["state"] = psi.to("cpu", copy=True).numpy()
                    if r.wants_measure:
                        f["result"] = measure_to_result(
                            measurer_for(psi, Frame.identity(engine.n)),
                            backend=engine.backend.name, shots=r.shots,
                            seed=r.seed, marginals=r.marginals,
                            observables=r.observables,
                        )
                else:
                    f["result"] = measure_to_result(
                        measurer_for(st, frame, engine), backend=engine.backend.name,
                        shots=r.shots, seed=r.seed, marginals=r.marginals,
                        observables=r.observables,
                    )
        return self._responses(batch, len(live), errors, fields, cache_hit, prov,
                               t_bind.elapsed, t_exec.elapsed, metrics)

    @staticmethod
    def _failed(reqs: List[SimRequest], errors: Dict[int, Exception], live=(),
                error: Optional[Exception] = None,
                metrics=None) -> List[Tuple[SimRequest, Exception]]:
        """Each request's error when the batch runs no further: ``error``
        for every one of ``live`` (the engine could not be had: a build
        failure or quarantine; they all need it), ``errors`` for the rest."""
        if live:
            metrics.inc("acquire_errors")
        for r in live:
            errors[r.request_id] = error
        return [(r, errors[r.request_id]) for r in reqs]

    @staticmethod
    def _responses(batch: Batch, P: int, errors: Dict[int, Exception],
                   fields: Dict[int, Dict], cache_hit: bool, provenance: Optional[Dict],
                   bind_s: float, execute_s: float,
                   metrics) -> List[Tuple[SimRequest, Union[SimResponse, Exception]]]:
        """The executed batch's metrics (``P`` live requests) and, in batch
        order, each request's :class:`SimResponse` (its measured ``fields``:
        ``result``, ``amp0``, ``state``) or its error."""
        if provenance is not None:
            metrics.inc("degraded_responses", P)
        metrics.inc("batches_total")
        metrics.inc("requests_executed", P)
        metrics.inc(f"flush_{batch.flush_reason}")
        metrics.observe("batch_size", P)
        responses: List[Tuple[SimRequest, Union[SimResponse, Exception]]] = []
        for r in batch.requests:
            if r.request_id in errors:
                responses.append((r, errors[r.request_id]))
                continue
            resp = SimResponse(request_id=r.request_id, tenant=r.tenant, batch_size=P,
                               cache_hit=cache_hit, provenance=provenance,
                               **fields[r.request_id])
            resp.timings = {
                "queue_wait_s": r.picked_t - r.arrival_t,
                "batch_form_s": batch.formed_t - r.picked_t,
                "bind_s": bind_s,
                "execute_s": execute_s,
            }
            metrics.observe("queue_wait_s", resp.timings["queue_wait_s"])
            metrics.observe("batch_form_s", resp.timings["batch_form_s"])
            responses.append((r, resp))
        return responses

    def _live(self, reqs: List[SimRequest], errors: Dict[int, Exception],
              metrics) -> List[SimRequest]:
        """The requests still inside their deadline; the others get a
        :class:`RequestTimeout` in ``errors``. The worker-side re-check:
        queue wait + batch formation may have consumed the budget since the
        scheduler's check."""
        from ..sim.faults import RequestTimeout

        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline_t and now >= r.deadline_t:
                metrics.inc("timeouts_total")
                errors[r.request_id] = RequestTimeout(
                    f"request {r.request_id} missed its {r.deadline_s}s "
                    f"deadline before execution",
                    request_id=r.request_id, deadline_s=r.deadline_s,
                    elapsed=now - r.arrival_t)
            else:
                live.append(r)
        return live

    def _run_batch(self, engine, reqs: List[SimRequest],
                   points: Dict[int, Dict[str, float]], dedup: bool, wants_state: bool,
                   verify: bool, states: Dict[int, object],
                   errors: Dict[int, Exception], metrics) -> None:
        """The batch's engine work under the engine lock: a dedup group's
        ONE run, or the fused sweep over ``points``."""
        from ..sim.faults import FaultError

        if not dedup:
            self._run_sweep_isolated(engine, reqs, points, wants_state, verify,
                                     states, errors, metrics)
            return
        # dedup group: P identical concrete requests, ONE run. Splitting
        # cannot help here — every member is the same computation — so a
        # terminal failure fails them all.
        try:
            out = self._run_with_retry(
                lambda: (engine.run(None, verify=verify) if wants_state
                         else engine.run_packed(None, verify=verify)),
                metrics)
            metrics.inc("sweep_rows")
            for r in reqs:
                states[r.request_id] = out
        except FaultError as e:
            for r in reqs:
                errors[r.request_id] = e

    # ------------------------------------------------------------ shardmap
    def _execute_sharded(self, batch: Batch, pool,
                         metrics) -> List[Tuple[SimRequest, Union[SimResponse, Exception]]]:
        """:meth:`execute` on the shardmap backend, on rank 0: decide what
        only rank 0 decides (deadlines, the breaker, riders with a bad
        binding or measurement spec fail alone, before any rank runs them),
        broadcast the batch as one step, run it as every rank does
        (:func:`repro_torch.serve.follower.run_step`), and build the
        responses. An error the ranks may not all have seen raises
        :class:`~repro_torch.serve.follower.RanksOutOfStep`."""
        from .follower import RanksOutOfStep, RequestSpec, Step, run_step

        reqs = batch.requests
        errors: Dict[int, Exception] = {}
        live = self._live(reqs, errors, metrics)
        if not live:
            return self._failed(reqs, errors)
        leader = live[0]
        t0 = time.perf_counter()
        try:
            admitted = pool.admit(leader)
            admit_s = time.perf_counter() - t0
        except Exception as e:  # quarantined: no rank runs the batch
            return self._failed(reqs, errors, live, e, metrics)
        dedup = batch.key.binding is not None
        runnable, specs = [], []
        for r in live:
            try:
                point = {} if dedup else self._point(leader.circuit.param_names, r)
                _check_measurement(r, leader.circuit.n_qubits)
            except Exception as e:
                errors[r.request_id] = e
                continue
            runnable.append(r)
            specs.append(RequestSpec(point, r.shots, r.seed, tuple(r.marginals),
                                     tuple(r.observables), r.return_state))
        if not runnable:
            return self._failed(reqs, errors)
        step = Step("batch", leader.circuit, leader.L, leader.R, leader.G, admitted,
                    batch.key.wants_state, self._effective_verify(live), specs)
        try:
            pool.mesh.send(step)
            res = run_step(step, pool, self, metrics)
        except Exception as e:
            raise RanksOutOfStep(f"the ranks left the step of a batch of {len(runnable)}: "
                                 f"{type(e).__name__}: {e}") from e
        bind_s = admit_s + res.bind_s
        metrics.observe("bind_s", bind_s)
        if res.error is not None:
            return self._failed(reqs, errors, runnable, res.error, metrics)
        metrics.observe("execute_s", res.execute_s)
        metrics.observe("measure_s", res.measure_s)
        fields = {}
        for i, r in enumerate(runnable):
            if i in res.errors:
                errors[r.request_id] = res.errors[i]
            else:
                fields[r.request_id] = {"result": res.results.get(i), "amp0": res.amp0.get(i),
                                        "state": res.states.get(i)}
        return self._responses(batch, len(live), errors, fields, res.cache_hit,
                               res.provenance, bind_s, res.execute_s, metrics)

    # ------------------------------------------------------ fault handling
    def _effective_verify(self, reqs: List[SimRequest]) -> bool:
        """Per-request ``verify`` overrides the service default: any member
        asking for verification gets it (the guard is batch-wide but only
        costs a norm pass per row); the default applies unless every member
        explicitly opted out."""
        explicit = [r.verify for r in reqs if r.verify is not None]
        if any(explicit):
            return True
        if explicit and len(explicit) == len(reqs):
            return False
        return self.verify_norm

    def _run_with_retry(self, fn, metrics):
        """Call ``fn`` retrying transient typed failures with exponential
        backoff (jittered, capped). Non-transient errors propagate at once."""
        from ..sim.faults import TRANSIENT_ERRORS

        attempt = 0
        while True:
            try:
                return fn()
            except TRANSIENT_ERRORS:
                if attempt >= self.retry_max:
                    raise
                delay = min(self.retry_cap_s,
                            self.retry_base_s * (1 << attempt))
                delay *= 0.5 + 0.5 * self._backoff_rng.random()
                metrics.inc("retries_total")
                time.sleep(delay)
                attempt += 1

    def _run_sweep_isolated(self, engine, reqs: List[SimRequest],
                            points: Dict[int, Dict[str, float]],
                            wants_state: bool, verify: bool,
                            states: Dict[int, object],
                            errors: Dict[int, Exception], metrics) -> None:
        """Fused sweep with blast-radius isolation: try the coalesced run
        (with transient retry); if it still fails, re-execute each member
        individually so one poison member can't fail its batch-mates.
        ``sweep_rows`` counts the rows run, ``sweep_rows_padding`` the
        bucket's padding among them."""
        from ..sim.faults import FaultError

        if not reqs:
            return
        P = len(reqs)
        pts = [points[r.request_id] for r in reqs]
        padded = pts + [pts[-1]] * (bucket_size(P, self.max_batch_size) - P)
        try:
            out = self._run_with_retry(
                lambda: engine.run_sweep(None, padded,
                                         apply_final=wants_state,
                                         verify=verify),
                metrics)
            metrics.inc("sweep_rows", len(padded))
            metrics.inc("sweep_rows_padding", len(padded) - P)
            # each request keeps a view of its row: no copy, no transfer
            for i, r in enumerate(reqs):
                states[r.request_id] = out[i]
            return
        except FaultError as e:
            if P == 1:
                # no batch-mates to shield; record and bail
                errors[reqs[0].request_id] = e
                metrics.inc("request_errors_executed")
                return
            metrics.inc("split_batches")
        # blast-radius split: each member re-executes alone (own retry
        # budget); only members that fail individually get errors
        for r in reqs:
            self._run_alone(engine, r.request_id, points[r.request_id], wants_state, verify,
                            states, errors, metrics)

    def _run_alone(self, engine, key, point: Dict[str, float], wants_state: bool, verify: bool,
                   states: Dict, errors: Dict, metrics) -> None:
        """One row run alone with its own retry budget: its state into
        ``states[key]``, or its typed failure past the retries into
        ``errors[key]``."""
        from ..sim.faults import FaultError

        try:
            out = self._run_with_retry(
                lambda: engine.run_sweep(None, [point], apply_final=wants_state, verify=verify),
                metrics)
        except FaultError as e:
            errors[key] = e
            metrics.inc("request_errors_executed")
            return
        metrics.inc("sweep_rows")
        states[key] = out[0]

    @staticmethod
    def _ensure_binding(engine, leader: SimRequest) -> None:
        """Re-apply the leader's binding (concrete) or skeleton (symbolic)
        under the engine lock; mirrors ``engine_for``'s hit-path logic. A
        skeleton swap drops the adjoint programs wired to the old names."""
        c = leader.circuit
        if c.is_bound and leader.params is None:
            if (engine.bound_circuit is None
                    or engine.bound_circuit.binding_signature()
                    != c.binding_signature()):
                engine.bind_circuit(c)
        elif not c.is_bound:
            if (engine.circuit.is_bound
                    or engine.circuit.binding_signature()
                    != c.binding_signature()):
                engine.circuit = c
                engine._adjoint_progs.clear()

    @staticmethod
    def _point(names: Tuple[str, ...], r: SimRequest) -> Dict[str, float]:
        """Normalize a request's binding to a {name: value} point against
        the skeleton's parameter ``names``."""
        if r.params is None:
            return {}
        if isinstance(r.params, dict):
            return {k: float(v) for k, v in r.params.items()}
        vec = np.asarray(r.params, dtype=np.float64).reshape(-1)
        if vec.size != len(names):
            raise ValueError(
                f"request {r.request_id}: binding vector has {vec.size} "
                f"entries; circuit has {len(names)} parameters {names}"
            )
        return dict(zip(names, vec))


def _check_measurement(r: SimRequest, n: int) -> None:
    """Raise ``ValueError`` unless ``r``'s measurement spec fits ``n``
    qubits: shots non-negative, each marginal distinct qubits in range, each
    observable a Pauli sum on them."""
    from ..sim.measure import PauliSum

    if r.shots < 0:
        raise ValueError(f"request {r.request_id}: {r.shots} shots")
    for qs in r.marginals:
        qs = tuple(int(q) for q in qs)
        if len(set(qs)) != len(qs) or not all(0 <= q < n for q in qs):
            raise ValueError(f"request {r.request_id}: marginal {qs} is not distinct qubits "
                             f"below {n}")
    for obs in r.observables:
        if PauliSum.coerce(obs).max_qubit >= n:
            raise ValueError(f"request {r.request_id}: observable {obs!r} acts on a qubit "
                             f"beyond {n - 1}")
