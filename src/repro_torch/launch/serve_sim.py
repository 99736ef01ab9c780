"""Async multi-tenant **simulation** serving front end (the Atlas engine).

This fronts :class:`repro_torch.serve.SimulationService`: concurrent
requests are grouped by structural CircuitKey and coalesced into single
``run_sweep`` engine calls (flush on max-batch-size or max-wait deadline),
behind a bounded admission queue with per-tenant weighted fairness and a
warm compile-cache pool. Every batch runs on ``--device`` (CUDA by
default) through the hand kernels: each compiled op is one kernel launch
over all of the batch's rows.

Demo mode (in-process synthetic traffic, prints the stats snapshot):
  PYTHONPATH=src python -m repro_torch.launch.serve_sim --demo --requests 64 \\
      --max-batch 8 --max-wait-ms 5
  (on a host without CUDA: add --device cpu)

Server mode (newline-delimited JSON over TCP):
  PYTHONPATH=src python -m repro_torch.launch.serve_sim --port 8765 \\
      --max-batch 16 --tenant-weight gold=4 --tenant-weight free=1

Wire protocol (one JSON object per line), the reference's
(``repro.launch.serve_sim``):
  -> {"id": 1, "tenant": "gold", "family": "su2param", "n": 8,
      "params": {"ry0_0": 0.3, ...} | [0.3, ...],
      "shots": 128, "observables": ["Z0 Z1"], "marginals": [[0, 1]]}
  -> {"id": 2, "circuit_json": "<Circuit.to_json()>"}        (concrete)
  -> {"cmd": "stats"}                                        (snapshot)
  <- {"id": 1, "rid": 1, "ok": true, "amp0": [re, im], "batch_size": 8,
      "counts": {...}, "expectations": {...}, "timings": {...}}
  <- {"id": 9, "rid": 9, "ok": false, "error": "overloaded",
      "message": "...", "retry_after": 0.12}

Shardmap (``--backend shardmap``): one process per device of the
``2^(R+G)`` bit-mesh under ``torchrun``. Rank 0 runs the demo or the server
and broadcasts each batch; every other rank follows it
(:func:`repro_torch.serve.follower.follow`) and runs the batch on its
``2^L`` shard; only rank 0 prints. ``--dist-backend``: ``nccl`` on CUDA
(one rank per card) and ``gloo`` on the CPU by default; several ranks on
one card need ``gloo``:
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 8 \\
      -m repro_torch.launch.serve_sim --backend shardmap --R 2 --G 1 --device cpu \\
      --demo --families isingparam:10 --requests 16 --max-batch 4
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve_sim \\
      --backend shardmap --dist-backend gloo --R 2 --port 8765

Error responses are structured: {"rid": <request id or null>, "ok": false,
"error": <stable code: bad_json | bad_request | overloaded | timeout |
quarantined>, "message": <human-readable>}. Malformed input (bad JSON, a
non-object line) gets an error response — it never tears down the
connection. Per-request "timeout" (seconds) sets a deadline; the
--request-timeout flag sets the service-wide default.
"""

from __future__ import annotations

import argparse
import asyncio
import json

import numpy as np

from ..core.circuit import Circuit
from ..core.generators import FAMILIES, PARAM_FAMILIES
from ..serve import (
    CircuitQuarantined,
    RequestTimeout,
    ServeConfig,
    ServiceOverloaded,
    SimRequest,
    SimulationService,
)
from ..sim.faults import FaultError


def _parse_weights(specs):
    out = {}
    for spec in specs:
        if "=" not in spec:
            raise SystemExit(f"--tenant-weight expects NAME=WEIGHT, got {spec!r}")
        name, _, val = spec.partition("=")
        out[name.strip()] = float(val)
    return out


def config_from_args(args, device=None) -> ServeConfig:
    """The service's config from the flags; ``device`` (a shardmap rank's)
    in place of ``--device``."""
    return ServeConfig(
        backend=args.backend,
        use_kernels=args.kernels,
        device=device or args.device,
        R=args.R,
        G=args.G,
        max_batch_size=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth,
        tenant_weights=_parse_weights(args.tenant_weight),
        workers=args.workers,
        cache_size=args.cache_size,
        admit_after=args.admit_after,
        request_timeout_s=args.request_timeout,
        verify_norm=not args.no_verify_norm,
    )


def request_from_json(d: dict) -> SimRequest:
    """Build a SimRequest from one wire-protocol object."""
    if "circuit_json" in d:
        circ = Circuit.from_json(d["circuit_json"])
    else:
        fam = d.get("family")
        maker = PARAM_FAMILIES.get(fam) or FAMILIES.get(fam)
        if maker is None:
            raise ValueError(f"unknown family {fam!r}; pick from "
                             f"{sorted(PARAM_FAMILIES) + sorted(FAMILIES)}")
        circ = maker(int(d.get("n", 8)))
    params = d.get("params")
    if isinstance(params, list):
        params = np.asarray(params, dtype=np.float64)
    timeout = d.get("timeout")
    verify = d.get("verify")
    return SimRequest(
        circuit=circ,
        params=params,
        tenant=str(d.get("tenant", "default")),
        shots=int(d.get("shots", 0)),
        marginals=tuple(tuple(m) for m in d.get("marginals", ())),
        observables=tuple(d.get("observables", ())),
        seed=int(d.get("seed", 0)),
        return_state=bool(d.get("return_state", False)),
        L=d.get("L"), R=d.get("R"), G=d.get("G"),
        deadline_s=None if timeout is None else float(timeout),
        verify=None if verify is None else bool(verify),
    )


def error_to_json(rid, error: str, message: str, **extra) -> dict:
    """Structured error shape: every error response carries the request id
    (``rid``, mirrored as ``id`` for older clients), a stable machine-
    readable ``error`` code, and a human-readable ``message``."""
    out = {"id": rid, "rid": rid, "ok": False,
           "error": error, "message": message}
    out.update(extra)
    return out


def response_to_json(rid, resp) -> dict:
    out = {"id": rid, "rid": rid, "ok": True, "batch_size": resp.batch_size,
           "cache_hit": resp.cache_hit, "timings": resp.timings}
    if resp.provenance is not None:
        out["provenance"] = resp.provenance
    if resp.amp0 is not None:
        out["amp0"] = [resp.amp0.real, resp.amp0.imag]
    if resp.state is not None:
        out["state"] = [[float(a.real), float(a.imag)] for a in resp.state]
    if resp.result is not None:
        r = resp.result
        if r.samples is not None:
            out["counts"] = r.counts()
        out["expectations"] = {k: float(v) for k, v in r.expectations.items()}
        out["marginals"] = {",".join(map(str, q)): list(map(float, m))
                            for q, m in r.marginals.items()}
    return out


async def handle_client(svc: SimulationService, reader, writer) -> None:
    async def send(obj):
        writer.write((json.dumps(obj, default=str) + "\n").encode())
        await writer.drain()

    async def run_one(rid, d):
        try:
            resp = await svc.submit(request_from_json(d))
            await send(response_to_json(rid, resp))
        except ServiceOverloaded as e:
            await send(error_to_json(rid, "overloaded", str(e),
                                     retry_after=e.retry_after))
        except RequestTimeout as e:
            await send(error_to_json(rid, "timeout", str(e),
                                     deadline_s=e.deadline_s))
        except CircuitQuarantined as e:
            await send(error_to_json(rid, "quarantined", str(e),
                                     retry_after=e.retry_after))
        except Exception as e:  # malformed request, unknown family, ...
            await send(error_to_json(rid, "bad_request",
                                     f"{type(e).__name__}: {e}"))

    tasks = set()
    try:
        while True:
            line = await reader.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                await send(error_to_json(None, "bad_json", f"bad json: {e}"))
                continue
            if not isinstance(d, dict):
                # a JSON array/scalar line must NOT tear down the connection
                await send(error_to_json(
                    None, "bad_request",
                    f"expected a JSON object, got {type(d).__name__}"))
                continue
            if d.get("cmd") == "stats":
                await send({"ok": True, "stats": svc.stats()})
                continue
            # requests on one connection run concurrently — coalescing
            # needs simultaneous in-flight submissions
            t = asyncio.create_task(run_one(d.get("id"), d))
            tasks.add(t)
            t.add_done_callback(tasks.discard)
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
    finally:
        writer.close()


async def serve_forever(args, device=None) -> None:
    """Serve until interrupted, or until the service fails (a shardmap group
    that broke: raised)."""
    svc = SimulationService(config_from_args(args, device))
    await svc.start()
    server = await asyncio.start_server(
        lambda r, w: handle_client(svc, r, w), args.host, args.port)
    addrs = ", ".join(str(s.getsockname()) for s in server.sockets)
    print(f"simulation service listening on {addrs} "
          f"(max_batch={args.max_batch}, max_wait={args.max_wait_ms}ms, "
          f"queue={args.queue_depth}, workers={args.workers}, "
          f"device={svc.pool.device}, kernels={args.kernels})", flush=True)
    try:
        async with server:
            raise await svc.until_failed()
    finally:
        await svc.stop()


async def run_demo(args, device=None) -> dict:
    """In-process synthetic traffic: mixed families, mixed tenants, one
    shared stats snapshot printed at the end (returned for tests). Raises
    the service's failure (a shardmap group that broke)."""
    rng = np.random.default_rng(args.seed)
    fams = []
    for spec in args.families.split(","):
        name, _, nq = spec.partition(":")
        sym = PARAM_FAMILIES[name](int(nq or 8))
        fams.append((name, sym, sym.param_names))
    svc = SimulationService(config_from_args(args, device))
    async with svc:
        async def one(i):
            name, sym, names = fams[i % len(fams)]
            req = SimRequest(
                circuit=sym, tenant=f"tenant{i % 4}",
                params=rng.uniform(0.1, 6.2, len(names)),
                shots=args.shots if i % 7 == 0 else 0,
            )
            try:
                return await svc.submit(req)
            except FaultError as e:  # deadline/quarantine: count, don't crash
                return e

        resps = await asyncio.gather(*[one(i) for i in range(args.requests)])
        stats = svc.stats()
    if svc.failure is not None:
        raise svc.failure
    failed = [r for r in resps if isinstance(r, Exception)]
    resps = [r for r in resps if not isinstance(r, Exception)]
    sizes = [r.batch_size for r in resps] or [0]
    print(f"demo: {len(resps)} responses ({len(failed)} rejected), "
          f"mean batch size {np.mean(sizes):.2f}, coalesce factor "
          f"{stats.get('coalesce_factor', 1.0):.2f}")
    print(json.dumps(stats, indent=2, default=str))
    return stats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port for the JSON-lines server (0: demo only)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--demo", action="store_true",
                    help="run in-process synthetic traffic and exit")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--families", default="su2param:8,isingparam:8")
    ap.add_argument("--shots", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    # service knobs
    ap.add_argument("--backend", default="cuda", choices=["cuda", "offload", "dense", "shardmap"],
                    help="cuda: the state on --device; offload: the state in host memory, "
                         "streamed through --device stage by stage; dense: the per-gate oracle; "
                         "shardmap: one process per device of the 2^(R+G) bit-mesh, each with "
                         "one 2^L shard, started by torchrun (rank 0 serves)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="--backend shardmap: the torch.distributed backend (default nccl on "
                         "cuda, one rank per card; gloo on cpu). Several ranks on one card "
                         "need gloo")
    ap.add_argument("--kernels", action=argparse.BooleanOptionalAction, default=True,
                    help="run the hand-written kernels (default; on the CPU their plain "
                         "versions); --no-kernels runs the plain versions on any device")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--R", type=int, default=0)
    ap.add_argument("--G", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=4.0)
    ap.add_argument("--queue-depth", type=int, default=256)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--cache-size", type=int, default=16)
    ap.add_argument("--admit-after", type=int, default=1)
    ap.add_argument("--tenant-weight", action="append", default=[],
                    metavar="NAME=WEIGHT")
    # robustness knobs
    ap.add_argument("--request-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="default per-request deadline; expired requests get "
                         "a typed timeout error (per-request 'timeout' field "
                         "overrides)")
    ap.add_argument("--no-verify-norm", action="store_true",
                    help="disable the post-run ||psi||=~1 integrity guard")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.backend != "shardmap":
        if args.dist_backend is not None:
            ap.error("--dist-backend needs --backend shardmap")
        return _serve(args)
    from ..launch import dist as launch_dist
    from ..serve.follower import check_shardmap_config, follow

    try:
        ctx = launch_dist.join(args.dist_backend, args.device)
    except launch_dist.LaunchError as e:
        ap.error(str(e))
    try:
        try:
            check_shardmap_config(config_from_args(args), ctx.world)
        except ValueError as e:
            ap.error(str(e))
        if ctx.rank:
            return follow(config_from_args(args), ctx)
        return _serve(args, ctx.device)
    finally:
        ctx.close()


def _serve(args, device=None):
    if args.demo or not args.port:
        return asyncio.run(run_demo(args, device))
    return asyncio.run(serve_forever(args, device))


if __name__ == "__main__":
    main()
