"""The shardmap backend's traffic between ranks, over ``torch.distributed``.

One rank per device of the bit-mesh: rank ``d`` holds shard ``d`` of the
state, so physical bit ``p >= L`` is bit ``p - L`` of ``d``. An
inter-stage remap moves amplitudes between ranks in at most two
collectives, the reference's choreography (``lax.all_to_all`` then
``lax.ppermute`` inside ``shard_map``):

* the grouped all-to-all swaps the ``m`` outgoing local bits with the ``m``
  incoming device bits: rank ``d`` sends row ``c`` of its ``[2^m, 2^(L-m)]``
  view to the ``c``-th rank of its group (the ``2^m`` ranks that differ from
  ``d`` only in those device bits, in ascending order: the chunk order of
  ``lax.all_to_all(..., tiled=True)``) and receives that rank's row ``c_d``
  as its row ``c``. It sends ``(1 - 2^-m)`` of a shard to other ranks;
* the residual device-bit permutation sends the whole shard to one target
  rank (at most one shard).

Both are ONE ``all_to_all_single`` over the group, the second with one
non-zero split, so no subgroups are built and every rank calls each
collective in the same order. :func:`exchange_pattern` derives who talks to
whom from a :class:`~repro_torch.sim.engine.RemapPlan`; :class:`Transport`
moves the bytes. The exchanges hand the shards' own tensors to the group:
NCCL moves CUDA tensors between cards, and gloo (several ranks on one card,
where NCCL refuses a second rank on the same GPU) takes CUDA tensors in
``all_to_all_single`` and copies them through host memory itself. Gloo
refuses ``send``/``recv`` of CUDA tensors, so the measurement's and the
guard's small transfers (masses, sampled rows, marginals, norms, shots)
travel as host tensors over gloo and as device tensors over NCCL, as the
transport decides when it is built.

:data:`COLLECTIVE_CALLS` counts the transport's collectives by kind and the
bytes this rank sent to and received from other ranks in the exchanges and
point-to-point calls, as ``KERNEL_CALLS`` counts the kernels' launches.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import faults

COLLECTIVE_CALLS = {"all_to_all": 0, "permute": 0, "bytes_sent": 0, "bytes_received": 0,
                    "all_reduce": 0, "all_gather": 0, "broadcast": 0, "send": 0}


def reset_collective_counters() -> None:
    for k in COLLECTIVE_CALLS:
        COLLECTIVE_CALLS[k] = 0


def collective_counts() -> dict:
    return dict(COLLECTIVE_CALLS)


def exchange_pattern(rp, rank: int, L: int) -> Tuple[Optional[List[int]],
                                                      Optional[Tuple[int, int]]]:
    """Who rank ``rank`` talks to in remap ``rp``: the ``2^m`` ranks of its
    all-to-all group in chunk order (None when ``m == 0``), and the
    ``(dst, src)`` of the residual permute (None when there is none). Chunk
    ``c`` goes to the rank whose device bit ``s_in[t]`` is bit ``m - 1 - t``
    of ``c`` (``rp.a2a_axes`` names ``b{s_in[t]}``, highest bit first)."""
    peers = None
    if rp.m:
        s_in = [int(a[1:]) for a in rp.a2a_axes]
        mask = sum(1 << (s - L) for s in s_in)
        peers = []
        for c in range(1 << rp.m):
            d = rank & ~mask
            for t, s in enumerate(s_in):
                d |= ((c >> (rp.m - 1 - t)) & 1) << (s - L)
            peers.append(d)
    pair = None
    if rp.ppermute is not None:
        dst = dict(rp.ppermute)[rank]
        src = next(a for a, b in rp.ppermute if b == rank)
        pair = (dst, src)
    return peers, pair


class Transport:
    """Collectives of one rank over ``group`` (the default group when None),
    for shards on ``device``. Raises ``ValueError`` for a pairing it cannot
    serve (NCCL with CPU shards)."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL group moves CUDA tensors only; the shards are on "
                             f"{self.device}")
        # small host-side results ride on the device only where NCCL needs it
        self.wire = self.device if self.backend == "nccl" else torch.device("cpu")

    # ------------------------------------------------------------ exchanges

    def all_to_all(self, x: torch.Tensor, peers: Sequence[int], out: torch.Tensor) -> torch.Tensor:
        """Row ``c`` of ``x`` (``[2^m, chunk]``) to ``peers[c]``; row ``c`` of
        ``out`` (``x``'s shape, not ``x``) from ``peers[c]``. ``peers`` is
        ascending, so the rows are in rank order as the call takes them."""
        if list(peers) != sorted(peers) or len(set(peers)) != len(peers):
            raise ValueError(f"all-to-all peers {list(peers)} must be distinct and ascending")
        if len(peers) == self.world:
            splits = None
        else:
            on = set(peers)
            splits = [1 if r in on else 0 for r in range(self.world)]
        dist.all_to_all_single(out, x, splits, splits, group=self.group)
        COLLECTIVE_CALLS["all_to_all"] += 1
        COLLECTIVE_CALLS["bytes_sent"] += x.nbytes - x[0].nbytes  # the own row stays
        COLLECTIVE_CALLS["bytes_received"] += out.nbytes - out[0].nbytes
        return out

    def permute(self, x: torch.Tensor, dst: int, src: int, out: torch.Tensor) -> torch.Tensor:
        """All of ``x`` to rank ``dst``; ``out`` (``x``'s shape, not ``x``)
        from rank ``src``. Every rank of the group calls it together."""
        flat, oflat = x.reshape(-1), out.view(-1)
        n = flat.numel()
        dist.all_to_all_single(oflat, flat, [n if r == src else 0 for r in range(self.world)],
                               [n if r == dst else 0 for r in range(self.world)],
                               group=self.group)
        COLLECTIVE_CALLS["permute"] += 1
        if dst != self.rank:
            COLLECTIVE_CALLS["bytes_sent"] += x.nbytes
        if src != self.rank:
            COLLECTIVE_CALLS["bytes_received"] += out.nbytes
        return out

    # ------------------------------------------------------- small results
    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks of a small tensor, on ``t``'s device."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over the ranks of a small tensor, on ``t``'s
        device."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        w = t.to(self.wire).clone()
        dist.all_reduce(w, op=op, group=self.group)
        COLLECTIVE_CALLS["all_reduce"] += 1
        return w.to(t.device)

    def all_gather(self, a: np.ndarray) -> List[np.ndarray]:
        """Every rank's ``a`` (one shape and dtype on all ranks), in rank order."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.wire)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        COLLECTIVE_CALLS["all_gather"] += 1
        return [p.cpu().numpy() for p in parts]

    def broadcast(self, a: np.ndarray, src: int) -> np.ndarray:
        """Rank ``src``'s ``a`` on every rank (``a`` gives the shape and dtype
        on the others)."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.wire)
        dist.broadcast(t, src, group=self.group)
        COLLECTIVE_CALLS["broadcast"] += 1
        return t.cpu().numpy()

    def send(self, a: np.ndarray, dst: int) -> None:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.wire)
        dist.send(t, self._global(dst), group=self.group)
        COLLECTIVE_CALLS["send"] += 1
        COLLECTIVE_CALLS["bytes_sent"] += t.nbytes

    def recv(self, like: np.ndarray, src: int) -> np.ndarray:
        t = torch.from_numpy(np.empty_like(like)).to(self.wire)
        dist.recv(t, self._global(src), group=self.group)
        COLLECTIVE_CALLS["bytes_received"] += t.nbytes
        return t.cpu().numpy()

    def gather_rows(self, rows: torch.Tensor) -> Optional[np.ndarray]:
        """Rank 0: the ``[B, 2^n]`` logical rows whose ``[B, 2^L]`` shards
        the ranks hold (after the final remap rank ``d`` holds amplitudes
        ``[d·2^L, (d+1)·2^L)``), on the host; None on the other ranks.
        Every rank calls it."""
        part = np.ascontiguousarray(rows.detach().cpu().numpy())
        wire = part.view(np.float32)  # point-to-point takes no complex tensors
        if self.rank:
            self.send(wire, 0)
            return None
        return np.concatenate([part] + [self.recv(wire, src).view(np.complex64)
                                        for src in range(1, self.world)], axis=1)

    def _global(self, rank: int) -> int:
        """The default group's rank of this group's ``rank`` (what
        point-to-point calls take)."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)


# ----------------------------------------------------------------------
# agreeing on an engine build
# ----------------------------------------------------------------------

#: the errors an agreement names by code (``code - 1``); any other error is
#: named :class:`~repro_torch.sim.faults.BackendBuildError` on the other ranks
_AGREED_ERRORS = (faults.PallasLoweringError, faults.XlaTraceError, faults.BackendBuildError,
                  faults.StagingError, faults.KernelizationError, faults.FaultError)
_DIGEST_BYTES = 32
_MESSAGE_BYTES = 256
_CALLER = threading.local()


@contextmanager
def agreement_by_caller():
    """Within it, this thread's engine builds make no agreement of their
    own: the caller makes each build's one :func:`agree_build` once the
    build returned or raised (the serving pool, which must agree on a cache
    hit and on a failure before ``ShardMapBackend.setup`` as well)."""
    prev = getattr(_CALLER, "agrees", False)
    _CALLER.agrees = True
    try:
        yield
    finally:
        _CALLER.agrees = prev


def caller_agrees() -> bool:
    """Whether this thread is inside :func:`agreement_by_caller`."""
    return getattr(_CALLER, "agrees", False)


def agree_build(transport: Transport, digest: Optional[np.ndarray],
                error: Optional[BaseException] = None) -> None:
    """Every rank's outcome of building one engine, in ONE all-gather: the
    program's ``digest`` (32 bytes) where this rank built it, or the
    ``error`` it failed with. Every rank of the group calls it once per
    build, before any other collective of the engine, so a rank that failed
    leaves no other rank waiting in a collective it will never make.

    Returns when every rank built the same program. Otherwise it raises on
    every rank: a rank that failed its own ``error``; the others the typed
    error of the lowest failing rank (its class and message), or
    :class:`~repro_torch.sim.faults.BackendBuildError` when the ranks built
    different programs (each planned otherwise: they would issue other
    collectives and hang or corrupt the state)."""
    payload = np.zeros(2 + _DIGEST_BYTES + _MESSAGE_BYTES, dtype=np.uint8)
    if error is None:
        payload[2:2 + _DIGEST_BYTES] = digest
    else:
        code = next((i for i, cls in enumerate(_AGREED_ERRORS) if type(error) is cls),
                    _AGREED_ERRORS.index(faults.BackendBuildError))
        text = f"{type(error).__name__}: {error}".encode()[:_MESSAGE_BYTES]
        payload[0], payload[1] = code + 1, bool(getattr(error, "injected", False))
        payload[2 + _DIGEST_BYTES:2 + _DIGEST_BYTES + len(text)] = np.frombuffer(text, np.uint8)
    parts = transport.all_gather(payload)
    failed = [r for r, p in enumerate(parts) if p[0]]
    if failed:
        if error is not None:
            raise error
        p = parts[failed[0]]
        text = bytes(p[2 + _DIGEST_BYTES:]).rstrip(b"\0").decode(errors="replace")
        raise _AGREED_ERRORS[p[0] - 1](f"rank {failed[0]} could not build the engine ({text})",
                                       injected=bool(p[1]))
    differ = [r for r, p in enumerate(parts) if not np.array_equal(p, parts[0])]
    if differ:
        raise faults.BackendBuildError(
            f"the ranks compiled different programs: ranks {differ} differ from rank 0 "
            "(each rank planned otherwise; give every rank the same plan)")
