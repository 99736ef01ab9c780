"""Tiered at-rest shard store: compressed DRAM tier + disk spill tier.

(The port's copy of ``repro/sim/shard_store.py``: the same policy, codecs,
LRU, spill protocol, error bound and snapshot. What differs: the codecs run
as PyTorch CPU ops, which are multi-threaded, on torch tensors; the bf16
tier rounds through ``torch.bfloat16`` and keeps the 16-bit payload as
``uint16`` (PyTorch and ``ml_dtypes`` both round to nearest even, so the
payloads are the reference's bit for bit), so no ``ml_dtypes`` is needed;
spill files are a raw format of this module's own; and :meth:`ShardStore.remap`
permutes each shard group with tensor copies instead of numpy masks.)

The offload path keeps the whole state resident in host DRAM as
uncompressed ``complex64`` shards, which caps the largest simulable n at the
machine's DRAM. This module extends the storage hierarchy downward:

* shards live **at rest** in one of three dtype tiers — ``exact``
  (complex64, lossless), ``bf16`` (real/imag parts as bfloat16, 2x
  smaller) or ``int8`` (per-block symmetric quantization, ~4x smaller);
* the DRAM tier has a configurable byte budget; least-recently-touched
  shards spill to a **disk tier** as atomic tmp+rename files keyed by a
  per-run tag (a torn write can never be mistaken for a valid shard);
* every lossy encode's exact L2 roundtrip error is accumulated into a
  per-run **error bound**: all downstream stage ops and remaps are
  norm-preserving, so by the triangle inequality the final state deviates
  from the exact computation by at most the sum of per-encode errors. The
  bound is surfaced in ``engine.provenance["storage"]`` and the run is
  rejected with a typed :class:`repro_torch.sim.faults.StorageToleranceError`
  when it exceeds the configured tolerance;
* :meth:`ShardStore.prefetch` overlaps the next shard's disk read +
  dequantize with the current shard's device compute;
* :meth:`ShardStore.remap` performs the inter-stage bit permutation
  out-of-core: output shards are processed in groups that share the same
  input-shard subcube, so every input shard is decoded exactly once per
  remap and the transient working set is ``2^m + 1`` decoded shards (m =
  exchanged nonlocal bits), never the full state.

The store is engine-agnostic: it only needs the shard count, shard length
and a complex dtype. :class:`repro_torch.sim.engine.OffloadBackend` threads
one instance through its stage loop when ``engine_for(storage=...)`` is set.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import threading
import time
import uuid
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import faults
from .apply import _copy_into

AT_REST_DTYPES = ("exact", "bf16", "int8")

#: at-rest bytes per complex amplitude for each tier (int8: 2 payload bytes
#: + per-block fp32 scales at _INT8_BLOCK granularity)
_INT8_BLOCK = 512
AT_REST_BYTES_PER_AMP = {
    "exact": 8.0,
    "bf16": 4.0,
    "int8": 2.0 + 2 * 4.0 / _INT8_BLOCK,
}

#: env knob: a storage config for every ``engine_for(backend="offload")``
#: call that passes none (and no ``checkpoint_dir``)
STORAGE_ENV = "REPRO_STORAGE"


@dataclass(frozen=True)
class StorageConfig:
    """At-rest storage policy for the offload backend's shard state.

    ``at_rest_dtype``: ``exact`` | ``bf16`` | ``int8`` — precision of
    shards at rest (in DRAM and on disk). ``dram_bytes``: at-rest DRAM
    budget in bytes (``None`` = unbounded, disk tier never used).
    ``spill_dir``: root directory for spilled shard files (``None`` = the
    system temp dir). ``error_tolerance``: max accumulated L2 quantization
    error bound, relative to the initial state norm, before the run is
    rejected. ``prefetch``: overlap the next shard's load+dequantize with
    the current shard's device compute."""

    at_rest_dtype: str = "exact"
    dram_bytes: Optional[int] = None
    spill_dir: Optional[str] = None
    error_tolerance: float = 0.05
    prefetch: bool = True

    def __post_init__(self):
        if self.at_rest_dtype not in AT_REST_DTYPES:
            raise ValueError(
                f"at_rest_dtype={self.at_rest_dtype!r}: pick from "
                f"{AT_REST_DTYPES}")
        if self.dram_bytes is not None and self.dram_bytes < 0:
            raise ValueError("dram_bytes must be >= 0 (or None: unbounded)")

    # ------------------------------------------------------------- coercion
    @staticmethod
    def coerce(v: Union[None, str, dict, "StorageConfig"],
               ) -> Optional["StorageConfig"]:
        """``None``/``"off"`` -> None; a spec string, dict or config passes
        through. Spec string format (also the :data:`STORAGE_ENV` format)::

            exact | bf16 | int8 [:dram_kib=N] [:dir=PATH] [:tol=X]
        """
        if v is None or isinstance(v, StorageConfig):
            return v
        if isinstance(v, dict):
            return StorageConfig(**v)
        if isinstance(v, str):
            return StorageConfig.parse(v)
        raise TypeError(f"storage={v!r}: expected None, str, dict or "
                        "StorageConfig")

    @staticmethod
    def parse(text: str) -> Optional["StorageConfig"]:
        text = text.strip()
        if not text or text.lower() in ("off", "0", "none"):
            return None
        parts = text.split(":")
        kw: Dict[str, object] = {"at_rest_dtype": parts[0].strip()}
        for p in parts[1:]:
            k, _, val = p.partition("=")
            k = k.strip()
            if k == "dram_kib":
                kw["dram_bytes"] = int(float(val) * 1024)
            elif k == "dram_bytes":
                kw["dram_bytes"] = int(val)
            elif k == "dir":
                kw["spill_dir"] = val.strip()
            elif k == "tol":
                kw["error_tolerance"] = float(val)
            elif k == "prefetch":
                kw["prefetch"] = val.strip().lower() not in ("0", "false", "off")
            else:
                raise ValueError(f"unknown storage spec key {k!r} in {text!r}")
        return StorageConfig(**kw)  # type: ignore[arg-type]

    @staticmethod
    def from_env() -> Optional["StorageConfig"]:
        return StorageConfig.parse(os.environ.get(STORAGE_ENV, ""))

    # ---------------------------------------------------------------- model
    @property
    def at_rest_bytes_per_amp(self) -> float:
        return AT_REST_BYTES_PER_AMP[self.at_rest_dtype]

    def spill_fraction(self, total_amps: int) -> float:
        """Fraction of the at-rest state that does NOT fit in the DRAM
        budget — the planner's estimate of how much of every streaming pass
        crosses the disk tier."""
        if self.dram_bytes is None:
            return 0.0
        total = self.at_rest_bytes_per_amp * total_amps
        if total <= self.dram_bytes:
            return 0.0
        return 1.0 - self.dram_bytes / total

    def apply_to_cost_model(self, cm, n: int, L: int):
        """A :class:`repro_torch.core.cost_model.CostModel` copy that prices
        the tier the shards actually sit in: ``at_rest_bytes`` reflects the
        at-rest dtype, and the ILP comm weight scales by the ratio of the
        spill-aware offload pass to the DRAM-resident one (a remap on a
        spilled run re-reads/re-writes the disk tier). Deterministic from
        (config, n, L), so it is safe inside the CircuitKey."""
        frac = self.spill_fraction(1 << n)
        cm2 = cm.with_overrides(at_rest_bytes=self.at_rest_bytes_per_amp)
        if frac <= 0.0:
            return cm2
        scale = cm2.offload_pass_us(L, frac) / max(cm2.offload_pass_us(L), 1e-9)
        return cm2.with_overrides(comm_weight=cm.comm_weight * scale)

    def fingerprint(self) -> Tuple:
        """CircuitKey component: compressed and exact plans must never
        collide in the compile cache."""
        return ("storage", self.at_rest_dtype, self.dram_bytes,
                self.spill_dir, float(self.error_tolerance), self.prefetch)

    def with_overrides(self, **kw) -> "StorageConfig":
        return replace(self, **kw)


# ======================================================================
# At-rest codecs
# ======================================================================


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class Encoded:
    """One shard's at-rest representation: a tuple of contiguous numpy
    blocks (payload, and scales for int8) plus enough metadata to decode.
    Immutable after construction — a reference obtained under the store
    lock stays valid after a concurrent eviction."""

    __slots__ = ("mode", "parts", "shape", "dtype", "nbytes")

    def __init__(self, mode: str, parts: Tuple[np.ndarray, ...],
                 shape: Tuple[int, ...], dtype: torch.dtype):
        self.mode = mode
        self.parts = parts
        self.shape = tuple(shape)
        self.dtype = dtype
        self.nbytes = sum(int(p.nbytes) for p in parts)


def _float_view(t: torch.Tensor) -> torch.Tensor:
    """Complex tensor -> its interleaved (re, im) float32 values, flat (a
    view when ``t`` is contiguous complex64)."""
    return torch.view_as_real(t.contiguous()).reshape(-1).to(torch.float32)


#: floats per codec step. A shard is encoded a few MiB at a time: the new
#: payload's pages are first touched chunk by chunk and the roundtrip error
#: is taken from a cache-sized scratch (several times faster on the CPU
#: than whole-shard tensor ops, which fault in a fresh shard-sized payload
#: and a shard-sized temporary at once)
_CODEC_CHUNK = 1 << 20


def encode_shard(arr, mode: str) -> Tuple[Encoded, float]:
    """Encode one decoded shard (complex, any lead dims; a torch tensor on
    the CPU or a numpy array) into its at-rest form. Returns ``(encoded,
    err)`` where ``err`` is the L2 norm of the roundtrip error ``||arr -
    decode(encode(arr))||_2`` (0.0 for the exact tier) — the quantity the
    store accumulates into the per-run error bound. The payloads are the
    reference's: the same float32 operations, in chunks."""
    t = torch.as_tensor(arr)
    shape, dtype = tuple(t.shape), t.dtype
    if mode == "exact":
        payload = np.empty(shape, dtype=torch.empty(0, dtype=dtype).numpy().dtype)
        dst, src = torch.from_numpy(payload).view(-1), t.reshape(-1)
        for i in range(0, dst.numel(), _CODEC_CHUNK):
            dst[i:i + _CODEC_CHUNK].copy_(src[i:i + _CODEC_CHUNK])
        return Encoded("exact", (payload,), shape, dtype), 0.0
    f = _float_view(t)
    scratch = torch.empty(min(_CODEC_CHUNK, f.numel()), dtype=torch.float32)
    sq = 0.0
    if mode == "bf16":
        payload = np.empty(f.numel(), dtype=np.uint16)
        q = torch.from_numpy(payload.view(np.int16)).view(torch.bfloat16)
        for i in range(0, f.numel(), _CODEC_CHUNK):
            fc, qc = f[i:i + _CODEC_CHUNK], q[i:i + _CODEC_CHUNK]
            qc.copy_(fc)  # round to nearest even, as ml_dtypes
            d = scratch[:fc.numel()]
            d.copy_(qc).sub_(fc)
            sq += float(torch.dot(d, d))
        return Encoded("bf16", (payload.reshape(shape[:-1] + (-1,)),), shape, dtype), sq ** 0.5
    if mode == "int8":
        block = min(_INT8_BLOCK, f.numel())
        rows = f.view(-1, block)
        q = np.empty(rows.shape, dtype=np.int8)
        scale = np.empty((rows.shape[0], 1), dtype=np.float32)
        qt, st = torch.from_numpy(q), torch.from_numpy(scale)
        step = max(_CODEC_CHUNK // block, 1)
        for i in range(0, rows.shape[0], step):
            rc, sc, qc = rows[i:i + step], st[i:i + step], qt[i:i + step]
            # symmetric per-block quantization: the reference's numpy form,
            # in the same float32 operations (round half to even, as np.round)
            torch.amax(rc.abs(), dim=-1, keepdim=True, out=sc)
            sc.div_(127.0).clamp_min_(1e-12)
            qc.copy_(torch.round(rc / sc).clamp_(-127, 127))
            d = scratch[:rc.numel()].view(rc.shape)
            d.copy_(qc).mul_(sc).sub_(rc)
            sq += float(torch.dot(d.view(-1), d.view(-1)))
        return Encoded("int8", (q, scale), shape, dtype), sq ** 0.5
    raise ValueError(f"unknown at-rest mode {mode!r}")


def decode_shard(enc: Encoded, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode an at-rest shard back to its complex working form, into
    ``out`` (a tensor of the shard's shape, or a view of it) or a new tensor.
    Lossless from the encoded representation (all loss happens at encode
    time, once per put — spill/reload round trips are bit-stable)."""
    if out is None:
        out = torch.empty(enc.shape, dtype=enc.dtype)
    if enc.mode == "exact":
        out.copy_(torch.from_numpy(enc.parts[0]).view(out.shape))
        return out
    if not out.is_contiguous():  # e.g. one shard's rows of a remap group
        out.copy_(decode_shard(enc).view(out.shape))
        return out
    f = torch.view_as_real(out).view(-1)
    if enc.mode == "bf16":
        f.copy_(torch.from_numpy(enc.parts[0].view(np.int16)).view(torch.bfloat16).view(-1))
    elif enc.mode == "int8":
        q, scale = (torch.from_numpy(p) for p in enc.parts)
        f.view(q.shape).copy_(q).mul_(scale)
    else:
        raise ValueError(f"unknown at-rest mode {enc.mode!r}")
    return out


# ======================================================================
# Group permutation of the out-of-core remap
# ======================================================================


def _permute_slice(group: torch.Tensor, gsrc: Sequence[int], gflips: Sequence[int], L: int,
                   k: int, out: torch.Tensor) -> None:
    """``out[lead, 2^L]`` = the rows of ``permute(group)`` whose top index
    bits ``L..`` equal ``k``: ``group`` is ``[lead, 2^(L+m)]`` (its last
    dimension the flat group index), new bit ``p`` takes group bit
    ``gsrc[p]`` (XOR 1 for the bits in ``gflips``). The permutation runs on
    views: only ``out`` is written."""
    n = len(gsrc)
    flips = set(gflips)
    lead = group.dim() - 1
    runs: List[List[int]] = []  # source bits of each output run, high -> low
    tops: List[int] = []  # lowest output bit of each run
    for p in range(n - 1, -1, -1):
        s = gsrc[p]
        if (runs and p != L - 1 and runs[-1][-1] == s + 1 and s not in flips
                and runs[-1][-1] not in flips):
            runs[-1].append(s)
            tops[-1] = p
        else:
            runs.append([s])
            tops.append(p)
    old_order = sorted(range(len(runs)), key=lambda r: -runs[r][0])
    axis_of_run = {r: lead + i for i, r in enumerate(old_order)}
    src = group.reshape(tuple(group.shape[:lead]) + tuple(1 << len(runs[r]) for r in old_order))
    src = src.permute(list(range(lead)) + [axis_of_run[r] for r in range(len(runs))])
    n_top = sum(1 for p in tops if p >= L)
    for r in range(n_top):  # select the rows of output shard k
        width = len(runs[r])
        idx = (k >> (tops[r] - L)) & ((1 << width) - 1)
        if runs[r][0] in flips:
            idx ^= 1
        src = src.select(lead, idx)
    rest = runs[n_top:]
    view = out.view(tuple(out.shape[:lead]) + tuple(1 << len(r) for r in rest))
    _copy_into(view, src, [lead + i for i, r in enumerate(rest) if r[0] in flips])


# ======================================================================
# The store
# ======================================================================


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


class ShardStore:
    """Tiered at-rest shard container for one run.

    Shards are keyed ``0..n_shards-1`` in the *current generation*; a
    :meth:`remap` writes the permuted state under the next generation and
    swaps, so in-flight reads of old shards and writes of new ones never
    alias. The DRAM tier is an LRU ``OrderedDict`` (head = coldest) under
    a byte budget; overflow spills to atomic tmp+rename files. All tier
    bookkeeping happens under one lock; decode/dequantize runs outside it
    so a prefetch thread's dequantize overlaps the main thread's device
    wait.

    Besides the reference's ``stats``, ``timing`` accumulates the seconds
    and bytes of the codec and the disk tier (``encode_s``, ``decode_s``,
    ``spill_write_s``/``_bytes``, ``spill_read_s``/``_bytes``)."""

    def __init__(self, n_shards: int, shard_len: int,
                 lead_shape: Tuple[int, ...], dtype,
                 config: StorageConfig, run_tag: Optional[str] = None):
        self.n_shards = int(n_shards)
        self.shard_len = int(shard_len)
        self.lead_shape = tuple(lead_shape)
        self.dtype = _torch_dtype(dtype)
        self.config = config
        self.run_tag = run_tag or uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        self._dram: "OrderedDict[Tuple[int, int], Encoded]" = OrderedDict()
        self._disk: Dict[Tuple[int, int], str] = {}
        self._gen = 0
        self._dir: Optional[str] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        # decoded working buffers of the main thread (fill, tile, gather,
        # remap), kept until close(): each is paged in once per run
        self._bufs: Dict[str, torch.Tensor] = {}
        self.dram_bytes = 0
        self.error_bound = 0.0  # accumulated L2 encode error (absolute)
        self.initial_norm = 1.0
        self.stats = {
            "puts": 0, "gets": 0, "spills": 0, "spill_loads": 0,
            "evictions": 0, "disk_bytes": 0, "peak_dram_bytes": 0,
            "remaps": 0, "prefetches": 0,
        }
        self.timing = {"encode_s": 0.0, "decode_s": 0.0, "spill_write_s": 0.0,
                       "spill_write_bytes": 0, "spill_read_s": 0.0, "spill_read_bytes": 0}

    # ------------------------------------------------------------ lifecycle
    @property
    def total_amps(self) -> int:
        return int(np.prod(self.lead_shape, dtype=np.int64)) * self.n_shards * self.shard_len

    @property
    def ndim(self) -> int:
        """The dims of the state the store holds (``lead_shape`` + the flat
        amplitudes), as the array it stands for has."""
        return len(self.lead_shape) + 1

    def _ensure_dir(self) -> str:
        if self._dir is None:
            root = self.config.spill_dir or tempfile.gettempdir()
            d = os.path.join(root, f"shardstore-{self.run_tag}")
            os.makedirs(d, exist_ok=True)
            self._dir = d
        return self._dir

    def close(self) -> None:
        """Drop everything: DRAM entries, spilled files, the prefetch
        worker. Called when the run's result has been gathered."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._bufs.clear()
        with self._lock:
            self._dram.clear()
            self.dram_bytes = 0
            paths = list(self._disk.values())
            self._disk.clear()
        for p in paths:
            _remove(p)
        if self._dir is not None:
            try:
                os.rmdir(self._dir)
            except OSError:
                pass
            self._dir = None

    # ------------------------------------------------------------ disk tier
    def _spill_path(self, key: Tuple[int, int]) -> str:
        return os.path.join(self._ensure_dir(), f"g{key[0]}-s{key[1]}.bin")

    def _write_spill(self, key: Tuple[int, int], enc: Encoded) -> str:
        """Atomic spill write: tmp + fsync + rename, with the
        ``spill_io_error`` fault probe at the write site. A failure leaves
        no file under the final name — never a torn at-rest shard.

        File: an 8-byte little-endian header length, a JSON header (mode,
        shard shape, each part's dtype and shape), then each part's raw
        bytes."""
        path = self._spill_path(key)
        tmp = path + ".tmp"
        if faults._ACTIVE is not None:
            faults.maybe_inject("spill_io_error",
                                site=f"spill.write.g{key[0]}s{key[1]}")
        head = json.dumps({"mode": enc.mode, "shape": list(enc.shape),
                           "parts": [[p.dtype.str, list(p.shape)] for p in enc.parts]}).encode()
        t0 = time.perf_counter()
        try:
            with open(tmp, "wb") as f:
                f.write(struct.pack("<Q", len(head)))
                f.write(head)
                for p in enc.parts:
                    f.write(memoryview(p).cast("B"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as e:
            _remove(tmp)
            raise faults.SpillIOError(f"spill write failed for {path}: {e}")
        self.timing["spill_write_s"] += time.perf_counter() - t0
        self.timing["spill_write_bytes"] += enc.nbytes
        return path

    def _read_spill(self, key: Tuple[int, int], path: str) -> Encoded:
        if faults._ACTIVE is not None:
            faults.maybe_inject("spill_io_error",
                                site=f"spill.read.g{key[0]}s{key[1]}")
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as f:
                (hlen,) = struct.unpack("<Q", f.read(8))
                meta = json.loads(f.read(hlen).decode())
                parts = []
                for dstr, pshape in meta["parts"]:
                    p = np.empty(tuple(pshape), dtype=np.dtype(dstr))
                    if f.readinto(memoryview(p).cast("B")) != p.nbytes:
                        raise ValueError("truncated part")
                    parts.append(p)
        except (OSError, KeyError, ValueError, struct.error, json.JSONDecodeError) as e:
            raise faults.SpillIOError(f"spill read failed for {path}: {e}")
        enc = Encoded(meta["mode"], tuple(parts), tuple(meta["shape"]), self.dtype)
        self.timing["spill_read_s"] += time.perf_counter() - t0
        self.timing["spill_read_bytes"] += enc.nbytes
        return enc

    # ------------------------------------------------------------ LRU core
    def _evict_over_budget_locked(self) -> None:
        budget = self.config.dram_bytes
        if budget is None:
            return
        while self.dram_bytes > budget and self._dram:
            key, enc = self._dram.popitem(last=False)  # coldest
            self.dram_bytes -= enc.nbytes
            path = self._write_spill(key, enc)
            self._disk[key] = path
            self.stats["spills"] += 1
            self.stats["evictions"] += 1
            self.stats["disk_bytes"] = sum(
                os.path.getsize(p) for p in self._disk.values()
                if os.path.exists(p))

    def _put_key(self, key: Tuple[int, int], arr) -> None:
        t0 = time.perf_counter()
        enc, err = encode_shard(arr, self.config.at_rest_dtype)
        dt = time.perf_counter() - t0
        with self._lock:
            self.timing["encode_s"] += dt
            old = self._dram.pop(key, None)
            if old is not None:
                self.dram_bytes -= old.nbytes
            stale = self._disk.pop(key, None)
            if stale is not None:
                # must happen under the lock and BEFORE eviction runs:
                # the key's spill path is deterministic, so an eviction
                # (here or from a concurrent put/get once the lock drops)
                # may rewrite this very path — deleting it later would
                # destroy the fresh spill
                _remove(stale)
            self._dram[key] = enc  # MRU
            self.dram_bytes += enc.nbytes
            self.error_bound += err
            self.stats["puts"] += 1
            self.stats["peak_dram_bytes"] = max(
                self.stats["peak_dram_bytes"], self.dram_bytes)
            self._evict_over_budget_locked()

    def _get_key(self, key: Tuple[int, int]) -> Encoded:
        with self._lock:
            enc = self._dram.get(key)
            if enc is not None:
                self._dram.move_to_end(key)  # touch MRU
                self.stats["gets"] += 1
                return enc
            path = self._disk.get(key)
            if path is None:
                raise KeyError(f"shard {key} not in store")
            enc = self._read_spill(key, path)
            self.stats["gets"] += 1
            self.stats["spill_loads"] += 1
            budget = self.config.dram_bytes
            if budget is None or enc.nbytes <= budget:
                # re-admit as MRU (and evict colder shards); a shard bigger
                # than the whole budget stays disk-resident — re-admitting
                # it would immediately write it straight back out
                del self._disk[key]
                # delete the consumed spill file under the lock, before
                # eviction (or any later one) can rewrite the same
                # deterministic path with a fresh spill of this key
                _remove(path)
                self._dram[key] = enc
                self.dram_bytes += enc.nbytes
                self.stats["peak_dram_bytes"] = max(
                    self.stats["peak_dram_bytes"], self.dram_bytes)
                self._evict_over_budget_locked()
        return enc

    def _read_key(self, key: Tuple[int, int], keep: bool) -> Encoded:
        """The shard at ``key`` without re-admitting it to the DRAM tier:
        left where it is (``keep``) or taken out of the store. For a
        shard's last read of its generation (a remap's inputs, the final
        gather), where re-admitting it would only spill a colder shard."""
        with self._lock:
            enc = self._dram.get(key) if keep else self._dram.pop(key, None)
            if enc is not None:
                if not keep:
                    self.dram_bytes -= enc.nbytes
                self.stats["gets"] += 1
                return enc
            path = self._disk.get(key)
            if path is None:
                raise KeyError(f"shard {key} not in store")
            enc = self._read_spill(key, path)
            self.stats["gets"] += 1
            self.stats["spill_loads"] += 1
            if not keep:
                del self._disk[key]
                _remove(path)
        return enc

    def _decode_key(self, key: Tuple[int, int], out: Optional[torch.Tensor],
                    read: str = "get") -> torch.Tensor:
        """Decode the shard at ``key`` (into ``out``), read with LRU
        re-admission (``"get"``), or without: ``"peek"`` keeps it where it
        is, ``"take"`` removes it."""
        enc = self._get_key(key) if read == "get" else self._read_key(key, keep=read == "peek")
        t0 = time.perf_counter()
        out = decode_shard(enc, out)
        dt = time.perf_counter() - t0
        with self._lock:
            self.timing["decode_s"] += dt
        return out

    # ------------------------------------------------------------ public API
    def put(self, shard_id: int, arr) -> None:
        """Encode ``arr`` (the shard's ``lead + [shard_len]`` values, a CPU
        tensor or numpy array) as the current generation's shard
        ``shard_id``. ``arr`` may be reused once this returns."""
        self._put_key((self._gen, shard_id), arr)

    def get_decoded(self, shard_id: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Shard ``shard_id`` decoded, into ``out`` when given."""
        return self._decode_key((self._gen, shard_id), out)

    def stream_order(self) -> List[int]:
        """The current generation's shards in the order a pass that reads
        and rewrites each of them touches the disk least under the LRU
        budget: the DRAM-resident shards first (coldest first), then the
        spilled ones. Each spilled shard the pass reads is re-admitted and
        evicts the coldest resident, which the pass has already rewritten;
        in shard order, LRU would evict shards the pass has yet to read (a
        half-spilled state then moves every shard through the disk, not
        half of them)."""
        with self._lock:
            resident = [s for (g, s) in self._dram if g == self._gen]
        return resident + sorted(set(range(self.n_shards)) - set(resident))

    def resident_shards(self) -> Tuple[int, ...]:
        """Current-generation shard ids in the DRAM tier, coldest first."""
        with self._lock:
            return tuple(s for (g, s) in self._dram if g == self._gen)

    def spilled_shards(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(s for (g, s) in self._disk
                                if g == self._gen))

    def prefetch(self, shard_id: int, out: Optional[torch.Tensor] = None) -> Optional[Future]:
        """Schedule shard load + dequantize (into ``out`` when given) on the
        background worker; returns a Future of the decoded tensor (None when
        prefetch is off — callers fall back to a synchronous
        :meth:`get_decoded`)."""
        if not self.config.prefetch:
            return None
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="shardstore-prefetch")
            self.stats["prefetches"] += 1
            pool = self._pool
        return pool.submit(self.get_decoded, shard_id, out)

    # --------------------------------------------------------- bulk helpers
    def _buffer(self, name: str, shape: Tuple[int, ...]) -> torch.Tensor:
        buf = self._bufs.get(name)
        if buf is None or tuple(buf.shape) != tuple(shape):
            buf = self._bufs[name] = torch.empty(shape, dtype=self.dtype)
        return buf

    def _block(self) -> torch.Tensor:
        """The main thread's one-shard working buffer."""
        return self._buffer("block", self.lead_shape + (self.shard_len,))

    def fill(self, state=None) -> "ShardStore":
        """Populate generation 0 from a dense state (lead dims + [2^n], a
        CPU tensor or numpy array) or the |0..0> basis state
        (``state=None``). Records the initial norm the relative error
        tolerance is measured against."""
        ln = self.shard_len
        sq = 0.0
        block = self._block()
        if state is None:
            block.zero_()
        else:
            state = torch.as_tensor(state)
        for s in range(self.n_shards):
            if state is None:
                block[..., 0] = 1.0 if s == 0 else 0.0
            else:
                block.copy_(state[..., s * ln:(s + 1) * ln])
            f = torch.view_as_real(block).view(-1)
            for i in range(0, f.numel(), _CODEC_CHUNK):  # no shard-sized temporary
                sq += float(torch.dot(f[i:i + _CODEC_CHUNK], f[i:i + _CODEC_CHUNK]))
            self.put(s, block)
        lead = int(np.prod(self.lead_shape, dtype=np.int64))
        self.initial_norm = max(np.sqrt(sq / max(lead, 1)), 1e-30)
        return self

    def tile(self, P: int) -> "ShardStore":
        """A new store whose lead axis replicates this store's state P
        times (the fused parameter-sweep layout). Carries the source
        store's accumulated error bound forward."""
        out = ShardStore(self.n_shards, self.shard_len,
                         (P,) + self.lead_shape, self.dtype, self.config,
                         run_tag=self.run_tag + f"-x{P}")
        block = self._block()
        tiled = out._block()
        for s in range(self.n_shards):
            self._decode_key((self._gen, s), block, read="peek")
            tiled.copy_(block.unsqueeze(0).expand_as(tiled))
            out.put(s, tiled)
        out.error_bound += self.error_bound
        out.initial_norm = self.initial_norm
        return out

    def gather(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The full decoded state (lead dims + [2^n]), into ``out`` when
        given — the run's result extraction. Spilled shards are read where
        they lie (no re-admission, so nothing is spilled for it)."""
        if out is None:
            out = torch.empty(self.lead_shape + (self.n_shards * self.shard_len,),
                              dtype=self.dtype)
        ln = self.shard_len
        for s in range(self.n_shards):
            self._decode_key((self._gen, s), out[..., s * ln:(s + 1) * ln], read="peek")
        return out

    # --------------------------------------------------------------- remap
    def remap(self, spec, n: int) -> "ShardStore":
        """Out-of-core inter-stage bit permutation (never materializes the
        full state).

        For new bit p, ``result[x] = state[y ^ F]`` with ``bit_{src[p]}(y)
        = bit_p(x)`` and F the flip mask. An output shard (new nonlocal
        bits o) needs input shards spanning a subcube over the m old
        nonlocal bits that moved INTO the local tier; output shards that
        agree on every o-bit sourced from an old nonlocal bit share that
        subcube exactly. One group at a time: its 2^m input shards are
        taken out of the store and decoded once, in ascending shard order,
        into one ``[lead, 2^m, 2^L]`` block (group bit ``L + t`` = the t-th
        moved old bit), and each of its 2^m output shards is copied out of
        a permuted view of that block and put. The working set is ``2^m``
        decoded inputs + 1 output. Unlike the reference, an input is
        removed as it is read (not re-admitted, not deleted after the
        group), so the DRAM tier never spills a shard that is about to go:
        the same shards with less disk traffic."""
        src = spec.src_bit_of
        flips = set(spec.flip_bits)
        ln = self.shard_len
        L = ln.bit_length() - 1
        fixed_ps = [p for p in range(L, n) if src[p] >= L]  # o-bits -> old NL
        free_ps = [p for p in range(L, n) if src[p] < L]    # o-bits -> old L
        moved = sorted(src[i] for i in range(L) if src[i] >= L)  # old NL -> new L
        m = len(moved)
        gpos = {b: b for b in range(L)}
        gpos.update({b: L + t for t, b in enumerate(moved)})
        gsrc = [gpos[src[i]] for i in range(L)] + [gpos[src[p]] for p in free_ps]
        gflips = sorted(gpos[b] for b in flips if b in gpos)
        group = self._buffer("group", self.lead_shape + (1 << m, ln))
        gflat = group.view(self.lead_shape + ((1 << m) * ln,))
        out = self._block()
        newgen = self._gen + 1
        for fb in range(1 << len(fixed_ps)):
            base_sid = o_fixed = 0
            for j, p in enumerate(fixed_ps):
                bit = (fb >> j) & 1
                o_fixed |= bit << (p - L)
                base_sid |= (bit ^ (src[p] in flips)) << (src[p] - L)
            for j in range(1 << m):
                sid = base_sid
                for t, b in enumerate(moved):
                    sid |= ((j >> t) & 1) << (b - L)
                self._decode_key((self._gen, sid), group[..., j, :], read="take")
            for k in range(1 << m):
                o = o_fixed
                for t, p in enumerate(free_ps):
                    o |= ((k >> t) & 1) << (p - L)
                _permute_slice(gflat, gsrc, gflips, L, k, out)
                self._put_key((newgen, o), out)
        del group, gflat
        self._bufs.pop("group")  # 2^m decoded shards: not held between remaps
        self._gen = newgen
        self.stats["remaps"] += 1
        return self

    # ------------------------------------------------------------- snapshot
    def relative_error_bound(self) -> float:
        return self.error_bound / self.initial_norm

    def check_tolerance(self) -> None:
        """Reject the run when the accumulated quantization error bound
        exceeds the configured tolerance (typed, never a silent drop in
        accuracy)."""
        rel = self.relative_error_bound()
        if rel > self.config.error_tolerance:
            raise faults.StorageToleranceError(
                f"accumulated quantization error bound {rel:.3e} exceeds "
                f"tolerance {self.config.error_tolerance:.3e} "
                f"(at_rest_dtype={self.config.at_rest_dtype}); widen the "
                "tolerance or pick a higher-precision at-rest tier")

    def snapshot(self) -> Dict:
        """JSON-able per-run summary for provenance / serving stats."""
        with self._lock:
            resident = len(self._dram)
            spilled = len(self._disk)
        return {
            "at_rest_dtype": self.config.at_rest_dtype,
            "dram_budget_bytes": self.config.dram_bytes,
            "n_shards": self.n_shards,
            "resident_shards": resident,
            "spilled_shards": spilled,
            "dram_bytes": self.dram_bytes,
            "error_bound": self.error_bound,
            "relative_error_bound": self.relative_error_bound(),
            "error_tolerance": self.config.error_tolerance,
            **{k: v for k, v in self.stats.items()},
        }
