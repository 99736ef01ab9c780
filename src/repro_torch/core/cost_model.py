"""Kernel cost model (paper §VI-B), copied from the JAX package's planner.

The paper prices two kernel execution modes:

* **fusion** — pre-multiply the member gates into one ``2^k x 2^k`` unitary and
  apply it as a matrix product. Cost = f(k) only.
* **shared-memory (shm)** — stream state-vector blocks through on-chip memory
  and apply gates one by one. Cost = alpha + sum_g cost(g).

The constants below are the JAX reference's analytic planning constants,
kept unchanged so that this package's staging and kernelization produce
exactly the reference's plans for the same circuit. They are NOT figures
measured on or derived for the card this package runs on. A calibration
measured on the card by :mod:`repro_torch.sim.profiler` replaces them
(:meth:`CostModel.from_calibration`): ``engine_for`` plans on it whenever a
calibration file matches the device, and on these constants otherwise. Only
*relative* costs matter to the kernelizer; everything is in microseconds for
a 2^28-amplitude shard.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, fields, replace
from typing import Dict, Mapping, Optional

# the reference's planning constants (see module docstring)
PASS_US = 5243.0  # one read+write pass over a 2^28-amp shard
MXU_US_PER_2K = 43.8  # fusion matmul time per 2^k at k=0
LAUNCH_US = 10.0  # kernel dispatch overhead
SHM_GATE_US = 200.0  # per non-diagonal gate inside an shm block
SHM_DIAG_GATE_US = 100.0  # diagonal gates touch half the operand pairs
MAX_FUSION_QUBITS = 7  # largest fused unitary: 2^7 x 2^7
MAX_SHM_QUBITS = 13  # largest shm window: 2^13 complex64 = 64 KiB
IO_QUBITS = 3  # lowest physical qubits forced into every shm kernel

FUSION = 0
SHM = 1

# host<->device link for the DRAM-offload path (PCIe Gen4 x16-class; the
# paper's §VII-C regime). One *offload pass* moves a shard down and back.
HOST_LINK_GBPS = 32.0
AMP_BYTES = 8  # complex64

# disk/NVMe tier below host DRAM (the shard_store spill path): sequential
# bandwidth of the device the spilled at-rest shards sit on, and the
# at-rest bytes per amplitude (8 exact, 4 bf16, ~2 int8 — the tiered
# shard store sets this from its StorageConfig).
DISK_GBPS = 2.0
AT_REST_BYTES = float(AMP_BYTES)

# ILP staging communication weight: Eq. 2 prices a global-tier (inter-pod)
# qubit swap at ``comm_weight`` local-tier swaps. Part of the cost model so
# calibration / autotuning can vary it alongside the kernel constants.
COMM_WEIGHT = 3.0


class DegenerateCostModelError(ValueError):
    """A cost model whose table admits no finite-cost kernel choice (e.g.
    ``max_fusion_qubits < 1`` or an all-``inf`` calibration). Raised instead
    of silently returning an argmin over infinities."""


@dataclass(frozen=True)
class CostModel:
    """Parameterizable cost model: analytic defaults, synthetic test values,
    or measured calibrations (:meth:`from_calibration`) all share this shape.
    Every ILP staging and DP kernelization decision flows from one instance,
    including the host-link/offload constants."""

    pass_us: float = PASS_US
    mxu_us_per_2k: float = MXU_US_PER_2K
    launch_us: float = LAUNCH_US
    shm_gate_us: float = SHM_GATE_US
    shm_diag_gate_us: float = SHM_DIAG_GATE_US
    max_fusion_qubits: int = MAX_FUSION_QUBITS
    max_shm_qubits: int = MAX_SHM_QUBITS
    io_qubits: int = IO_QUBITS
    host_link_gbps: float = HOST_LINK_GBPS
    amp_bytes: int = AMP_BYTES
    comm_weight: float = COMM_WEIGHT
    disk_gbps: float = DISK_GBPS
    at_rest_bytes: float = AT_REST_BYTES

    def fusion_cost(self, k: int) -> float:
        if k > self.max_fusion_qubits:
            return float("inf")
        return self.launch_us + max(self.pass_us, self.mxu_us_per_2k * (2**k))

    def shm_open_cost(self) -> float:
        return self.launch_us + self.pass_us

    def shm_gate_cost(self, diagonal: bool) -> float:
        return self.shm_diag_gate_us if diagonal else self.shm_gate_us

    def kernel_close_cost(self, kind: int, n_qubits: int) -> float:
        if kind == FUSION:
            return self.fusion_cost(n_qubits)
        return self.shm_open_cost()

    def best_fusion_size(self) -> int:
        """Most cost-efficient fusion kernel size (cost per qubit covered).

        Raises :class:`DegenerateCostModelError` when no fusion size has a
        finite cost (``max_fusion_qubits < 1`` or a degenerate calibration) —
        an argmin over an all-``inf`` table would silently return an
        arbitrary size."""
        if self.max_fusion_qubits < 1:
            raise DegenerateCostModelError(
                f"max_fusion_qubits={self.max_fusion_qubits}: no fusion "
                "kernel size is admissible")
        import math

        finite = [
            k for k in range(1, self.max_fusion_qubits + 1)
            if math.isfinite(self.fusion_cost(k))
        ]
        if not finite:
            raise DegenerateCostModelError(
                "all fusion costs are non-finite (degenerate calibration: "
                f"pass_us={self.pass_us}, mxu_us_per_2k={self.mxu_us_per_2k}, "
                f"launch_us={self.launch_us})")
        return min(finite, key=lambda k: self.fusion_cost(k) / k)

    # ------------------------------------------------------------- offload
    def offload_pass_us(self, L: int, spill_fraction: float = 0.0) -> float:
        """Modeled host-link time for one read+write pass over a
        2^L-amplitude shard. With double-buffered streaming the link and the
        device overlap, so a stage's lower bound is max(link, memory) rather
        than their sum — bench_offload's overlap ratio measures progress
        against this.

        ``spill_fraction`` prices the tier the shards actually sit in: that
        fraction of shards additionally crosses the disk tier at
        ``at_rest_bytes`` per amplitude and ``disk_gbps`` bandwidth (the
        shard_store spill path — see :meth:`spill_pass_us`)."""
        link = 2 * self.amp_bytes * (1 << L) / (self.host_link_gbps * 1e3)
        if spill_fraction <= 0.0:
            return link
        return link + min(spill_fraction, 1.0) * self.spill_pass_us(L)

    def spill_pass_us(self, L: int) -> float:
        """Modeled disk time for one read+write pass over a 2^L-amplitude
        at-rest shard (``at_rest_bytes`` per amplitude each way)."""
        return 2 * self.at_rest_bytes * (1 << L) / (self.disk_gbps * 1e3)

    def stage_pass_us(self, n_passes: int, L: int = 28) -> float:
        """Memory cost of a stage that executes in ``n_passes`` memory passes
        (the compiled pass model: one per top-level op; an shm group of g
        gates is ONE pass — the alpha + sum_g cost(g) regime)."""
        frac = (1 << L) / (1 << 28)
        return n_passes * self.pass_us * frac

    # ----------------------------------------------------- (de)serialization
    def to_dict(self) -> Dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: Mapping) -> "CostModel":
        known = {f.name for f in fields(CostModel)}
        kw = {k: v for k, v in dict(d).items() if k in known}
        for f in fields(CostModel):
            if f.name in kw and f.type == "int":
                kw[f.name] = int(kw[f.name])
        return CostModel(**kw)

    @staticmethod
    def from_calibration(
        measurements: Mapping,
        base: Optional["CostModel"] = None,
    ) -> "CostModel":
        """Build a cost model from profiler measurements.

        ``measurements`` carries any subset of the dataclass field names
        (already reduced to the 2^28-amp-shard reference scale by
        :mod:`repro.sim.profiler`); missing fields inherit from ``base``
        (default: the analytic model). Measured float constants are floored
        at tiny positive values so a degenerate measurement (a 0.0 timer
        tick) can never poison the DP with zero/negative costs, and the
        capacity fields (``max_*``, ``io_qubits``) are kept integral.
        Raises :class:`DegenerateCostModelError` if the resulting model
        admits no finite fusion kernel."""
        base = DEFAULT_COST_MODEL if base is None else base
        kw = base.to_dict()
        floors = {
            "pass_us": 1e-3, "mxu_us_per_2k": 1e-6, "launch_us": 0.0,
            "shm_gate_us": 1e-4, "shm_diag_gate_us": 1e-4,
            "host_link_gbps": 1e-3, "comm_weight": 1e-3,
            "disk_gbps": 1e-3, "at_rest_bytes": 0.25,
        }
        for f in fields(CostModel):
            name = f.name
            if name not in measurements:
                continue
            v = measurements[name]
            if v is None:
                continue
            if name in floors:
                v = float(v)
                if not (v == v) or v in (float("inf"), float("-inf")):
                    continue  # NaN/inf measurement: keep the base value
                kw[name] = max(v, floors[name])
            else:
                kw[name] = int(v)
        cm = CostModel(**kw)
        cm.best_fusion_size()  # raises DegenerateCostModelError if unusable
        return cm

    def with_overrides(self, **kw) -> "CostModel":
        """A copy with some fields replaced (autotune candidate knobs)."""
        return replace(self, **kw)


DEFAULT_COST_MODEL = CostModel()


# ---------------------------------------------------------------------------
# Module-level compatibility shims over DEFAULT_COST_MODEL
# ---------------------------------------------------------------------------


def offload_pass_us(L: int) -> float:
    """Shim: :meth:`CostModel.offload_pass_us` on the analytic defaults."""
    return DEFAULT_COST_MODEL.offload_pass_us(L)


def stage_pass_us(n_passes: int, L: int = 28) -> float:
    """Shim: :meth:`CostModel.stage_pass_us` on the analytic defaults."""
    return DEFAULT_COST_MODEL.stage_pass_us(n_passes, L)


def fusion_cost(k: int) -> float:
    """Cost of a k-qubit fusion kernel (us per 2^28-amp shard)."""
    return DEFAULT_COST_MODEL.fusion_cost(k)


def shm_open_cost() -> float:
    """alpha: streaming a shard through on-chip memory once."""
    return DEFAULT_COST_MODEL.shm_open_cost()


def shm_gate_cost(diagonal: bool) -> float:
    return DEFAULT_COST_MODEL.shm_gate_cost(diagonal)


def best_fusion_size() -> int:
    """Most cost-efficient fusion kernel size (cost per qubit covered)."""
    return DEFAULT_COST_MODEL.best_fusion_size()
