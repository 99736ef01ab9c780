"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, drives the
port's main path (``repro_torch.launch.simulate``) at full width —
``ising(30)`` with L=28, R=2: a 2^30-amplitude complex64 state, 8 GiB —
and checks it against the port's dense per-gate oracle on the card, then
runs ``qft(22)`` with ``--check`` against the host complex128 oracle. Then
the engine entry point: ``isingparam(30)`` through ``--engine --bind``
(cold build) and a warm rebind through the compile cache; a sweep of 16
bindings of ``isingparam(28)`` as one ``[16, 2^28]`` state (2^32
amplitudes); a batch of 3 basis states of ``qft(28)``. Each of those runs
every kernel once per compiled op, whatever the number of states, and is
held against the dense per-gate oracle on the card; every kernel op of each
of them is held against its plain version as that path launches it (its
shard count, operand tables and variant indices).

Then the explicit-collective backend: the main path's ``ising(30)`` plan on
4 spawned ranks of one gloo group (one 2 GiB shard each, all on the one
card) through ``ShardMapExecutor`` with the hand kernels, against the same
plan on ``CudaBackend``: kernel launches per rank, every shard through every
256th amplitude and a checksum of its bits (within 1e-6, and whether bit
for bit), each remap's m, permute, bytes per rank against Eq. 2 and
seconds, peak device memory per rank, and the marginal ``(0, 1, 2)`` and
``<Z0 Z1 + 0.5*X29>`` (plus an X term on a device qubit when qubit 29 is
local in the plan's last layout) through ``ShardedMeasurer`` against
``TorchMeasurer`` on the in-card state (the shardmap serving phase holds
``ShardedMeasurer``'s shots on 2^26 shards); the
first and last rank hold every kernel op at their shard and variants
against its plain version. Then world size 1 over NCCL: ``qft(28)`` at
L=28 through ``ShardMapExecutor`` bit for bit against ``CudaBackend``.
Then the multi-process entry point, ``repro_torch.launch.simulate
--executor shardmap`` under ``torchrun`` (a subprocess with a timeout,
after this process frees its device memory): the main path's ``ising(30)``
plan on 4 gloo ranks of the one card, its printed program held to the
in-card plan's, each rank's launches to it, each remap's printed bytes to
Eq. 2, and the marginal ``(0, 1, 2)`` and ``<Z0 Z1 + 0.5*X29 + 0.25*X0>``
to ``TorchMeasurer`` on the in-card state; then ``isingparam(28)`` at world
size 1 over NCCL, its marginal bit for bit a ``CudaBackend`` engine's. Then
gradients on the shardmap backend: ``--vqe`` (one Adam step, two
value_and_grad calls) of ``isingparam(28)`` L=26 R=2 under ``torchrun`` on
4 gloo ranks, each sweeping its own 512 MiB shard back through the plan's
stages (every ``U†``, ``∂U`` and local Pauli op one ``fused_apply``
launch), held to one ``CudaBackend`` value_and_grad of the same plan (value
within 1e-5, gradient within 1e-4), with each rank's launches, sweep bytes
against their bound, inverse remaps against Eq. 2, peak (four shards and 1
GiB) and the first call's split (forward, λ, sweep kernels, sweep remaps);
``fused_apply`` at k=1 and k=2 on one 2^26 shard timed beside its plain
version and torch.matmul. The shardmap phase's ranks also run a sharded
value_and_grad of ``isingparam(27)`` and hold a sample of its sweep's
launches on ranks 0 and 3 against the plain version.

Then adjoint gradients: the ``--vqe`` loop on ``isingparam(30)`` L=28 R=2
(two Adam steps; every gate, derivative and Pauli application of each
reverse sweep one ``fused_apply`` launch), its first gradient held against
the same sweep through the plain version on the card, against central
finite differences of the on-card energy and against the complex128
oracle on the observable's light cone, a sample of the sweep's launches
at k=1 and k=2 against the plain version, and the value_and_grad split
(forward, λ, sweep) and peak device memory; ``su2param(20)`` L=18 R=2
against the complex128 oracle on the host; ``grad_sweep`` of 4 bindings of
``isingparam(28)`` as one ``[4, 2^28]`` sweep against each point alone;
``value_and_grad`` of ``isingparam(28)`` L=24 R=4 through the offload
backend against the in-card one.

Then host offload: the pinned link rates; ``ising(31)`` L=27 R=4 through
``--executor offload`` — a 16 GiB pinned host state in 16 shards of 1 GiB,
every stage streamed through the card shard by shard, one launch per op
and shard — with per-stage GB/s against the link bounds, the host remaps,
the measurement split, the peak device memory (at most four shards), the
state against the in-card run of the same plan shard by shard, a warm run
after a rebind that pins no state buffer, and every kernel op on shards 0 and 15
against its plain version; ``qft(26)`` through the staged offload path and
the per-gate baseline; an offload batch of 2 ``qft(28)`` states and a sweep
of 4 ``isingparam(28)`` bindings against the in-card ones, their kernel ops
on shard 0 against the plain versions.

Then the offload backend's shard store and stage checkpoints: the spill
directory's disk and the host's memory; ``ising(27)`` L=23 R=4 through
``--executor offload --storage bf16`` with a DRAM budget of half the 512 MiB
at rest (the rest spilled to disk under ``build/``), held shard by shard
within its own error bound against the in-card run of the same plan, with
its stage, out-of-core remap and spill figures; on that state, Pauli terms
with 2 and 3 non-local X/Y qubits through the streaming measurer (its peak
device memory, and the values against the same terms on the in-card state);
``ising(26)`` L=22 R=4 through the int8 tier, spilled, under the same checks;
and ``ising(26)`` L=22 R=4 with ``--checkpoint-dir``, killed by an injected
``shard_transfer_error`` inside stage 1 and resumed in a fresh engine to the
uninterrupted run's state bit for bit, that run held against the in-card
run of its plan and its kernel ops on shards 0 and 15 against their plain
versions.

Then the profiler, calibrated planning, autotune and the faults (the
smoke points ``REPRO_CALIBRATION_DIR`` at a fresh ``build/calibration``
first, so every phase above plans on the reference's analytic constants
as before): ``python -m repro_torch.sim.profiler --L 28 --repeats 3
--verify`` through ``main(argv)`` (each field beside the constant it
replaces; both kernels launched by the profile); ``ising(28)`` and
``qsvm(28)`` L=26 R=2 planned under the resolved calibration against the
analytic constants (stages, fused widths, shm ops, run seconds, both
against the dense oracle on the card, the calibrated engine's kernel ops
against their plain versions); ``--autotune`` on ``ising(27)`` (every
candidate's replay, the choice, the tuning's peak device memory; then
``engine_for`` with default knobs is a cache hit with no solver call); the
integrity guard at n=28 (clean ``run``/``run_packed`` with ``verify=True``
and no retry, an injected NaN recovered by one re-run of the plan through
the hand kernels, a sweep of 4 ``isingparam(28)`` bindings with one
poisoned row) and the typed
build faults (``xla_trace_error`` at ``cuda.setup``,
``pallas_lowering_error`` at ``engine.init``) raised out of
``engine_for`` with no other engine built.

Then the simulation service (``repro_torch.serve``, what ``python -m
repro_torch.launch.serve_sim`` drives), planned on that calibration:
``SimulationService`` with its defaults (the card, the hand kernels), max
batch 8, max wait 5 ms, tenants gold (weight 4) and free (1); one warm-up
request each for ``isingparam(26)``, ``su2param(26)`` at one layer (L=24, R=2),
``qft(26)`` and ``ising(28)`` (L=26, R=2),
then a burst of 40 parameterized requests (``<Z0 Z1 + 0.5*X2>`` each, 4
with 64 shots and a marginal), 3 identical ``qft(26)`` requests and one
``ising(28)``: no
solver call, no shm program scheduled and no cache miss, each batch one
launch per compiled op, the ``qft`` group one run; every response against
its binding run alone on the same engine, the first point of each
structure against the dense oracle on the card, every kernel op of a
served ``isingparam`` batch against its plain version; a malformed rider
failing alone, a NaN recovered by one re-run through the kernels, a kernel
build failure quarantined; the JSON-lines front end on the loopback; and
each structure's warm run planned on the calibration against the analytic
constants. It prints the stage percentiles, the coalesce factor, the
padded-row share, the launches of every batch and the peak device memory.
Then serving on the shardmap backend: ``serve_sim --backend shardmap`` under
``torchrun`` on 4 gloo ranks of the card (``isingparam(28)`` L=26 R=2, one
512 MiB shard a rank, the card's calibration), driven as a client over the
wire: 8 ``isingparam(28)`` requests with an X term on a device qubit (two
batches of 4; one with 64 shots and a marginal) and 2 identical concrete
``ising(28)`` requests (one dedup run), then ``stats``; each answer held to
the binding run alone on ``CudaBackend`` (``TorchMeasurer``'s shots for the
seed), and from ``stats()["ranks"]`` each rank's launches (the plan's ops
times the rows), each remap's bytes (Eq. 2), the warm batch's solver
calls, shm schedules and cache misses (none) and peak; then the session is
ended and every rank must be gone.

Then LM serving (``repro_torch.launch.serve_llm`` over ``repro_torch.models``,
plain PyTorch: no ``pallas_call`` is on that path, so neither hand kernel
may launch): qwen2-1.5b, mamba2-1.3b and whisper-base at full width with
random weights from the seed, each served by ``serve_llm.main`` (4 prompts
of 128 tokens, 16 generated: the tokens' shape and range, prefill seconds,
decode ms a step and tokens per second, peak device memory); each float32
twin's cache held against its forward (prefill of 128 tokens and 16
teacher-forced decode steps against one forward over the 144 tokens) within
1e-3, or twice the twin's own rounding floor where that is larger; qwen2's
bf16 cache against its forward within twice the bf16 forward's departure
from the float32 twin; and qwen2's first two layers at full width, float32,
on the card against the same weights on the CPU within 1e-3.

Then LM training (``repro_torch.launch.train`` over ``make_train_step``,
AdamW and the checkpoint manager, plain PyTorch: neither hand kernel may
launch): qwen2-1.5b at full width and depth, bf16, remat on, 10 steps of 8
x 128 tokens through ``train.run`` (every loss and grad norm finite, the
last three losses' mean below the first; the median step ms after the
first two, tokens per second, peak device memory; one more step traced),
then one step with remat off, whose peak must be above remat's;
mamba2-1.3b at full width, 3 steps; the reference test's learning
criterion (reduced qwen2, 120 steps, a drop of 0.3); one float32 step of
qwen2's first two layers at full width on the card against the CPU (loss,
every gradient leaf, the updated parameters); and a run of qwen2 at full
width cut to two layers that stops with a checkpoint under ``build/``,
then a second call that resumes from it (one restart, the last step, both
checkpoints restored bit for bit equal to the state that was saved).
(To make room for this phase, the shardmap gradients were cut from n=30 to
29, shardmap serving from n=30 to 28, the VQE loop from three Adam steps
to two, and LM serving's generation from 32 tokens to 16.)

Then LM sharding (``models/sharding.py``, ``models/parallel.py``,
``launch/mesh.py``; plain PyTorch, neither hand kernel may launch on any
rank; attention, MLA, Mamba-2's heads, the MLPs and the vocabulary tensor
parallel over the model axis): qwen2-1.5b at full width on 4 gloo ranks of
the card as data 2 x model 2, one ``torchrun`` of ``chip_smoke.py
--lm-shard-check``: which collectives gloo runs on CUDA tensors; in bf16 at
full depth, ``serve_llm.run`` (4 prompts of 128, 8 generated) and
``train.run`` (2 steps of 8 x 128, remat) with ``--data-par 2 --model-par 2
--dist-backend gloo`` in the ranks' own processes: decode ms a step, step
ms, collective bytes per rank (every rank's equal to the census of the same
steps on a fake 2 x 2 group, computed beside it with no card visible),
every rank's peak; then the float32 checks of qwen2-1.5b, mamba2-1.3b and
deepseek-v2-lite-16b at two layers of full width against rank 0's one-card
run of the same weights (deepseek's a data shard at a time: a MoE's
capacity is per shard): prefill and 3 decode steps' logits (teacher-forced
on the one-card greedy tokens) within twice the one-card floor (one ulp of
the embedding, or each row run alone), one train step's gradients (each
leaf within 1e-4 of its largest), loss and grad norm (rtol 1e-5) and
parameters (0.5 lr where the gradient's sign is held), each arch's model-axis-local leaves and collectives by kind. (To make room for it, the
store and checkpoint runs were cut by two qubits each, the shardmap
gradients from n=29 to 28, and ``--autotune`` from ``ising(28)`` to
``ising(27)``.)

Then the LM dry run (``repro_torch.launch.dryrun``,
``launch/hlo_analysis.py``; plain PyTorch, neither hand kernel may launch):
``qwen2-1.5b x train_4k`` on the 16x16 mesh and ``deepseek-v3-671b x
decode_32k`` on 2x16x16, each through the CLI in a process with no card
visible (per device: flops, bytes, collectives, peak against 80 GB, the
dominant term, seconds); then the census of a full-width qwen2-1.5b train
step and decode step on the card against the card's own figures (its peak
within 10% of ``max_memory_allocated``, its op count within 2x of the
profiler's kernel count, its flops and bytes over the data-sheet peaks
beside the step's ms).

Then the twins of the repository's four examples (``repro_torch.examples``),
each through its own ``python -m`` entry point in a process of its own (and
session: killed whole on a timeout), each ending with ``OK``: ``quickstart``
(``qft(12)`` L=9 R=2 G=1 against the dense oracle; the launches of its
plan's ops), ``simulate_qft`` (``qft(20)`` L=17 on 8 spawned gloo ranks of
the card, every rank's kernel launches summed; each path's fidelity and
seconds, each backend's ``<obs>`` against the oracle's, and the seconds
until the 8 ranks joined), ``serve_lm`` (reduced deepseek-v2-lite; tokens/s)
and ``train_lm`` at its accelerator width (``--d-model 768 --layers 12``;
the first and last loss, which must fall). Their launches count under
``launches_by_path``: ``quickstart`` and ``simulate_qft`` through the
kernels, the LM twins neither kernel. (To make room for it, the LM
sharding phase's generation was cut from 8 tokens to 4.)

Prints the card's name and power limit, the ``shm_apply`` member-count /
window sweep on the widest group as a diagnostic line, one JSON line of
kernel figures (``fused_apply`` per width k beside ``torch.matmul``, both
bounds), and last ``{"ok": true, "device": {...}}``. Any failed phase raises: the
exit code is then non-zero and no result is printed. Needs CUDA.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ATOL = 1e-4  # kernel vs plain version, O(1) amplitudes in float32
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 on CUDA cores (data sheet)
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 on the tensor cores (data sheet)
TF32_PASSES = 3  # fused_apply's 3xTF32 split: three TF32 products per fp32 one
KARATSUBA_OPS = 6  # fused_apply's real operations per complex multiply-add (3 products)
REPLACES = {
    "fused_apply": "src/repro/kernels/fusion.py:58",
    "shm_apply": "src/repro/kernels/shm.py:134",
}
SOURCES = {
    "fused_apply": "src/repro_torch/kernels/csrc/fused_apply.cu",
    "shm_apply": "src/repro_torch/kernels/csrc/shm_apply.cu",
}
MAIN_PATH = ["--circuit", "ising", "--n", "30", "--L", "28", "--R", "2", "--shots", "1024",
             "--marginal", "0,1,2", "--observable", "Z0 Z1 + 0.5*X2"]
CHECKED_PATH = ["--circuit", "qft", "--n", "22", "--L", "20", "--R", "2", "--check"]
ENGINE_PATH = ["--circuit", "isingparam", "--n", "30", "--L", "28", "--R", "2", "--engine",
               "--bind", "J=0.35", "--bind", "h=0.8", "--marginal", "0,1,2",
               "--observable", "Z0 Z1 + 0.5*X2"]
REBIND = {"J": 0.9, "h": 0.2}
SWEEP = {"n": 28, "L": 26, "R": 2, "P": 16}  # [16, 2^28] complex64: 2^32 amplitudes, 32 GiB
BATCH = {"n": 28, "L": 26, "R": 2, "B": 3}  # qft(28), basis states 0, 1, 2
# 16 shards of 1 GiB: a 16 GiB pinned host state. ising(32) (32 GiB, the
# largest the card's host of about 100 GB holds beside the second state a
# host remap writes) ran here until the torchrun phases needed its time;
# the shots sample a host float64 CDF of each distinct shard they hit, so 4
# shots (not 64, which hit 14 of the 16 shards) keep that cost to a few
OFFLOAD_SHOTS = 4
OFFLOAD_PATH = ["--circuit", "ising", "--n", "31", "--L", "27", "--R", "4", "--executor",
                "offload", "--shots", str(OFFLOAD_SHOTS), "--marginal", "0,1,2",
                "--observable", "Z0 Z1 + 0.5*X2"]
PERGATE = {"n": 26, "L": 22, "R": 4}  # qft(26): staged offload against the per-gate baseline
OFFLOAD_ROWS = {"n": 28, "L": 26, "R": 2, "B": 2, "P": 4}
FIDELITY_MIN = 1 - 1e-5
# the shard store: ising(27) at rest in bf16 (512 MiB) with half of it in a
# DRAM budget, the rest on disk; ising(26) in int8 (64 MiB at rest) with
# half spilled. int8 loses ~0.75% of a shard's norm per encode and a run
# encodes every shard three times, which the default tolerance (0.05) does
# not allow: the int8 run takes 0.25. The store and checkpoint runs were cut
# by two qubits each (from ising(32) L=28, ising(30) L=26 and ising(30)
# L=26; 16 shards each, as before) to pay for the torchrun phases within
# the smoke's time, and the two store runs by one more (from ising(30) L=26
# and ising(29) L=25) for the shardmap serving phase, and all three by two
# more (from ising(29) L=25, ising(28) L=24 and ising(28) L=24) for the LM
# sharding phase
STORE = {"tier": "bf16", "n": 27, "L": 23, "R": 4, "dram_fraction": 0.5, "tol": 0.05}
STORE_INT8 = {"tier": "int8", "n": 26, "L": 22, "R": 4, "dram_fraction": 0.5, "tol": 0.25}
CHECKPOINT = {"n": 26, "L": 22, "R": 4}
# adjoint gradients: the reference's tolerances (tests/test_grad.py) for a
# float32 sweep against another sweep or an oracle, and central differences
# of the on-card energy (their truncation error at eps 1e-2 is 1.8e-4 of
# the gradient on this path, by the complex128 oracle)
VQE_OBS = "Z0 Z1 + Z1 Z2 + 0.5*X0"
VQE_STEPS = 2  # 3 before the training phase was added
VQE_PATH = ["--circuit", "isingparam", "--n", "30", "--L", "28", "--R", "2", "--vqe", VQE_OBS,
            "--vqe-steps", str(VQE_STEPS)]
VQE_SEED = 0  # the CLI's --vqe-seed: the angles of the first value_and_grad
VALUE_ATOL, GRAD_ATOL, ROW_ATOL = 2e-5, 1e-4, 2e-4
FD_EPS, FD_RTOL = 1e-2, 2e-3
# isingparam runs two Trotter steps of nearest-neighbour gates, so VQE_OBS
# (qubits 0-2) sees qubits 0-4 only: its energy and gradient at any width
# are those at n=10, where the host's complex128 oracle is cheap
LIGHT_CONE_N = 10
ORACLE = {"n": 20, "L": 18, "R": 2, "reps": 1}  # su2param(20): 270 gates, 80 parameters
ORACLE_OBS = "Z0 Z1 + 0.5*X19 - 0.3*Y5 X12 + 0.1"
GRAD_SWEEP = {"n": 28, "L": 26, "R": 2, "P": 4}
OFFLOAD_GRAD = {"n": 28, "L": 24, "R": 4}  # 16 host shards of 2^24
SPILL_ROOT = os.path.join(HERE, "build", "spill")
# the profiler, calibrated planning, autotune and the faults: the smoke's own
# calibration directory, empty until the calibration phase writes it, so
# every earlier phase plans on the analytic constants as before
CALIBRATION_DIR = os.path.join(HERE, "build", "calibration")
CALIBRATION_L, CALIBRATION_REPEATS = 28, 3  # the disk round trip of 2 GiB takes seconds
# planned at n=28 on the L=28 profile: at n=30 each dense oracle takes ~17 s
CALIBRATED = {"n": 28, "L": 26, "R": 2, "families": ("ising", "qsvm")}
# (ising(28) L=26 until the LM sharding phase took its time)
AUTOTUNE = {"n": 27, "L": 25, "R": 2}
AUTOTUNE_PATH = ["--circuit", "ising", "--n", "27", "--L", "25", "--R", "2", "--autotune"]
FAULTS = {"n": 28, "L": 26, "R": 2, "P": 4}
CHECKPOINT_DIR = os.path.join(HERE, "build", "checkpoint")
# the simulation service on the card, planned on the card's calibration (it
# runs after the profiler): 40 parameterized requests over isingparam(26) and
# su2param(26) (a full batch of 8 rows is 4 GiB), 4 of them with shots and a
# marginal (host sampling of 2^26 amplitudes costs seconds), 3 identical
# qft(26) requests (one dedup run) and one ising(28) request (the shardmap
# serving phase serves n=30); every served row's amplitudes are held
# through every STRIDE-th amplitude. su2param runs one layer (depth cut
# from the generator's 3: the staging ILP of its gates, planned twice here,
# calibrated and analytic, would dominate the phase). At n=28 the runs
# alone and the dense oracles took 53 of the phase's 115 s
SERVE = {"n": 26, "L": 24, "R": 2, "su2param_reps": 1, "requests": 40, "shots": 64,
         "shot_requests": (0, 11, 20, 31), "qft": 3, "main_n": 28, "main_L": 26, "seed": 41,
         "stride": 1 << 8}
SERVE_CONFIG = {"max_batch_size": 8, "max_wait_ms": 5.0, "cache_size": 4,
                "tenant_weights": {"gold": 4.0, "free": 1.0}}
SERVE_OBS = "Z0 Z1 + 0.5*X2"
SERVE_ATOL = 1e-5  # a served row against the same binding run alone
# the explicit-collective backend: the main path's ising(30) plan (L=28,
# R=2) on 4 ranks of one gloo group, each holding one 2^28 shard (2 GiB) on
# the one card (NCCL refuses two ranks on one GPU), held shard by shard
# against the in-card run through every STRIDE-th amplitude and a checksum
# of every bit, its marginal and expectation against TorchMeasurer on the
# in-card state (no shots: their 22.8 s went to the shardmap serving phase,
# which holds ShardedMeasurer's shots on 2^26 shards of n=28); then world
# size 1 over NCCL (qft(28), L=28: no collective runs) bit for bit
SHARDMAP = {"ranks": 4, "stride": 1 << 8, "marginal": (0, 1, 2),
            "observable": "Z0 Z1 + 0.5*X29", "atol": 1e-6, "timeout": 600}
SHARDMAP_NCCL = {"n": 28, "L": 28}
RENDEZVOUS_DIR = os.path.join(HERE, "build", "rendezvous")
# the multi-process entry point: the CLI under torchrun, one launch of 4
# gloo ranks on the one card whose ranks call the CLI's entry point in
# process (each launch costs 20-26 s of fixed time on the card's host, so
# the three runs share one). The main path's ising(30) plan (no shots: the
# shardmap phase holds the sharded shots), held to the in-card plan and
# TorchMeasurer on the in-card state; then the gradients below; then, on
# rank 0 alone, isingparam(28) at world size 1 over NCCL, held bit for bit
# to a CudaBackend engine of the same plan. All run before the calibration
# phase, so every rank plans on the analytic constants. "timeout": the
# launch's.
SHARDMAP_CLI = {"ranks": 4, "marginal": (0, 1, 2), "observable": "Z0 Z1 + 0.5*X29 + 0.25*X0",
                "atol": 1e-6, "timeout": 600}
SHARDMAP_CLI_PATH = ["--circuit", "ising", "--qubits", "30", "--L", "28", "--R", "2", "--executor",
                     "shardmap", "--dist-backend", "gloo", "--marginal", "0,1,2",
                     "--observable", SHARDMAP_CLI["observable"]]
SHARDMAP_CLI_NCCL = {"n": 28, "bind": {"J": 0.35, "h": 0.8}, "marginal": (0, 1, 2)}
SHARDMAP_CLI_NCCL_PATH = ["--circuit", "isingparam", "--qubits", "28", "--L", "28", "--engine",
                          "--bind", "J=0.35", "--bind", "h=0.8", "--marginal", "0,1,2",
                          "--executor", "shardmap"]
RESULTS_DIR = os.path.join(HERE, "build", "results")
# gradients on the shardmap backend: the CLI's --vqe in the same launch's 4
# gloo ranks of the one card, isingparam(28) at L=26 R=2 (one 512 MiB shard
# a rank), one Adam step (two value_and_grad calls), held to one CudaBackend
# value_and_grad of the same plan at the first angles. The observable is
# VQE_OBS plus a term with X and Y on the last stage's two device qubits
# (the sweep builds λ in that stage's frame), so λ needs the permute. The
# shardmap phase's ranks run a sharded value_and_grad of isingparam(27)
# L=25 and hold a sample of its sweep's k=1 and k=2 launches on ranks 0 and
# 3 against the plain version.
# (n=29 L=27 and a sample at n=28 L=26 until the LM sharding phase took
# its time)
SHARDMAP_VQE = {"ranks": 4, "n": 28, "L": 26, "R": 2, "value_atol": 1e-5,
                "grad_atol": 1e-4, "sample_n": 27, "sample_L": 25, "sample_seed": 43}
SHARDMAP_VQE_PATH = ["--circuit", "isingparam", "--qubits", "28", "--L", "26", "--R", "2",
                     "--executor", "shardmap", "--dist-backend", "gloo", "--vqe-steps", "1"]
# serving on the shardmap backend: serve_sim --backend shardmap under
# torchrun on 4 gloo ranks of the one card (one 2^26 shard of isingparam(28)
# a rank), after the serving phase, so every rank plans on the card's
# calibration. A client sends, all at once over the wire: 8 isingparam(28)
# requests (two batches of 4) with <Z0 Z1 + 0.5*X<d>>, d a device qubit of
# the last stage, one of them with 64 shots and the marginal (0, 1, 2); two
# identical concrete ising(28) requests (one dedup run, amp0); then stats.
# (n=30 until the training phase took its time: gloo's remaps and the
# sampling scale with the shard.)
SERVE_SHARDMAP = {"ranks": 4, "n": 28, "L": 26, "R": 2, "requests": 8, "max_batch": 4,
                  "max_wait_ms": 500.0, "shots": 64, "shot_request": 5, "marginal": (0, 1, 2),
                  "dedup": 2, "seed": 53, "atol": 1e-6, "start_timeout": 300, "timeout": 600}
# a rank's peak: two shards in a run; a shard, its partner and their float32
# product in a device-X expectation (20 x 2^L bytes: 5 GiB at L=28); the
# guard's norm pass, whose float32 squares of one 2^24-amplitude chunk
# (128 MiB, engine._sq_norms) hide under that at L=28 but add to it at
# L=26 (measured 20 x 2^26 + 128 MiB + 285696 bytes on rank 0 of an H100);
# plus the plan's op tables and index tensors, measured at 1383424 bytes
# on every rank at L=28; 4 MiB is three times that
SERVE_SHARDMAP_PEAK = 20 * (1 << SERVE_SHARDMAP["L"]) + (8 << 24) + (4 << 20)
# LM serving (repro_torch.launch.serve_llm and repro_torch.models): three
# registered archs at full width with random weights from the seed (no
# checkpoint is in the repository): qwen2-1.5b (28 layers, GQA 12:2 at hd
# 128, qkv bias, tied 152064-row head), mamba2-1.3b (48 layers, d_inner
# 4096, 64 heads, state 128) and whisper-base (a 1500-frame encoder,
# cross-attention in every layer, an untied head). Each is served by the CLI
# (4 prompts of 128 tokens, 16 generated), then its float32 twin's cache is
# held against its forward: prefill of 128 tokens into a cache of 144 and 16
# teacher-forced decode steps against one forward over the 144 tokens (32
# before the training phase was added),
# within 1e-3 on logits of order 1 (TF32 off; a bf16 computation would miss
# it), or within twice the model's own float32 rounding floor where that is
# larger: mamba2 with random weights moves its logits by 7.2e-4 when its
# embedding table moves by one ulp, at 16 of its layers on the CPU. qwen2
# also in its bf16, and its first cpu_layers layers at full width on the
# card against the CPU.
LM = {"archs": ("qwen2-1.5b", "mamba2-1.3b", "whisper-base"), "bf16_arch": "qwen2-1.5b",
      "batch": 4, "prompt": 128, "gen": 16, "seed": 0, "atol": 1e-3, "cpu_layers": 2,
      "cpu_tokens": 32}
LM_SERVE = ["--batch", str(LM["batch"]), "--prompt-len", str(LM["prompt"]), "--gen-len",
            str(LM["gen"]), "--seed", str(LM["seed"])]


def require(ok: bool, msg: str) -> None:
    """A phase check: raises (so the run exits non-zero) when it fails."""
    if not ok:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def gib(b: float) -> str:
    return f"{b / 2**30:.2f} GiB"


def random_state(n: int, gen: torch.Generator) -> torch.Tensor:
    """O(1) complex64 amplitudes, so atol 1e-4 is a real test."""
    return torch.randn(1 << n, dtype=torch.complex64, device="cuda", generator=gen)


def random_unitaries(V: int, k: int, gen: torch.Generator) -> torch.Tensor:
    z = torch.randn(V, 1 << k, 1 << k, dtype=torch.complex64, device="cuda", generator=gen)
    return torch.linalg.qr(z)[0].contiguous()


def random_phases(V: int, k: int, gen: torch.Generator) -> torch.Tensor:
    theta = torch.rand(V, 1 << k, device="cuda", generator=gen) * (2 * np.pi)
    return torch.polar(torch.ones_like(theta), theta).contiguous()


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def variant_index(S: int, V: int) -> torch.Tensor:
    return torch.tensor([(s * 7 + 1) % V for s in range(S)], dtype=torch.int32, device="cuda")


def kernel_sweep(ops, ref, n: int, L: int, gen: torch.Generator) -> dict:
    """Every kernel against its plain version at the main path's state size,
    on target bits and windows away from the lowest bits. Returns the worst
    error by kernel."""
    S = 1 << (n - L)
    worst = {"fused": 0.0, "shm": 0.0}
    x = random_state(n, gen)
    for k in (1, 2, 3, 4, 5, 6, 7):
        bits = [3, 4, 9, 10, 11, 20, 6][:k] if k == 7 else [L - 1 - 3 * j for j in range(k)]
        for V in (1, 2):
            u, vidx = random_unitaries(V, k, gen), variant_index(S, V)
            err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, L),
                          ref.fused_apply_ref(x.clone(), u, vidx, bits, L))
            torch.cuda.synchronize()
            log(f"  fused_apply k={k} V={V} bits={bits}: max |kernel - plain| = {err:.3e}")
            require(err < ATOL, f"fused_apply k={k} V={V} disagrees with its plain version")
            worst["fused"] = max(worst["fused"], err)
    rng = np.random.default_rng(0)
    for a, lo in ((9, 6), (10, 11), (13, 6)):
        window = list(range(lo, lo + a))
        members = []
        for q in range(12):
            kind = "mat" if q % 3 != 2 else "diag"
            kg = {4: 3, 7: 4}.get(q, 1 + q % 2) if kind == "mat" else 3
            bits = tuple(int(b) for b in rng.choice(window, size=kg, replace=False))
            op = random_unitaries(2, kg, gen) if kind == "mat" else random_phases(2, kg, gen)
            members.append((kind, bits, op, variant_index(S, 2)))
        err = max_err(ops.shm_apply(x.clone(), window, members, L),
                      ref.shm_apply_ref(x.clone(), window, members, L))
        torch.cuda.synchronize()
        log(f"  shm_apply a={a} window={lo}..{lo + a - 1} 12 members (1- to 4-bit): "
            f"max |kernel - plain| = {err:.3e}")
        require(err < ATOL, f"shm_apply a={a} disagrees with its plain version")
        worst["shm"] = max(worst["shm"], err)
    return worst


def figures(ops, ref, probe, engine, gen, sweep_err, launches, launches_by_k):
    """Time each kernel, its plain version and (for fused_apply, at every
    width k the plan launches, through ``probe.fused_rows``) one
    torch.matmul on the main path's real ops, and work out the bounds:
    ``bound_ms`` for the route the kernel takes (the 3xTF32 Karatsuba
    product on the tensor cores for fused_apply, fp32 on CUDA cores for
    shm_apply), ``bound_fp32_ms`` for the 4-product fp32 form on CUDA
    cores. ``launches`` / ``launches_by_k``: the counts of the main path's
    run."""
    n, L = engine.n, engine.L
    _, shm_op = probe.main_path_ops(engine)
    state_bytes = 8 << n
    x = random_state(n, gen)
    out = []
    by_k = fused_by_k(ops, ref, probe, engine, x, "main path", launches_by_k)
    widest = dict(by_k[0], launches=launches["fused"], max_abs_err=max(
        [sweep_err["fused"]] + [row["max_abs_err"] for row in by_k]))
    del widest["k"], widest["path"]
    widest["by_k"] = [by_k_row(row) for row in by_k]
    out.append(widest)

    members = engine.backend.shm_members(shm_op)
    window = shm_op.local_bits
    err = max_err(ops.shm_apply(x.clone(), window, members, L),
                  ref.shm_apply_ref(x.clone(), window, members, L))
    require(err < ATOL,
            "shm_apply disagrees with its plain version on the main path's group")
    ms = probe.time_ms(lambda: ops.shm_apply(x, window, members, L))
    plain_ms = probe.time_ms(lambda: ref.shm_apply_ref(x, window, members, L), reps=3)
    nbytes = 2 * state_bytes + sum(op.numel() * 8 + v.numel() * 4 for _, _, op, v in members)
    nops = sum((8 << len(b)) if kind == "mat" else 6 for kind, b, _, _ in members) * (1 << n)
    kinds = [kind for kind, _, _, _ in members]
    out.append(entry("shm_apply", launches["shm"], max(err, sweep_err["shm"]), ms, plain_ms,
                     nbytes, nops, FP32_OPS_PER_S, nops, None,
                     f"a={len(window)} window={list(window)} members={len(members)} "
                     f"({kinds.count('mat')} mat, {kinds.count('diag')} diag) n={n}"))
    sweep = probe.shm_sweep(ops, window, members, L, x)
    log("  shm_apply sweep (members: 0 = a copy; place: the group's window or bits "
        "0..a-1): " + json.dumps([{k: r[k] for k in ("place", "members", "ms")} for r in sweep]))
    worst = hold_ops(ops, ref, engine, engine.backend.pass_of(), x, "main path")
    for k, key in zip(out, ("fused", "shm")):
        k["max_abs_err"] = max(k["max_abs_err"], worst[key])
    return out


def fused_by_k(ops, ref, probe, engine, x, what: str, launches_by_k: dict,
               skip=(), ps=None) -> list:
    """``fused_apply`` at each width k the plan of ``engine`` launches (not
    in ``skip``), on its first op of that width, with the operands of the
    pass ``ps`` (default: the engine's run over all its shards; ``x`` holds
    the pass's shards): against its plain version, timed beside the plain
    version and one torch.matmul, with its bounds."""
    n, L = x.numel().bit_length() - 1, engine.L

    def against_plain(u, vidx, bits):
        err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, L),
                      ref.fused_apply_ref(x.clone(), u, vidx, bits, L))
        require(err < ATOL, f"fused_apply disagrees with its plain version on the {what}'s "
                            f"k={len(bits)} op")
        return {"max_abs_err": err, "plain_ms": probe.time_ms(
            lambda: ref.fused_apply_ref(x, u, vidx, bits, L), reps=3),
            "nbytes": 2 * (8 << n) + u.numel() * 8 + vidx.numel() * 4}

    rows = []
    for r in probe.fused_rows(ops, engine, x, against_plain, skip=skip, ps=ps):
        k = r["k"]
        cmacs = (1 << k) * (1 << n)
        row = entry("fused_apply", launches_by_k.get(k, 0), r["max_abs_err"], r["ms"],
                    r["plain_ms"], r["nbytes"], TF32_PASSES * KARATSUBA_OPS * cmacs,
                    TF32_OPS_PER_S, 8 * cmacs, r["matmul_ms"],
                    f"{what}: k={k} bits={r['bits']} V={r['V']} n={n}")
        rows.append(dict(row, k=k, path=what))
    return rows


def by_k_row(row: dict) -> dict:
    return {key: row[key] for key in ("k", "path", "launches", "ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_fp32_ms", "max_abs_err")}


def hold_ops(ops, ref, eng, ps, x: torch.Tensor, what: str) -> dict:
    """Every kernel op of ``eng``'s program, launched as the pass ``ps``
    launches it (its shard count, operand tables and variant indices),
    against its plain version on the state ``x``. Returns the worst error
    by kernel."""
    be, L = eng.backend, eng.L
    worst, count = {"fused": 0.0, "shm": 0.0}, {"fused": 0, "shm": 0}
    for prog in eng.cc.programs:
        for op in prog.ops:
            if op.kind == "fused":
                u, vidx, bits = ps.consts[op.uid], be.kernel_vidx(op, ps), op.local_bits
                err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, L),
                              ref.fused_apply_ref(x.clone(), u, vidx, bits, L))
            elif op.kind == "shm":
                members = be.shm_members(op, ps)
                err = max_err(ops.shm_apply(x.clone(), op.local_bits, members, L),
                              ref.shm_apply_ref(x.clone(), op.local_bits, members, L))
            else:
                continue
            sync(x.device.type)
            require(err < ATOL, f"{what}: {op.kind} op {op.uid} (bits {list(op.local_bits)}) "
                                "disagrees with its plain version")
            worst[op.kind] = max(worst[op.kind], err)
            count[op.kind] += 1
    log(f"  {what}: every kernel op against its plain version at {x.numel() >> L} shards of "
        f"2^{L}: {count['fused']} fused_apply (max err {worst['fused']:.3e}), "
        f"{count['shm']} shm_apply (max err {worst['shm']:.3e})")
    return worst


def hold_sweep_ops(ops, ref, eng, ps, seed: int, what: str) -> dict:
    """Every kernel op of a sweep, launched once over all P points' shards
    with the stacked tables (the sweep's own launch, past int32 indices),
    against the same kernel launched on each point's row alone with its
    slice of the variant index; the row launches of points 0 and P-1
    against the plain version. The plain versions' temporaries would not
    fit beside the whole sweep's state. Returns the worst error by kernel
    against the plain version."""
    be, L, n, P, S = eng.backend, eng.L, eng.n, ps.rows, eng.backend.S
    device = eng.device

    def row_state(p: int) -> torch.Tensor:
        g = torch.Generator(device=device).manual_seed(seed + p)
        return torch.randn(1 << n, dtype=torch.complex64, device=device, generator=g)

    x = torch.empty(P << n, dtype=torch.complex64, device=device)
    rows = x.view(P, -1)
    worst_row, worst = 0.0, {"fused": 0.0, "shm": 0.0}
    count = {"fused": 0, "shm": 0}
    for prog in eng.cc.programs:
        for op in prog.ops:
            if op.kind == "fused":
                u, vidx, bits = ps.consts[op.uid], be.kernel_vidx(op, ps), op.local_bits

                def launch(st, p=None):
                    v = vidx if p is None else vidx[p * S:(p + 1) * S]
                    return ops.fused_apply(st, u, v, bits, L)

                def plain(st, p):
                    return ref.fused_apply_ref(st, u, vidx[p * S:(p + 1) * S], bits, L)
            elif op.kind == "shm":
                members, window = be.shm_members(op, ps), op.local_bits

                def row_members(p):
                    return [(kind, b, t, v[p * S:(p + 1) * S]) for kind, b, t, v in members]

                def launch(st, p=None):
                    return ops.shm_apply(st, window, members if p is None else row_members(p), L)

                def plain(st, p):
                    return ref.shm_apply_ref(st, window, row_members(p), L)
            else:
                continue
            for p in range(P):
                rows[p] = row_state(p)
            launch(x)
            for p in range(P):
                alone = launch(row_state(p), p)
                err = max_err(rows[p], alone)
                require(err < ATOL, f"{what}: {op.kind} op {op.uid}: the sweep's launch and "
                                    f"the launch on row {p} alone disagree")
                worst_row = max(worst_row, err)
                if p in (0, P - 1):
                    err = max_err(alone, plain(row_state(p), p))
                    require(err < ATOL, f"{what}: {op.kind} op {op.uid} on row {p} disagrees "
                                        "with its plain version")
                    worst[op.kind] = max(worst[op.kind], err)
                del alone
            sync(device.type)
            count[op.kind] += 1
    del x, rows
    log(f"  {what}: every kernel op launched over all {P * S} shards of 2^{L} against the "
        f"launch on each row alone ({count['fused']} fused_apply, {count['shm']} shm_apply; "
        f"max |sweep - row| = {worst_row:.3e}); rows 0 and {P - 1} against the plain versions: "
        f"max err fused {worst['fused']:.3e}, shm {worst['shm']:.3e}")
    return worst


def entry(name, launches, err, ms, plain_ms, nbytes, nops, ops_per_s, fp32_ops, library_ms,
          shape):
    """One kernel's figures: ``bound_ms`` counts ``nops`` at ``ops_per_s``
    (the kernel's route), ``bound_fp32_ms`` the product's ``fp32_ops`` on
    CUDA cores; both against the bytes at the memory rate."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    bound_fp32 = max(t_bytes, fp32_ops / FP32_OPS_PER_S * 1e3)
    log(f"  {name} [{shape}]: {ms:.3f} ms (plain {plain_ms:.3f} ms"
        + (f", torch.matmul {library_ms:.3f} ms" if library_ms is not None else "")
        + f"); bound {max(t_bytes, t_ops):.3f} ms ({nbytes / 1e9:.2f} GB, "
        f"{nops / 1e12:.3f} TFLOP at {ops_per_s / 1e12:.0f} TFLOP/s), fp32 bound "
        f"{bound_fp32:.3f} ms")
    return {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_fp32_ms": bound_fp32, "library_ms": library_ms, "shape": shape}


def trace_run(run, untraced_s: float, what: str = "run_packed") -> dict:
    """One more call of ``run`` under torch.profiler: device time by kernel,
    against the untraced call's wall time (the profiled wall time includes
    the profiler's own start-up). Returns ``{"device_ms", "kernels"}``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():  # device-side events only: no double count
        dev_us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and str(ev.device_type).endswith("CUDA"):
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"  traced {what}: device time {busy_ms:.1f} ms = {busy_ms / (untraced_s * 1e3):.0%}"
        f" of the untraced run's {untraced_s * 1e3:.1f} ms (profiled wall {wall_ms:.1f} ms) in "
        f"{sum(r[1] for r in rows)} kernels; by kernel:")
    for ms, count, key in rows[:10]:
        log(f"    {ms:9.2f} ms  x{count:<3d} {key[:100]}")
    return {"device_ms": busy_ms, "kernels": sum(r[1] for r in rows)}


def shard_fingerprint(shard: torch.Tensor, stride: int) -> dict:
    """Every ``stride``-th amplitude of a shard (on the host) and a checksum
    of all its bits: the plain and the position-weighted sums of its 32-bit
    words, in int64 (wrapping), summed on the card in chunks."""
    words = torch.view_as_real(shard.reshape(-1)).view(torch.int32).view(-1)
    plain = weighted = 0
    chunk = 1 << 26
    for lo in range(0, words.numel(), chunk):
        w = words[lo:lo + chunk].to(torch.int64)
        pos = torch.arange(lo, lo + w.numel(), device=w.device, dtype=torch.int64) % 65521 + 1
        plain += int(w.sum())
        weighted += int((w * pos).sum())
    return {"sample": shard.reshape(-1)[::stride].cpu().numpy(), "checksum": (plain, weighted)}


def shardmap_rank(rank: int, circuit, plan, spec: dict, device: str = "cuda") -> dict:
    """One rank of the shardmap phase (a spawned process, in a gloo group
    with the others): ``ShardMapExecutor`` with the hand kernels on its
    2^L shard on the card, a cold and a warm ``run_packed`` (kernel
    launches, collectives and each remap's bytes and seconds, peak device
    memory), its shard's fingerprint, the measurement through
    ``ShardedMeasurer``, and on the first and last rank every kernel op of
    the plan against its plain version at the rank's shard and variants.
    ``device="cpu"`` dry-runs it on the host (no memory figures)."""
    import torch.distributed as dist
    from repro_torch.kernels import ops, ref
    from repro_torch.sim import collective
    from repro_torch.sim.measure import measurer_for
    from repro_torch.sim.shardmap_executor import ShardMapExecutor

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    t0 = time.time()
    ex = ShardMapExecutor(circuit, plan, device=device)
    out = {"build_s": time.time() - t0, "runs": []}
    shard = None
    for _ in range(2):  # cold (step tables, index tensors), then warm
        shard = None
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_kernel_counters()
        collective.reset_collective_counters()
        dist.barrier()
        t0 = time.perf_counter()
        shard = ex.run_packed()
        sync(device)
        dist.barrier()
        out["runs"].append({"seconds": time.perf_counter() - t0,
                            "launches": ops.kernel_call_counts(),
                            "by_k": ops.fused_call_counts_by_k(),
                            "collectives": collective.collective_counts(),
                            "trace": list(ex.backend.trace),
                            "peak": torch.cuda.max_memory_allocated() if cuda else 0})
    out["fingerprint"] = shard_fingerprint(shard, spec["stride"])
    m = measurer_for(shard, ex.measurement_frame, ex.engine)
    t0 = time.perf_counter()
    out["marginal"] = m.marginal(spec["marginal"])
    collective.reset_collective_counters()
    out["value"] = m.expectation(spec["observable"])
    out["expect_traffic"] = collective.collective_counts()
    out["marginal_expect_s"] = time.perf_counter() - t0
    out["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
    del m, shard
    if cuda:
        torch.cuda.empty_cache()
    out["worst"] = None
    if rank in (0, dist.get_world_size() - 1):
        gen = torch.Generator(device=device).manual_seed(17 + rank)
        x = torch.randn(1 << plan.L, dtype=torch.complex64, device=device, generator=gen)
        out["worst"] = hold_ops(ops, ref, ex.engine, ex.backend.pass_of(), x,
                                f"rank {rank}'s kernel ops")
        del x
    del ex
    if cuda:
        torch.cuda.empty_cache()
    out["grad"] = grad_sample_rank(rank, spec["grad"], device)
    return out


def grad_sample_rank(rank: int, spec: dict, device: str) -> dict:
    """One rank's sharded ``value_and_grad`` of ``isingparam(spec["n"])`` at
    L=``spec["L"]``, R=2 (``ShardedAdjointProgram``), and on the first and
    last rank a sample of its reverse sweep's ``fused_apply`` launches as
    the sweep makes them (the rank's blocks at its variant, its local bits,
    one shard): the first ``U†`` and ``∂U`` of each width and kind of gate
    (a gate all on device bits is a scalar on bit 0) and each local Pauli
    op of λ, against the plain version."""
    import torch.distributed as dist
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.core.partition import partition
    from repro_torch.kernels import ops, ref
    from repro_torch.sim.engine import ExecutionEngine

    sym = PARAM_FAMILIES["isingparam"](spec["n"])
    L = spec["L"]
    eng = ExecutionEngine(sym, partition(sym, L, 2, 0), device=device, backend="shardmap")
    theta = np.random.default_rng(spec["seed"]).uniform(0.0, 2 * np.pi, len(sym.param_names))
    obs = spec["obs"]
    dist.barrier()
    t0 = time.perf_counter()
    value, grads = eng.value_and_grad(obs, params=theta)
    out = {"value": value, "grads": grads, "seconds": time.perf_counter() - t0,
           "worst": None, "sampled": []}
    if rank not in (0, dist.get_world_size() - 1):
        return out
    prog = eng.adjoint_program(obs)
    inv, d = prog.tensors(eng.bound_circuit)
    sample, seen, ii, di = [], set(), 0, 0
    for walk, _ in reversed(prog._stages):
        for gid, _, _, bits, scalar in reversed(walk):
            slots = len(sym.gates[gid].param_slots)
            key = (len(bits), scalar, bool(slots))
            if key not in seen:
                seen.add(key)
                name = f"{sym.gates[gid].name}{sym.gates[gid].qubits}" + (" (scalar)" if scalar
                                                                          else "")
                sample.append((f"U† of {name}", inv[ii], bits))
                if slots:
                    sample.append((f"dU of {name}", d[di + slots - 1], bits))
            ii += 1
            di += slots
    for factor, mask, local in prog._terms:
        for b, u in local:
            sample.append((f"Pauli on bit {b}", u[0].cpu().numpy(), (b,)))
    gen = torch.Generator(device=device).manual_seed(29 + rank)
    x = torch.randn(1 << L, dtype=torch.complex64, device=device, generator=gen)
    vidx = torch.zeros(1, dtype=torch.int32, device=device)
    worst = 0.0
    for label, mat, bits in sample:
        u = torch.from_numpy(np.ascontiguousarray(mat, dtype=np.complex64)).to(device)
        u = u.reshape(1, *mat.shape)
        err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, L),
                      ref.fused_apply_ref(x.clone(), u, vidx, bits, L))
        require(err < ATOL, f"rank {rank}: the sweep's fused_apply on {label} disagrees with "
                            "its plain version")
        out["sampled"].append((label, len(bits), list(bits), err))
        worst = max(worst, err)
    out["worst"] = worst
    return out


def shardmap_phase(ops, card: str, circuit, plan, device: str = "cuda",
                   grad_n: int = SHARDMAP_VQE["sample_n"],
                   grad_L: int = SHARDMAP_VQE["sample_L"]) -> dict:
    """The explicit-collective backend at the main path's width: ``plan``
    (``ising(30)``, L=28, R=2) on ``CudaBackend`` first (launches, every
    shard's fingerprint, marginal and expectation through
    ``TorchMeasurer``), then on 4 spawned ranks of one gloo group through
    ``ShardMapExecutor`` (:func:`shardmap_rank`), held to it: launches per
    rank, each shard within SHARDMAP["atol"] (and whether bit for bit), the
    same values within the tolerance, and each remap's bytes
    against Eq. 2. Then on the same ranks a sharded ``value_and_grad`` of
    ``isingparam(grad_n)`` at L=``grad_L`` (:func:`grad_sample_rank`): the
    same answer on every rank, and the sweep's sampled launches on the first
    and last rank against the plain version. ``device="cpu"`` dry-runs it
    on the host at a small plan (and a small ``grad_n``)."""
    from repro_torch.sim.engine import ExecutionEngine
    from repro_torch.sim.measure import PauliSum, measurer_for
    from repro_torch.sim.ranks import run_ranks

    spec, world, L = dict(SHARDMAP), SHARDMAP["ranks"], plan.L
    spec["grad"] = {"n": grad_n, "L": grad_L, "seed": SHARDMAP_VQE["sample_seed"],
                    "obs": f"{VQE_OBS} + 0.25*X{grad_n - 1} Y{grad_n - 2} - 0.3*Y1 X0"}
    require(1 << (plan.R + plan.G) == world, f"the plan needs {1 << (plan.R + plan.G)} ranks")
    shard_bytes = 8 << L
    eng = ExecutionEngine(circuit, plan, device=device)
    eng.run_packed()  # warm-up: step tables, index tensors
    sync(device)
    ops.reset_kernel_counters()
    t0 = time.perf_counter()
    state = eng.run_packed()
    sync(device)
    cuda_s = time.perf_counter() - t0
    want = launches_match(ops, eng, "CudaBackend run of the plan")
    frame = eng.measurement_frame
    on_device = [frame.layout[p] for p in range(L, frame.n)]
    terms = PauliSum.parse(spec["observable"]).terms
    if not any(p in "XY" and frame.phys_of[q] >= L for t in terms for q, p in t.ops):
        spec["observable"] += f" + 0.25*X{on_device[0]}"  # so a term needs the permute
    log(f"  qubits on device bits (physical {L}..{frame.n - 1}): {on_device}; observable "
        f"{spec['observable']}")
    fps = [shard_fingerprint(state[d << L:(d + 1) << L], spec["stride"]) for d in range(world)]
    tm = measurer_for(state, frame)
    t0 = time.perf_counter()
    marg = tm.marginal(spec["marginal"])
    value = tm.expectation(spec["observable"])
    torch_measure_s = time.perf_counter() - t0
    del state, tm, eng
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.time()
    found = run_ranks(shardmap_rank, world, RENDEZVOUS_DIR, args=(circuit, plan, spec, device),
                      timeout=spec["timeout"], init_timeout=300,
                      threads=None if device == "cuda" else 1)
    wall_s = time.time() - t0
    warm = [f["runs"][1] for f in found]
    log(f"  {world} ranks (gloo; the exchanges hand gloo the CUDA shards): spawned, built "
        f"and run in {wall_s:.1f} s; engine build "
        + ", ".join(f"{f['build_s']:.2f}" for f in found) + " s")
    log(f"  run_packed: cold {max(f['runs'][0]['seconds'] for f in found):.3f} s, warm "
        f"{max(w['seconds'] for w in warm):.3f} s, against CudaBackend {cuda_s:.3f} s ({card})")
    for i, t in enumerate(warm[0]["trace"]):
        a2a = shard_bytes - (shard_bytes >> t["m"]) if t["m"] else 0
        sent = [w["trace"][i]["bytes_sent"] for w in warm]
        secs = [w["trace"][i]["seconds"] for w in warm]
        log(f"  remap {t['slot']}: m={t['m']}, permute {t['permute']}; bytes sent per rank "
            f"{sent} (Eq. 2: {a2a} in the all-to-all + at most {shard_bytes if t['permute'] else 0}"
            f" in the permute); seconds "
            + ", ".join(f"{s:.3f}" for s in secs))
        require(all(a2a <= b <= a2a + (shard_bytes if t["permute"] else 0) for b in sent),
                f"remap {t['slot']}: bytes sent {sent} break Eq. 2")
    for d, w in enumerate(warm):
        require({k: w["launches"][k] for k in ("fused", "shm")}
                == {k: want[k] for k in ("fused", "shm")} and w["by_k"] == want["by_k"],
                f"rank {d}: launches {w['launches']} {w['by_k']} != CudaBackend's {want}")
    log(f"  launches per rank: {warm[0]['launches']}, fused by k {warm[0]['by_k']} "
        f"(CudaBackend's: {want}); collectives per rank: "
        + "; ".join(str({k: v for k, v in w['collectives'].items() if v}) for w in warm))
    log("  peak device memory per rank: run " + ", ".join(gib(w["peak"]) for w in warm)
        + "; with the measurement " + ", ".join(gib(f["peak"]) for f in found))
    if device == "cuda":  # a rank holds its shard and one remap buffer
        require(all(w["peak"] <= 2 * shard_bytes + (1 << 30) for w in warm),
                "a rank held more than two shards during the run")
    errs, bitwise = [], []
    for d, f in enumerate(found):
        errs.append(float(np.abs(f["fingerprint"]["sample"] - fps[d]["sample"]).max()))
        bitwise.append(bool(np.array_equal(f["fingerprint"]["sample"], fps[d]["sample"])
                            and f["fingerprint"]["checksum"] == fps[d]["checksum"]))
    log(f"  shards against CudaBackend's: max |d| " + ", ".join(f"{e:.3e}" for e in errs)
        + f"; bit for bit {bitwise}")
    require(max(errs) <= spec["atol"], f"a shard differs by {max(errs)} > {spec['atol']}")
    for d, f in enumerate(found):
        require(np.array_equal(f["marginal"], found[0]["marginal"])
                and f["value"] == found[0]["value"], f"rank {d} measured otherwise than rank 0")
    marg_err = float(np.abs(found[0]["marginal"] - marg).max())
    value_err = abs(found[0]["value"] - value)
    log(f"  ShardedMeasurer: marginal {spec['marginal']} max |d| {marg_err:.3e}; "
        f"<{spec['observable']}> = {found[0]['value']:.9f} (TorchMeasurer {value:.9f}, |d| "
        f"{value_err:.3e}); marginal and expectation "
        f"{max(f['marginal_expect_s'] for f in found):.3f} s (TorchMeasurer both "
        f"{torch_measure_s:.3f} s); the expectation's permutes per rank "
        f"{[f['expect_traffic']['permute'] for f in found]}")
    require(marg_err <= spec["atol"] and value_err <= spec["atol"],
            "ShardedMeasurer's marginal or expectation differs from TorchMeasurer's")
    require(all(f["expect_traffic"]["permute"] >= 1 for f in found),
            "the X term on a device bit must permute shards")
    grads = [f["grad"] for f in found]
    for d, g in enumerate(grads):
        require(g["value"] == grads[0]["value"] and np.array_equal(g["grads"], grads[0]["grads"])
                and np.isfinite(g["value"]), f"rank {d}'s sharded value_and_grad differs")
    for d in (0, world - 1):
        log(f"  rank {d}: the sweep's launches of isingparam({grad_n}) L={grad_L} against the "
            "plain version: " + "; ".join(f"{label} k={k} bits {bits} {err:.3e}"
                                         for label, k, bits, err in grads[d]["sampled"]))
    log(f"  isingparam({grad_n}) L={grad_L} value_and_grad on {world} ranks: "
        f"{max(g['seconds'] for g in grads):.3f} s (slowest rank), value "
        f"{grads[0]['value']:+.9f}, gradient {grads[0]['grads']} ({card})")
    worst = {k: max(f["worst"][k] for f in found if f["worst"] is not None)
             for k in ("fused", "shm")}
    worst["fused"] = max([worst["fused"]] + [g["worst"] for g in grads if g["worst"] is not None])
    launches = {k: sum(w["launches"][k] for w in warm) for k in ("fused", "shm")}
    by_k = {k: world * c for k, c in want["by_k"].items()}
    return {"launches": dict(launches, by_k=by_k), "worst": worst, "wall_s": wall_s}


def shardmap_nccl_phase(ops, card: str, n: int, L: int, backend: str = "nccl",
                        device: str = "cuda") -> dict:
    """World size 1 over NCCL, in this process: ``qft(n)`` at L=n (R=G=0,
    so no collective runs) through ``ShardMapExecutor`` against
    ``CudaBackend`` on the same plan, bit for bit, one launch per op
    (``backend="gloo", device="cpu"`` dry-runs it on the host)."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.core.generators import FAMILIES
    from repro_torch.core.partition import partition
    from repro_torch.sim import collective
    from repro_torch.sim.engine import ExecutionEngine
    from repro_torch.sim.shardmap_executor import ShardMapExecutor

    circ = FAMILIES["qft"](n)
    plan = partition(circ, L, 0, 0)
    eng = ExecutionEngine(circ, plan, device=device)
    eng.run()
    want = eng.run()
    sync(device)
    os.makedirs(RENDEZVOUS_DIR, exist_ok=True)
    rendezvous = os.path.join(RENDEZVOUS_DIR, f"nccl-{os.getpid()}")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=0, world_size=1,
                            timeout=timedelta(seconds=300))
    try:
        ex = ShardMapExecutor(circ, plan, device=device)
        ex.run()
        sync(device)
        ops.reset_kernel_counters()
        collective.reset_collective_counters()
        t0 = time.perf_counter()
        got = ex.run()
        sync(device)
        secs = time.perf_counter() - t0
        launches = launches_match(ops, ex.engine, "shardmap over NCCL, world size 1",
                                  kinds=("shm",))
        moved = {k: v for k, v in collective.collective_counts().items() if v}
        bitwise = bool(torch.equal(got, want))
        log(f"  qft({n}) L={L}: backend {dist.get_backend()}, world size "
            f"{dist.get_world_size()}; run {secs:.4f} s; collectives {moved or 'none'}; bit for "
            f"bit CudaBackend's: {bitwise} ({card})")
        require(bitwise, "the NCCL world-size-1 run differs from CudaBackend's")
        require(not moved, f"world size 1 ran collectives: {moved}")
    finally:
        dist.destroy_process_group()
    return {"launches": launches}


def session_run(cmd: list, timeout: float, what: str) -> tuple:
    """``python cmd`` (with ``src`` on its path) in its own session: on a
    timeout the whole group, the process and any it started, is killed and
    this raises. ``(stdout, stderr, exit code, seconds)``."""
    import signal

    cmd = [sys.executable, *cmd]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    log("  " + " ".join(cmd[1:]))
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise RuntimeError(f"{what} overran {timeout} s:\n{out[-3000:]}\n{err[-3000:]}")
    return out, err, proc.returncode, time.time() - t0


def torchrun_launch(nproc: int, target: list, timeout: float) -> tuple:
    """``python -m torch.distributed.run --standalone --nproc-per-node nproc
    target`` (:func:`session_run`): ``(stdout, seconds)``; raises unless
    every rank exited 0."""
    out, err, rc, seconds = session_run(
        ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(nproc),
         *target], timeout, "torchrun")
    require(rc == 0, f"torchrun exited {rc}:\n{out[-3000:]}\n{err[-5000:]}")
    return out, seconds


def shardmap_cli_rank(spec_path: str) -> None:
    """Under torchrun, each rank of ``shardmap_cli_phases``: it joins the
    gloo group and calls ``repro_torch.launch.simulate``'s entry point in
    this process once for each argv of ``spec["gloo"]`` (the CLI uses the
    group it finds), the device's peak reset before each run so each run's
    ranks report their own; then it leaves the group, and rank 0 alone
    runs ``spec["solo"]`` at world size 1: the CLI joins a group of its own
    from a launcher's environment of one rank on a fresh port, as under
    ``torchrun --nproc-per-node 1``. Rank 0 writes what each run printed,
    and its seconds, to ``spec["out"]``."""
    import contextlib
    import io
    import socket

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.launch import dist as launch_dist
    from repro_torch.launch import simulate

    with open(spec_path) as f:
        spec = json.load(f)
    device = spec["device"]
    printed = []

    def call(argv):
        _fresh(device)
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            simulate.main(argv)
        printed.append({"out": buf.getvalue(), "seconds": time.time() - t0})
        gc.collect()

    ctx = launch_dist.join("gloo", device)
    rank = ctx.rank
    for argv in spec["gloo"]:
        call(argv)
    ctx.close()
    if rank != 0:
        return
    if spec["solo"]:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                          MASTER_PORT=str(port))
        os.environ.pop("TORCHELASTIC_USE_AGENT_STORE", None)  # rank 0 hosts its store
        call(spec["solo"])
    with open(spec["out"], "w") as f:
        json.dump(printed, f)


def torchrun_cli_runs(world: int, gloo: list, solo: list, timeout: float,
                      device: str = "cuda") -> tuple:
    """One ``torchrun_launch`` of ``chip_smoke.py --shardmap-cli-check`` on
    ``world`` ranks (:func:`shardmap_cli_rank`): each argv of ``gloo`` on
    every rank, then ``solo`` (None: nothing) at world size 1, each with
    ``--result-json`` (and ``--device cpu`` on the CPU). Returns ``([(what
    rank 0 printed, the JSON it wrote, the run's seconds), ...], the
    launch's seconds)``, the runs in that order; raises unless every rank
    exited 0. The argvs spell ``--n`` as ``--qubits``: the card's Python
    takes ``--n`` after the script name for an abbreviation of torchrun's
    options."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    tag = f"cli-{os.getpid()}-{time.time_ns()}"
    argvs = gloo + ([solo] if solo else [])
    docs = [os.path.join(RESULTS_DIR, f"{tag}-{i}.json") for i in range(len(argvs))]
    extra = ["--device", "cpu"] if device == "cpu" else []
    argvs = [list(a) + ["--result-json", d] + extra for a, d in zip(argvs, docs)]
    spec_path = os.path.join(RESULTS_DIR, f"{tag}.json")
    out_path = os.path.join(RESULTS_DIR, f"{tag}-out.json")
    with open(spec_path, "w") as f:
        json.dump({"device": device, "gloo": argvs[:len(gloo)],
                   "solo": argvs[len(gloo)] if solo else None, "out": out_path}, f)
    _, seconds = torchrun_launch(world, [os.path.join(HERE, "chip_smoke.py"),
                                         "--shardmap-cli-check", spec_path], timeout)
    with open(out_path) as f:
        printed = json.load(f)
    require(len(printed) == len(docs), f"rank 0 finished {len(printed)} of {len(docs)} runs")
    runs = []
    for p, path in zip(printed, docs):
        with open(path) as f:
            runs.append((p["out"], json.load(f), p["seconds"]))
    for path in docs + [spec_path, out_path]:
        os.remove(path)
    return runs, seconds


def cli_launches(doc: dict, what: str) -> dict:
    """Each rank's launches (the CLI's ``--result-json``) equal the compiled
    program's ops, both kernels ran on every rank and the fused ones match
    the plan's widths; summed over the ranks."""
    counts = doc["op_counts"]
    for d, c in enumerate(doc["launches"]):
        require((c["fused"], c["shm"]) == (counts.get("fused", 0), counts.get("shm", 0))
                and c["fused"] > 0 and c["shm"] > 0,
                f"{what}: rank {d} launched {c}, the compiled program is {counts}")
    by_k: dict = {}
    for c in doc["launches"]:
        for k, v in c["by_k"].items():
            by_k[int(k)] = by_k.get(int(k), 0) + v
    return {"fused": sum(c["fused"] for c in doc["launches"]),
            "shm": sum(c["shm"] for c in doc["launches"]), "by_k": by_k}


def shardmap_cli_phases(ops, ref, probe, card: str, circuit, plan, device: str = "cuda",
                        observable: str = SHARDMAP_CLI["observable"],
                        nccl_n: int = SHARDMAP_CLI_NCCL["n"], vqe_n: int = SHARDMAP_VQE["n"],
                        vqe_L: int = SHARDMAP_VQE["L"]) -> dict:
    """The CLI under ``torchrun``: one launch of 4 gloo ranks of the one card
    (:func:`torchrun_cli_runs`) whose ranks call the CLI's entry point in
    process, twice (the launch's fixed cost, 20-26 s on the card's host,
    paid once), then once more on rank 0 alone at world size 1:

    * ``SHARDMAP_CLI_PATH``, the main path's plan (``ising(30)``, L=28, R=2),
      held by :func:`_hold_cli` to the in-card plan and ``TorchMeasurer``;
    * ``SHARDMAP_VQE_PATH`` (``isingparam(vqe_n)`` at ``vqe_L``, R=2, one
      Adam step), held by :func:`_hold_cli_vqe` to one ``CudaBackend``
      ``value_and_grad`` of the same plan;
    * ``SHARDMAP_CLI_NCCL_PATH`` at world size 1 over NCCL
      (``isingparam(nccl_n)``, no collective runs), held by
      :func:`_hold_cli_nccl` to a ``CudaBackend`` engine bit for bit.

    Each target is computed in this process first, and the card's memory
    freed for the ranks. Returns each run's figures (``"cli"``, ``"vqe"``,
    ``"nccl"``) and the launch's seconds. ``device="cpu"`` dry-runs it on
    the host at a small plan of ``ising`` with R=2 (n and L taken from the
    plan; ``observable`` on its qubits), ``nccl_n`` and ``vqe_n``/``vqe_L``
    (gloo at world size 1)."""
    cli = _cli_target(circuit, plan, device, observable)
    nccl = _cli_nccl_target(device, nccl_n)
    vqe = _cli_vqe_target(device, vqe_n, vqe_L)
    if device == "cuda":
        torch.cuda.empty_cache()  # the ranks need the card's memory
    world = SHARDMAP_CLI["ranks"]
    runs, seconds = torchrun_cli_runs(world, [cli["argv"], vqe["argv"]], nccl["argv"],
                                      SHARDMAP_CLI["timeout"], device)
    log(f"  one torchrun launch, {world} gloo ranks calling the CLI in process twice, then "
        f"world size 1: {seconds:.1f} s launch to exit ({card})")
    return {"cli": _hold_cli(card, cli, *runs[0], device),
            "vqe": _hold_cli_vqe(ops, ref, probe, card, vqe, *runs[1], device),
            "nccl": _hold_cli_nccl(card, nccl, *runs[2], device), "seconds": seconds}


def _cli_target(circuit, plan, device: str, observable: str) -> dict:
    """The main path's plan run in this process: its op counts, and the
    marginal and expectation ``TorchMeasurer`` gives on the in-card state;
    the CLI's argv for the same plan."""
    from repro_torch.sim.engine import ExecutionEngine
    from repro_torch.sim.measure import measurer_for

    spec = SHARDMAP_CLI
    eng = ExecutionEngine(circuit, plan, device=device)
    counts = eng.op_counts()
    state = eng.run_packed()
    tm = measurer_for(state, eng.measurement_frame)
    marg = tm.marginal(spec["marginal"])
    value = tm.expectation(observable)
    del tm, state, eng
    gc.collect()
    argv = list(SHARDMAP_CLI_PATH)
    argv[argv.index("--qubits") + 1] = str(circuit.n_qubits)
    argv[argv.index("--L") + 1] = str(plan.L)
    argv[argv.index("--observable") + 1] = observable
    return {"argv": argv, "counts": counts, "marg": marg, "value": value, "L": plan.L}


def _hold_cli(card: str, t: dict, out: str, doc: dict, seconds: float, device: str) -> dict:
    """``SHARDMAP_CLI_PATH`` on 4 gloo ranks against its target: the printed
    program to the in-card plan's op counts; each rank's launches to them;
    one printed line per remap, each m=2 remap sending Eq. 2's bytes on
    every rank; each rank's peak device memory to two shards and 1 GiB; the
    marginal and the expectation to ``TorchMeasurer``'s on the in-card
    state within SHARDMAP_CLI["atol"]."""
    spec, world, L, counts = SHARDMAP_CLI, SHARDMAP_CLI["ranks"], t["L"], t["counts"]
    printed = [ln for ln in out.splitlines() if "program:" in ln]
    want_program = ", ".join(f"{v} {k}" for k, v in sorted(counts.items()))
    require(len(printed) == 1 and printed[0].endswith("program: " + want_program)
            and doc["op_counts"] == counts,
            f"the CLI's program {printed} {doc['op_counts']} is not the in-card plan's {counts}")
    launches = cli_launches(doc, "shardmap CLI")
    shard_bytes = 8 << L
    lines = [ln for ln in out.splitlines() if ln.startswith("  remap ")]
    require(len(lines) == len(doc["remaps"]) and doc["remaps"],
            f"one printed line per remap: {lines} against {doc['remaps']}")
    for r, line in zip(doc["remaps"], lines):
        a2a = shard_bytes - (shard_bytes >> r["m"]) if r["m"] else 0
        perm = shard_bytes if r["permute"] else 0
        sent = [int(b) for b in line.split("bytes sent per rank [")[1].split("]")[0].split(",")]
        require(sent == r["bytes_sent"] and len(sent) == world
                and all(a2a <= b <= a2a + perm for b in sent),
                f"remap {r['slot']}: bytes sent {sent} break Eq. 2 ({a2a} + at most {perm})")
        require(r["m"] != 2 or r["permute"] or all(b == a2a for b in sent),
                f"remap {r['slot']}: an m=2 remap sends {a2a} bytes a rank, not {sent}")
    res = doc["results"][0]
    got_marg = np.asarray(res["marginals"][",".join(map(str, spec["marginal"]))])
    (key, got_value), = res["expectations"].items()
    marg_err = float(np.abs(got_marg - t["marg"]).max())
    value_err = abs(got_value - t["value"])
    log(f"  {world} ranks through the CLI in {seconds:.1f} s (imports done; planning, build, "
        f"run, measurement); run_packed {doc['seconds']:.3f} s; {want_program}; launches per "
        f"rank {doc['launches'][0]}")
    for line in lines:
        log("  " + line.strip())
    log("  peak device memory per rank to the end of the run: "
        + ", ".join(gib(p) for p in doc["peaks"]) + f" ({card})")
    if device == "cuda":  # a rank holds its shard and one remap buffer
        require(all(p <= 2 * shard_bytes + (1 << 30) for p in doc["peaks"]),
                "a rank held more than two shards during the CLI's run")
    log(f"  marginal {spec['marginal']} max |d| {marg_err:.3e}; <{key}> = {got_value:.9f} "
        f"(TorchMeasurer on the in-card state {t['value']:.9f}, |d| {value_err:.3e}) ({card})")
    require(marg_err <= spec["atol"] and value_err <= spec["atol"],
            "the CLI's marginal or expectation differs from TorchMeasurer's on the in-card state")
    return {"launches": launches, "seconds": seconds}


def _cli_nccl_target(device: str, n: int) -> dict:
    """``isingparam(n)`` at L=n bound to SHARDMAP_CLI_NCCL["bind"] on a
    ``CudaBackend`` engine in this process: its op counts and marginal; the
    CLI's argv for it."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.measure import measurer_for

    spec = SHARDMAP_CLI_NCCL
    argv = list(SHARDMAP_CLI_NCCL_PATH)
    argv[argv.index("--qubits") + 1] = argv[argv.index("--L") + 1] = str(n)
    eng = engine_for(PARAM_FAMILIES["isingparam"](n), n, 0, 0, device=device, cache=None)
    eng.bind(spec["bind"])
    marg = measurer_for(eng.run_packed(), eng.measurement_frame).marginal(spec["marginal"])
    counts = eng.op_counts()
    del eng
    gc.collect()
    return {"argv": argv, "counts": counts, "marg": marg}


def _hold_cli_nccl(card: str, t: dict, out: str, doc: dict, seconds: float,
                   device: str) -> dict:
    """``SHARDMAP_CLI_NCCL_PATH`` at world size 1 over NCCL (gloo on the CPU)
    against its target: the op counts, one launch per op, no remap, and the
    marginal bit for bit."""
    spec = SHARDMAP_CLI_NCCL
    backend = "nccl" if device == "cuda" else "gloo"
    require(f"torch.distributed {backend}, world size 1;" in out,
            f"the CLI did not run at world size 1 over {backend}:\n{out[-2000:]}")
    require(doc["op_counts"] == t["counts"],
            f"the CLI's program {doc['op_counts']} is not {t['counts']}")
    launches = cli_launches(doc, "shardmap CLI over NCCL")
    got = np.asarray(doc["results"][0]["marginals"][",".join(map(str, spec["marginal"]))])
    bitwise = bool(np.array_equal(got, t["marg"]))
    log(f"  world size 1 through the CLI in {seconds:.1f} s; run_packed {doc['seconds']:.4f} s; "
        f"launches {doc['launches'][0]}; remaps {len(doc['remaps'])}; marginal "
        f"{spec['marginal']} bit for bit CudaBackend's: {bitwise} ({card})")
    require(bitwise, "the NCCL world-size-1 CLI's marginal differs from CudaBackend's")
    require(not doc["remaps"], "world size 1 ran a remap")
    return {"launches": launches, "seconds": seconds}


def _cli_vqe_target(device: str, n: int, L: int) -> dict:
    """One ``CudaBackend`` ``value_and_grad`` of ``isingparam(n)``'s plan at
    L, R=2, at the first angles, with an observable that adds an X/Y term on
    the last stage's two device qubits; what the hold needs of the plan;
    the CLI's argv for it."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.engine import engine_for

    spec = SHARDMAP_VQE
    eng = engine_for(PARAM_FAMILIES["isingparam"](n), L, spec["R"], 0, device=device,
                     cache=None)
    dev = eng.cc.programs[-1].layout[L:]
    obs = f"{VQE_OBS} + 0.25*X{dev[1]} Y{dev[0]}"
    theta0 = np.random.default_rng(VQE_SEED).uniform(0.0, 2 * np.pi, 2).astype(np.float32)
    t = {"n": n, "L": L, "obs": obs, "counts": eng.op_counts(),
         "n_gates": len(eng.circuit.gates),
         "n_slots": sum(len(g.param_slots) for g in eng.circuit.gates)}
    sync(device)
    t0 = time.perf_counter()
    t["value"], t["grad"] = eng.value_and_grad(obs, params=theta0)
    sync(device)
    t["card_s"] = time.perf_counter() - t0
    t["k_gates"] = {}
    for g, bound in zip(eng.circuit.gates, eng.bound_circuit.gates):  # for the timings
        if g.param_slots:
            t["k_gates"].setdefault(len(g.qubits), bound)
    t["phys_of"] = {q: p for p, q in enumerate(eng.cc.programs[-1].layout)}
    del eng
    gc.collect()
    argv = list(SHARDMAP_VQE_PATH)
    argv[argv.index("--qubits") + 1] = str(n)
    argv[argv.index("--L") + 1] = str(L)
    t["argv"] = argv + ["--vqe", obs]
    return t


def _hold_cli_vqe(ops, ref, probe, card: str, t: dict, out: str, doc: dict, seconds: float,
                  device: str) -> dict:
    """``SHARDMAP_VQE_PATH`` on 4 gloo ranks against its target (rank 0's
    ``--result-json``): the first value and gradient; each rank's launches
    to the forward plan's ops plus the sweep's (two ``fused_apply`` per
    gate, one per slot and per local Pauli op); each rank's sweep bytes
    within its bound, and each inverse remap's to Eq. 2; each rank's peak
    within four shards and 1 GiB; one adjoint program built in two calls.
    Then ``fused_apply`` at k=1 and k=2 on one 2^L shard (the sweep's
    launches, padded), timed beside its plain version and one torch.matmul:
    the returned ``rows`` (for ``fused["by_k"]``)."""
    spec, world, n, L, counts = SHARDMAP_VQE, SHARDMAP_VQE["ranks"], t["n"], t["L"], t["counts"]
    require(doc["op_counts"] == counts,
            f"the CLI's program {doc['op_counts']} is not the in-card plan's {counts}")
    v0, g0 = doc["energies"][0], np.asarray(doc["first_grad"])
    want_v, want_g = t["value"], t["grad"]
    dv, dg = abs(v0 - want_v), float(np.abs(g0 - want_g).max())
    shard = 8 << L
    sweeps = doc["sweeps"]
    log(f"  {world} ranks through the CLI in {seconds:.1f} s (imports done; planning, build, "
        f"two value_and_grad calls); observable {t['obs']}; program {counts}")
    log(f"  first value {v0:+.9f} and gradient {g0} against CudaBackend's {want_v:+.9f} and "
        f"{want_g} ({t['card_s']:.3f} s): |d| {dv:.3e}, {dg:.3e}")
    require(dv <= spec["value_atol"] and dg <= spec["grad_atol"],
            "the sharded value_and_grad differs from CudaBackend's")
    log(f"  value_and_grad seconds {doc['grad_seconds']} (the first builds the adjoint "
        f"program) on {world} gloo ranks, against {t['card_s']:.3f} s on CudaBackend ({card})")
    for d, w in enumerate(sweeps):
        log(f"  rank {d}: forward {w['forward_s']:.3f} s, λ {w['lambda_s']:.3f} s, sweep kernels "
            f"{w['kernels_s']:.3f} s, sweep remaps {w['remaps_s']:.3f} s; sweep bytes sent "
            f"{w['bytes_sent']}, received {w['bytes_received']} (bound {w['bound']}); launches "
            f"{doc['launches'][d]}; peak {gib(doc['peaks'][d])}")
    for d, (c, w) in enumerate(zip(doc["launches"], sweeps)):
        want_f = counts.get("fused", 0) + 2 * t["n_gates"] + t["n_slots"] + w["pauli_launches"]
        require(c["fused"] == want_f and c["shm"] == counts.get("shm", 0)
                and sum(c["by_k"].values()) == c["fused"],
                f"rank {d} launched {c}: forward {counts} + sweep "
                f"{2 * t['n_gates'] + t['n_slots']} + {w['pauli_launches']} Pauli ops")
        require(0 < w["bytes_sent"] <= w["bound"] and w["bytes_received"] <= w["bound"],
                f"rank {d}: the sweep moved {w['bytes_sent']}/{w['bytes_received']} bytes, "
                f"bound {w['bound']}")
        if device == "cuda":  # ψ, λ, μ and one remap buffer
            require(doc["peaks"][d] <= 4 * shard + (1 << 30),
                    f"rank {d} held {gib(doc['peaks'][d])}, more than four shards and 1 GiB")
    undo = [r for r in doc["remaps"] if str(r["slot"]).startswith("undo ")]
    require(undo, "the sweep ran no inverse remap")
    for r in undo:
        a2a = shard - (shard >> r["m"]) if r["m"] else 0
        perm = shard if r["permute"] else 0
        log(f"  remap {r['slot']}: m={r['m']}, permute {r['permute']}; bytes sent per rank "
            f"{r['bytes_sent']}; {r['seconds']:.3f} s (slowest rank)")
        require(all(a2a <= b <= a2a + perm for b in r["bytes_sent"]),
                f"remap {r['slot']}: bytes sent {r['bytes_sent']} break Eq. 2")
    require(doc["adjoint_builds"] == 1 and len(doc["grad_seconds"]) == 2
            and "no adjoint program built" in out,
            "the second value_and_grad built an adjoint program")
    by_k: dict = {}
    for c in doc["launches"]:
        for k, v in c["by_k"].items():
            by_k[int(k)] = by_k.get(int(k), 0) + v
    launches = {"fused": sum(c["fused"] for c in doc["launches"]),
                "shm": sum(c["shm"] for c in doc["launches"]), "by_k": by_k}
    rows = []
    if device == "cuda":
        gen = torch.Generator(device="cuda").manual_seed(47)
        x = torch.randn(1 << L, dtype=torch.complex64, device="cuda", generator=gen)
        vidx = torch.zeros(1, dtype=torch.int32, device="cuda")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for k in (1, 2):
                g = t["k_gates"][k]
                bits = tuple(t["phys_of"][q] for q in g.qubits)
                if max(bits) >= L:
                    bits = tuple(range(k))
                u = torch.from_numpy(np.ascontiguousarray(g.inverse_matrix, dtype=np.complex64))
                u = u.to("cuda").reshape(1, 1 << k, 1 << k)
                err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, L),
                              ref.fused_apply_ref(x.clone(), u, vidx, bits, L))
                require(err < ATOL, f"fused_apply at k={k} on a 2^{L} shard disagrees with its "
                                    "plain version")
                ms = probe.time_ms(lambda: ops.fused_apply(x, u, vidx, bits, L))
                plain_ms = probe.time_ms(lambda: ref.fused_apply_ref(x, u, vidx, bits, L), reps=3)
                xt, ut = x.view(-1, 1 << k), u[0].transpose(0, 1).contiguous()
                matmul_ms = probe.time_ms(lambda: torch.matmul(xt, ut))
                cmacs = (1 << k) * (1 << L)
                what = f"shardmap sweep, 2^{L} shard of n={n}"
                row = entry("fused_apply", by_k.get(k, 0), err, ms, plain_ms,
                            2 * shard + u.numel() * 8 + 4, TF32_PASSES * KARATSUBA_OPS * cmacs,
                            TF32_OPS_PER_S, 8 * cmacs, matmul_ms,
                            f"{what}: k={k} bits={list(bits)} V=1 (padded to I x U on 4 bits)")
                rows.append(by_k_row(dict(row, k=k, path=what)))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del x
        torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows, "seconds": seconds,
            "grad_seconds": doc["grad_seconds"]}


def serve_shardmap_phase(card: str, device: str = "cuda", n: int = SERVE_SHARDMAP["n"],
                         L: int = SERVE_SHARDMAP["L"]) -> dict:
    """Serving on the shardmap backend, as a client of ``serve_sim
    --backend shardmap`` under ``torchrun`` on 4 gloo ranks of the one card
    (``SERVE_SHARDMAP``). The server starts first; while it starts, this
    process computes the answers: a ``CudaBackend`` engine of
    ``isingparam(n)`` (L, R=2) planned as the ranks plan it (its last
    stage's device qubit names the observable's X term), each binding run
    alone and measured with ``TorchMeasurer``, and ``ising(n)``'s ``amp0``.
    Then over the wire, all at once: 8 ``isingparam(n)`` requests (two
    batches of 4; one with 64 shots and the marginal (0, 1, 2)), 2 identical
    concrete ``ising(n)`` requests (one dedup run), then ``{"cmd":
    "stats"}``; then the session is ended and every rank must be gone.
    Held (:func:`_hold_serve_shardmap`): each expectation and marginal
    within ``atol`` of the run alone, the shots equal to ``TorchMeasurer``'s
    for the seed, ``amp0`` within ``atol``; from ``stats()["ranks"]``, on
    each rank and batch, the launches of both kernels equal to the plan's
    ops times the rows run (each kernel launched on every rank in the
    phase), each remap's bytes to Eq. 2 (and the batch's remap bytes to the
    rows times the last run's), no solver call, shm schedule or cache miss
    on the warm second batch, and peak device memory within
    ``SERVE_SHARDMAP_PEAK``. ``device="cpu"`` dry-runs it on the host at a
    small ``n`` and ``L``."""
    import signal
    import socket

    from repro_torch.sim.engine import DEFAULT_CACHE

    spec, world, R = SERVE_SHARDMAP, SERVE_SHARDMAP["ranks"], SERVE_SHARDMAP["R"]
    DEFAULT_CACHE.clear()  # the earlier phases' cached engines: the ranks need the memory
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.makedirs(RESULTS_DIR, exist_ok=True)
    logs = {k: os.path.join(RESULTS_DIR, f"serve-shardmap-{port}.{k}") for k in ("out", "err")}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(world), "-m", "repro_torch.launch.serve_sim", "--backend", "shardmap",
           "--dist-backend", "gloo", "--R", str(R), "--port", str(port), "--max-batch",
           str(spec["max_batch"]), "--max-wait-ms", str(spec["max_wait_ms"])]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    log("  " + " ".join(cmd[1:]))
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    with open(logs["out"], "w") as out_f, open(logs["err"], "w") as err_f:
        proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=out_f, stderr=err_f,
                                start_new_session=True)

    def ranks_alive() -> list:
        found = subprocess.run(["pgrep", "-f", f"serve_sim .*--port {port}"],
                               capture_output=True, text=True).stdout.split()
        return [int(p) for p in found]

    try:
        answers = _serve_shardmap_answers(spec, n, L, R, device)
        start_s = _wait_listening(proc, logs, t0, spec["start_timeout"])
        got, stats, served_s = _serve_shardmap_client(spec, n, port, answers)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGTERM)  # torchrun ends its ranks
        try:
            proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
        deadline = time.time() + 60
        while ranks_alive() and time.time() < deadline:
            time.sleep(1.0)
        left = ranks_alive()
        for pid in left:
            os.kill(pid, signal.SIGKILL)
    require(not left, f"ranks {left} outlived the server's session")
    log(f"  the runs alone on CudaBackend in {answers['alone_s']:.1f} s (isingparam({n}) "
        f"program {answers['counts']}, ising({n}) program {answers['icounts']}; observable "
        f"{answers['obs']}) while the server started; the server listening after {start_s:.1f} "
        f"s (torchrun, imports, the group); {len(got)} requests answered in {served_s:.1f} s; "
        "the session ended and every rank is gone")
    launches = _hold_serve_shardmap(card, device, spec, L, world, got, stats, answers)
    return {"launches": launches, "seconds": time.time() - t0}


def _serve_shardmap_answers(spec: dict, n: int, L: int, R: int, device: str) -> dict:
    """The shardmap serving phase's answers on one card: each binding run
    alone on ``CudaBackend`` and measured with ``TorchMeasurer``, and
    ``ising(n)``'s ``amp0``; the engines' programs and the observable."""
    from repro_torch.core.generators import FAMILIES, PARAM_FAMILIES
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.measure import measurer_for
    from repro_torch.sim.result import SimulationResult

    t0 = time.time()
    sym = PARAM_FAMILIES["isingparam"](n)
    eng = engine_for(sym, L, R, 0, device=device, cache=None)
    obs = f"Z0 Z1 + 0.5*X{eng.cc.programs[-1].layout[L]}"
    rng = np.random.default_rng(spec["seed"])
    points = [rng.uniform(-1.5, 1.5, len(sym.param_names)) for _ in range(spec["requests"])]
    want = []
    for i, p in enumerate(points):
        tm = measurer_for(eng.run_packed(params=dict(zip(eng.param_names, p))),
                          eng.measurement_frame)
        w = {"value": tm.expectation(obs)}
        if i == spec["shot_request"]:
            res = SimulationResult(n_qubits=n, backend="cuda", shots=spec["shots"], seed=i,
                                   samples=tm.sample(spec["shots"], seed=i))
            w.update(counts=res.counts(), marginal=tm.marginal(spec["marginal"]))
        want.append(w)
        del tm
    counts = eng.op_counts()
    del eng
    ieng = engine_for(FAMILIES["ising"](n), L, R, 0, device=device, cache=None)
    amp0 = complex(ieng.run().reshape(-1)[0].item())
    icounts = ieng.op_counts()
    del ieng
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()  # the ranks need the card's memory
    return {"points": points, "want": want, "amp0": amp0, "counts": counts, "icounts": icounts,
            "obs": obs, "alone_s": time.time() - t0}


def _wait_listening(proc, logs: dict, t0: float, timeout: float) -> float:
    """Seconds from ``t0`` until rank 0 prints that it listens; raises if
    the server exits or does not listen within ``timeout``."""
    def tail(path: str) -> str:
        with open(path) as f:
            return f.read()[-4000:]

    while True:
        with open(logs["out"]) as f:
            if "simulation service listening on" in f.read():
                return time.time() - t0
        require(proc.poll() is None,
                f"the server exited {proc.returncode}:\n{tail(logs['out'])}\n{tail(logs['err'])}")
        require(time.time() - t0 < timeout, f"the server did not listen within {timeout} s")
        time.sleep(0.5)


def _serve_shardmap_client(spec: dict, n: int, port: int, answers: dict) -> tuple:
    """The requests (``answers``' points and observable) over the wire, all
    at once, then ``stats``: ``(the responses by id, the stats snapshot,
    seconds to the last response)``."""
    import asyncio

    from repro_torch.core.generators import FAMILIES

    lines = []
    for i, p in enumerate(answers["points"]):
        d = {"id": i, "family": "isingparam", "n": n, "seed": i,
             "observables": [answers["obs"]], "params": [float(x) for x in p]}
        if i == spec["shot_request"]:
            d.update(shots=spec["shots"], marginals=[list(spec["marginal"])])
        lines.append(d)
    ising = FAMILIES["ising"](n).to_json()
    lines += [{"id": spec["requests"] + j, "circuit_json": ising} for j in range(spec["dedup"])]

    async def client():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        t0 = time.time()
        writer.write("".join(json.dumps(d) + "\n" for d in lines).encode())
        await writer.drain()
        got = {}
        while len(got) < len(lines):
            r = json.loads(await asyncio.wait_for(reader.readline(), spec["timeout"]))
            got[r["id"]] = r
        served_s = time.time() - t0
        writer.write(b'{"cmd": "stats"}\n')
        await writer.drain()
        stats = json.loads(await asyncio.wait_for(reader.readline(), 60))["stats"]
        writer.close()
        return got, stats, served_s

    return asyncio.run(client())


def _hold_serve_shardmap(card: str, device: str, spec: dict, L: int, world: int, got: dict,
                         stats: dict, answers: dict) -> dict:
    """:func:`serve_shardmap_phase`'s checks and lines; the launches summed
    over the ranks."""
    want, counts, icounts = answers["want"], answers["counts"], answers["icounts"]
    bad = {i: r for i, r in got.items() if not r["ok"]}
    require(not bad, f"served requests failed: {bad}")
    worst_v = worst_m = 0.0
    for i, w in enumerate(want):
        r = got[i]
        require(r["batch_size"] == spec["max_batch"],
                f"request {i} in a batch of {r['batch_size']}")
        worst_v = max(worst_v, abs(next(iter(r["expectations"].values())) - w["value"]))
        if "counts" in w:
            require(r["counts"] == w["counts"],
                    "the served shots differ from TorchMeasurer's for the seed")
            key = ",".join(map(str, spec["marginal"]))
            worst_m = float(np.abs(np.asarray(r["marginals"][key]) - w["marginal"]).max())
    dedup = [got[spec["requests"] + j] for j in range(spec["dedup"])]
    amp_err = max(abs(complex(*r["amp0"]) - answers["amp0"]) for r in dedup)
    require(all(r["batch_size"] == spec["dedup"] for r in dedup),
            "the identical ising requests must dedup")
    log(f"  against the runs alone: <{answers['obs']}> max |d| {worst_v:.3e}, marginal "
        f"{spec['marginal']} max |d| {worst_m:.3e}, {spec['shots']} shots equal to "
        f"TorchMeasurer's for the seed, amp0 |d| {amp_err:.3e} ({card})")
    require(worst_v <= spec["atol"] and worst_m <= spec["atol"] and amp_err <= spec["atol"],
            "a served answer differs from the run alone")
    ranks = stats["ranks"]
    hist = ranks["history"]
    require(ranks["world"] == world and [(h["requests"], h["dedup"]) for h in hist]
            == [(spec["max_batch"], False)] * 2 + [(spec["dedup"], True)],
            f"the steps: {[(h['requests'], h['dedup']) for h in hist]}")
    shard = 8 << L
    for b, h in enumerate(hist):
        c = icounts if h["dedup"] else counts
        rows = 1 if h["dedup"] else spec["max_batch"]
        for d, r in enumerate(h["per_rank"]):
            require(r["runs"] == rows and r["launches"]["fused"] == c.get("fused", 0) * rows
                    and r["launches"]["shm"] == c.get("shm", 0) * rows,
                    f"batch {b}, rank {d}: {r['runs']} runs launched {r['launches']}; the plan "
                    f"has {c}")
            last = sum(rp["bytes_sent"][d] for rp in h["remaps"])
            require(r["remap_bytes_sent"] == rows * last,
                    f"batch {b}, rank {d}: remap bytes {r['remap_bytes_sent']} != {rows} x {last}")
            if device == "cuda":
                require(r["peak_bytes"] <= SERVE_SHARDMAP_PEAK,
                        f"rank {d} held {r['peak_bytes']} bytes, more than {SERVE_SHARDMAP_PEAK}")
        for rp in h["remaps"]:
            a2a = shard - (shard >> rp["m"]) if rp["m"] else 0
            perm = shard if rp["permute"] else 0
            require(all(a2a <= x <= a2a + perm for x in rp["bytes_sent"])
                    and (rp["permute"] or all(x == a2a for x in rp["bytes_sent"])),
                    f"batch {b}, remap {rp['slot']}: bytes {rp['bytes_sent']} break Eq. 2")
        log(f"  batch {b} ({h['requests']} requests, "
            + ("one dedup run" if h["dedup"] else f"{rows} rows a rank") + "): stage loop "
            "(execute_s) " + ", ".join(f"{r['execute_s']:.3f}" for r in h["per_rank"])
            + " s, of it remaps " + ", ".join(f"{r['remap_s']:.3f}" for r in h["per_rank"])
            + " s; measure_s " + ", ".join(f"{r['measure_s']:.3f}" for r in h["per_rank"])
            + f" s by rank; launches per rank {h['per_rank'][0]['launches']}; each remap's "
            "bytes a rank " + "; ".join(f"{rp['slot']}: m={rp['m']} {rp['bytes_sent'][0]}"
                                       for rp in h["remaps"])
            + "; peak " + ", ".join(f"{r['peak_bytes']}" for r in h["per_rank"])
            + f" bytes ({card})")
    for d, r in enumerate(ranks["per_rank"]):
        require(r["launches"]["fused"] > 0 and r["launches"]["shm"] > 0,
                f"rank {d} did not launch both kernels in the phase: {r['launches']}")
    warm = hist[1]["per_rank"]
    require(all(not any(r["solver_calls"].values()) and r["shm_schedules"] == 0
                and r["cache_misses"] == 0 for r in warm),
            f"the warm second batch ran a solver, scheduled shm or missed the cache: {warm}")
    e2e = [got[i]["timings"]["e2e_s"] for i in sorted(got)]
    log(f"  e2e p50 {np.percentile(e2e, 50):.3f} s, p99 {np.percentile(e2e, 99):.3f} s over "
        f"{len(e2e)} requests (each: " + ", ".join(f"{x:.1f}" for x in e2e) + " s); the warm "
        f"second batch: no solver call, no shm schedule, no cache miss on any rank ({card})")
    by_k: dict = {}
    for r in ranks["per_rank"]:
        for k, v in r["launches"]["by_k"].items():
            by_k[int(k)] = by_k.get(int(k), 0) + v
    return {"fused": sum(r["launches"]["fused"] for r in ranks["per_rank"]),
            "shm": sum(r["launches"]["shm"] for r in ranks["per_rank"]), "by_k": by_k}


def launches_match(ops, engine, what: str, per_op: int = 1, kinds=("fused", "shm")) -> dict:
    """The kernel launches since the last reset equal the engine's compiled
    ops times ``per_op`` (one launch per op whatever the number of states;
    one per op and shard on the offload path), every kernel of ``kinds``
    ran, and the fused launches match the plan's fused ops by width."""
    launches = ops.kernel_call_counts()
    counts = engine.op_counts()
    want = {"fused": per_op * counts.get("fused", 0), "shm": per_op * counts.get("shm", 0)}
    want_by_k = {}
    for prog in engine.cc.programs:
        for op in prog.ops:
            if op.kind == "fused":
                want_by_k[len(op.local_bits)] = want_by_k.get(len(op.local_bits), 0) + per_op
    log(f"  {what}: kernel launches {launches}, fused by k {ops.fused_call_counts_by_k()}; "
        f"compiled program {counts}" + (f" x {per_op} shards" if per_op > 1 else ""))
    require(launches == want, f"{what}: kernel launches {launches} != compiled ops {want}")
    require(ops.fused_call_counts_by_k() == want_by_k,
            f"{what}: fused launches by k != the plan's fused ops by k {want_by_k}")
    require(all(want[k] > 0 for k in kinds), f"{what} must run {' and '.join(kinds)}")
    return dict(launches, by_k=ops.fused_call_counts_by_k())


def engine_phase(simulate, ops, ref, argv, card: str, device: str = "cuda") -> dict:
    """The engine entry point at full width: ``--engine --bind`` through the
    CLI (a cold build: plan, compile, upload; the first bind fills the
    engine's structural cache), then ``engine_for`` on the same structure
    with other angles: a cache hit that rebinds with no solver call, no
    miss of the structural cache and, through the rebound run, no new shm
    program. Both bindings against the dense per-gate oracle on the card,
    every kernel op of the rebound engine against its plain version."""
    from repro_torch.core import kernelization, staging
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.engine import DEFAULT_CACHE, engine_for
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    ops.reset_kernel_counters()
    run = simulate.main(argv)
    sync(device)
    launches = launches_match(ops, run.engine, "engine path")
    res = run.result
    marg = res.marginals[(0, 1, 2)]
    require(marg.shape == (8,) and bool(np.all(np.isfinite(marg))) and abs(marg.sum() - 1) < 1e-4,
            "engine path: the marginal must be a finite distribution over 8 outcomes")
    require(all(np.isfinite(v) for v in res.expectations.values()),
            "engine path: expectations must be finite")
    eng = run.engine
    first = eng.bound_circuit
    state = eng.finalize(run.state)
    run.state = None
    fid1 = fidelity(state, dense_simulate(first, device=device))
    del state
    log(f"  first binding: fidelity vs dense per-gate oracle {fid1:.9f}; cold build "
        f"(plan + compile + upload) {run.build_seconds:.3f} s, first bind {run.bind_seconds:.3f} s, "
        f"simulate {run.seconds:.3f} s ({card})")
    require(fid1 >= FIDELITY_MIN, f"engine path fidelity {fid1} < {FIDELITY_MIN}")

    def warm_counts():
        return (dict(staging.SOLVER_CALLS), dict(kernelization.SOLVER_CALLS),
                set(eng._struct_cache), ops.SCHEDULE_CALLS["shm"])

    counts = warm_counts()
    hits = DEFAULT_CACHE.hits
    n = eng.n
    bound = PARAM_FAMILIES["isingparam"](n).bind(REBIND)
    sync(device)
    t0 = time.time()
    again = engine_for(bound, eng.L, eng.R, eng.G, device=device)
    sync(device)
    rebind_s = time.time() - t0
    require(again is eng and DEFAULT_CACHE.hits == hits + 1 and eng.bind_count == 2,
            "engine_for on the same structure with other angles must be a cache hit "
            "that rebinds")
    ops.reset_kernel_counters()
    t0 = time.time()
    state = eng.run()
    sync(device)
    run_s = time.time() - t0
    launches_match(ops, eng, "rebound engine")
    require(warm_counts() == counts,
            "a warm rebind and its run must run no solver, miss no entry of the structural "
            "cache and schedule no shm program")
    fid2 = fidelity(state, dense_simulate(bound, device=device))
    del state
    log(f"  rebinding {REBIND}: cache hit, warm rebind {rebind_s:.3f} s (cold build "
        f"{run.build_seconds:.3f} s), run {run_s:.3f} s, fidelity {fid2:.9f}; no solver "
        f"call, no structural-cache miss ({len(counts[2])} entries), no shm program "
        f"scheduled ({card})")
    require(fid2 >= FIDELITY_MIN, f"rebound fidelity {fid2} < {FIDELITY_MIN}")
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(1 << n, dtype=torch.complex64, device=device, generator=gen)
    worst = hold_ops(ops, ref, eng, eng.backend.pass_of(), x, "rebound engine")
    return {"launches": launches, "engine": eng, "x": x, "worst": worst,
            "build_s": run.build_seconds, "first_bind_s": run.bind_seconds,
            "rebind_s": rebind_s, "simulate_s": run.seconds, "rebound_run_s": run_s,
            "fidelity": [fid1, fid2]}


def sweep_phase(ops, ref, n: int, L: int, R: int, P: int, card: str,
                device: str = "cuda") -> dict:
    """``isingparam(n)`` against P bindings in one ``run_sweep``: one launch
    per compiled op for all P points (past int32 indices at n=28, P=16),
    every row against the dense oracle, ``measure_sweep`` finite, against P
    sequential ``run`` calls of the same engine; then every kernel op at
    the sweep's own shapes (:func:`hold_sweep_ops`)."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.measure import measure_sweep
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    sym = PARAM_FAMILIES["isingparam"](n)
    t0 = time.time()
    eng = engine_for(sym, L, R, 0, device=device)
    build_s = time.time() - t0
    rng = np.random.default_rng(13)
    points = [{"J": float(j), "h": float(h)} for j, h in rng.uniform(-1.5, 1.5, size=(P, 2))]
    # warm-up of both shapes: the binding pass's structural cache, index
    # tensors, step tables
    eng.run(params=points[0])
    eng.run_sweep(None, points)
    sync(device)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    t0 = time.time()
    out = eng.run_sweep(None, points)
    sync(device)
    sweep_s = time.time() - t0
    exec_s = eng.timing_snapshot()["run_sweep"]["last_us"] / 1e6
    launches = launches_match(ops, eng, f"sweep of {P}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    require(out.shape == (P, 1 << n), f"sweep output {tuple(out.shape)}")
    fids = []
    t0 = time.time()
    for p in range(P):
        fids.append(fidelity(out[p], dense_simulate(sym.bind(points[p]), device=device)))
        require(fids[-1] >= FIDELITY_MIN, f"sweep row {p} fidelity {fids[-1]} < {FIDELITY_MIN}")
    oracle_s = time.time() - t0
    del out
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    runs = 0.0
    for pt in points:
        eng.run(params=pt)
        runs += eng.timing_snapshot()["run"]["last_us"] / 1e6
    sync(device)
    seq_s = time.time() - t0
    if device == "cuda":
        trace_run(lambda: eng.run_sweep(None, points), exec_s, f"run_sweep of {P}")
        trace_run(eng.run, runs / P, "one run of the sequence")
    t0 = time.time()
    results = measure_sweep(eng, points, marginals=[(0, 1, 2)], observables=["Z0 Z1 + 0.5*X2"])
    measure_s = time.time() - t0
    require(len(results) == P and all(
        bool(np.all(np.isfinite(r.marginals[(0, 1, 2)])))
        and all(np.isfinite(v) for v in r.expectations.values()) for r in results),
        "measure_sweep marginals and expectations must be finite")
    log(f"  isingparam({n}) L={L} R={R}, P={P}: {P << n} amplitudes; sweep {sweep_s:.3f} s = "
        f"{sweep_s / P:.4f} s/point (stage loop {exec_s:.3f} s, the rest host binding); "
        f"{P} sequential runs {seq_s:.3f} s = {seq_s / P:.4f} s/point (stage loops {runs:.3f} s); "
        f"peak device memory {gib(peak)}; fidelity of rows 0..{P - 1} against the oracle "
        f"({oracle_s:.1f} s): min {min(fids):.9f}, max {max(fids):.9f}; measure_sweep "
        f"{measure_s:.1f} s; engine built in {build_s:.2f} s ({card})")
    worst = hold_sweep_ops(ops, ref, eng, eng.backend.pass_of(P, eng.sweep_tables(points)),
                           seed=17, what=f"sweep of {P}")
    return {"launches": launches, "sweep_s": sweep_s, "sweep_exec_s": exec_s,
            "sequential_s": seq_s, "sequential_exec_s": runs, "peak_bytes": peak,
            "fidelity": fids, "worst": worst}


def batch_phase(ops, ref, n: int, L: int, R: int, B: int, card: str,
                device: str = "cuda") -> dict:
    """``qft(n)`` on B basis states in one ``run_batch`` (B need not be a
    power of two): one launch per compiled op, each row against the dense
    oracle, every kernel op at the batch's shard count against its plain
    version."""
    from repro_torch.core.generators import FAMILIES
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    circ = FAMILIES["qft"](n)
    t0 = time.time()
    eng = engine_for(circ, L, R, 0, device=device)
    build_s = time.time() - t0
    psi0s = torch.zeros(B, 1 << n, dtype=torch.complex64, device=device)
    psi0s[torch.arange(B), torch.arange(B)] = 1.0
    eng.run_batch(psi0s)  # warm-up of both shapes: index tensors, step tables
    eng.run(psi0s[0])
    sync(device)
    ops.reset_kernel_counters()
    t0 = time.time()
    out = eng.run_batch(psi0s)
    sync(device)
    batch_s = time.time() - t0
    launches = launches_match(ops, eng, f"batch of {B}")
    t0 = time.time()
    eng.run(psi0s[0])
    sync(device)
    single_s = time.time() - t0
    fids = []
    for b in range(B):
        fids.append(fidelity(out[b], dense_simulate(circ, psi0=psi0s[b], device=device)))
        require(fids[-1] >= FIDELITY_MIN, f"batch row {b} fidelity {fids[-1]} < {FIDELITY_MIN}")
    log(f"  qft({n}) L={L} R={R}, B={B}: run_batch {batch_s:.3f} s = {batch_s / B:.4f} s/state "
        f"(one state alone {single_s:.4f} s); "
        "fidelity " + ", ".join(f"{f:.9f}" for f in fids)
        + f"; engine built in {build_s:.2f} s ({card})")
    del out, psi0s
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(B << n, dtype=torch.complex64, device=device, generator=gen)
    worst = hold_ops(ops, ref, eng, eng.backend.pass_of(B), x, f"batch of {B}")
    return {"launches": launches, "batch_s": batch_s, "single_s": single_s, "fidelity": fids,
            "worst": worst}


def pinned() -> tuple:
    """Blocks and bytes PyTorch's pinned host allocator has pinned so far (a
    block it hands out again is not counted again). Small blocks stage the
    uploads of index tensors and step tables; a state buffer is a block of
    at least a shard."""
    st = torch.cuda.host_memory_stats()
    return int(st["num_host_alloc"]), int(st["allocated_bytes.allocated"])


def release_pinned() -> None:
    """Hand the pinned blocks PyTorch's host allocator keeps cached back to
    the system: the offload states are tens of GiB of host memory, and the
    next phase pins other sizes."""
    gc.collect()
    empty = (getattr(getattr(torch, "accelerator", None), "empty_host_cache", None)
             or getattr(torch._C, "_host_emptyCache", None))
    require(empty is not None, "this torch cannot release its pinned host cache")
    empty()


def link_rates(nbytes: int = 2 << 30) -> dict:
    """Pinned host <-> card copy rates in GB/s at one 2 GiB shard: each
    direction alone (median of 5 CUDA-event timings) and both at once on
    two streams (median of 3 wall timings)."""
    from repro_torch.kernels import probe

    amps = nbytes // 8
    host = [torch.empty(amps, dtype=torch.complex64, pin_memory=True) for _ in range(2)]
    dev = [torch.empty(amps, dtype=torch.complex64, device="cuda") for _ in range(2)]
    h2d = probe.time_ms(lambda: dev[0].copy_(host[0], non_blocking=True)) / 1e3
    d2h = probe.time_ms(lambda: host[1].copy_(dev[1], non_blocking=True)) / 1e3
    streams = [torch.cuda.Stream() for _ in range(2)]
    both = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(streams[0]):
            dev[0].copy_(host[0], non_blocking=True)
        with torch.cuda.stream(streams[1]):
            host[1].copy_(dev[1], non_blocking=True)
        torch.cuda.synchronize()
        both.append(time.perf_counter() - t0)
    del host, dev
    release_pinned()
    return {"h2d": nbytes / h2d / 1e9, "d2h": nbytes / d2h / 1e9,
            "both": 2 * nbytes / float(np.median(both)) / 1e9}


class MeasureClock:
    """While installed, times the measurer's parts (seconds): the shard
    masses, sampling (without the masses), marginals and expectations. On
    its first call it also reads the device memory the run left (peak and
    in use) and resets the peak, so the run's peak and the measurement's
    are told apart."""

    def __init__(self, TM):
        self.TM = TM
        self.seconds = {"masses": 0.0, "sampling": 0.0, "marginal": 0.0, "expectation": 0.0}
        self.run_peak = self.after_run = None

    def _wrap(self, cls, name, part):
        orig = getattr(cls, name)

        def timed(obj, *args, **kw):
            if self.run_peak is None:
                torch.cuda.synchronize()
                self.run_peak = torch.cuda.max_memory_allocated()
                self.after_run = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = orig(obj, *args, **kw)
            self.seconds[part] += time.perf_counter() - t0
            return out

        self._saved.append((cls, name, orig))
        setattr(cls, name, timed)

    def __enter__(self):
        self._saved = []
        self._wrap(self.TM.StreamingMeasurer, "_shard_masses", "masses")
        self._wrap(self.TM.Measurer, "sample", "sampling")
        self._wrap(self.TM.Measurer, "marginal", "marginal")
        self._wrap(self.TM.Measurer, "expectation", "expectation")
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)
        self.seconds["sampling"] -= self.seconds["masses"]


def shard_fidelity(host: torch.Tensor, on_card: torch.Tensor, L: int) -> tuple:
    """``|<host|on_card>|`` accumulated in complex128 shard by shard on the
    card (one host shard copied up at a time), the largest amplitude
    difference, and ``||host - on_card||_2``."""
    host, on_card = host.reshape(-1), on_card.reshape(-1)
    inner = torch.zeros((), dtype=torch.complex128, device="cuda")
    sq = torch.zeros((), dtype=torch.float64, device="cuda")
    worst = 0.0
    for lo in range(0, host.numel(), 1 << L):
        a = host[lo:lo + (1 << L)].to("cuda", non_blocking=True)
        b = on_card[lo:lo + (1 << L)]
        worst = max(worst, max_err(a, b))
        inner += torch.vdot(a.to(torch.complex128), b.to(torch.complex128))
        sq += (a - b).abs().pow_(2).sum(dtype=torch.float64)
        del a
    return float(inner.abs()), worst, float(sq.sqrt())


def stage_lines(be, rates: dict, card: str, what: str) -> list:
    """Log each streamed stage of the offload backend's last run (bytes
    both ways, GB/s, and the link bounds from ``rates``: both directions
    at once at their rates alone, both at once at the rate measured with
    both running, one direction at a time) and each host remap; return the
    stages."""
    stages = [t for t in be.trace if t["kind"] == "stage"]
    for i, t in enumerate(stages):
        half = t["bytes"] / 2
        both = max(half / rates["h2d"], half / rates["d2h"]) / 1e9
        shared = t["bytes"] / rates["both"] / 1e9
        one = (half / rates["h2d"] + half / rates["d2h"]) / 1e9
        t.update(gb_s=t["bytes"] / t["seconds"] / 1e9, bound_both_s=both,
                 bound_shared_s=shared, bound_one_way_s=one)
        log(f"  {what} stage {i}: {t['ops']} ops, {gib(t['bytes'])} moved (up and down) in "
            f"{t['seconds']:.3f} s = {t['gb_s']:.2f} GB/s; link bound {both:.3f} s (both ways "
            f"at once), {shared:.3f} s (both ways at the measured shared rate), {one:.3f} s "
            f"(one way at a time) ({card})")
    remaps = [t for t in be.trace if t["kind"] == "remap"]
    log(f"  {what} host remaps: " + ", ".join(f"{t['slot']} {t['seconds']:.3f} s" for t in remaps))
    return stages


def offload_phase(simulate, ops, ref, probe, card: str, rates: dict, fused: dict) -> dict:
    """``ising(31)`` L=27 R=4 through ``--executor offload``: a 16 GiB
    pinned host state in 16 shards of 1 GiB, streamed through the hand
    kernels stage by stage, then measured shard by shard. Checks one
    launch per op and shard, the run's peak device memory (at most four
    shards above what the engine keeps), every kernel op on shard 0 and
    shard 15 against its plain version, the state against the in-card run
    of the same plan, and a warm run after a rebind that pins no host
    memory and schedules no shm program."""
    from repro_torch.sim import measure as TM
    from repro_torch.sim.engine import ExecutionEngine

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    pins = pinned()
    t0 = time.time()
    with MeasureClock(TM) as clock:
        run = simulate.main(OFFLOAD_PATH)
    cli_s = time.time() - t0
    eng, be = run.engine, run.engine.backend
    S, L = be.S, eng.L
    shard_bytes = 8 << L
    launches = launches_match(ops, eng, "offload path", per_op=S)
    res = run.result
    require(res.samples.shape == (OFFLOAD_SHOTS,)
            and bool(np.all((res.samples >= 0) & (res.samples < 1 << eng.n))),
            f"offload path: shots must be {OFFLOAD_SHOTS} basis-state indices")
    marg = res.marginals[(0, 1, 2)]
    require(marg.shape == (8,) and bool(np.all(np.isfinite(marg))) and abs(marg.sum() - 1) < 1e-4,
            "offload path: the marginal must be a finite distribution over 8 outcomes")
    require(all(np.isfinite(v) for v in res.expectations.values()),
            "offload path: expectations must be finite")
    stages = stage_lines(be, rates, card, "offload")
    remaps = [t["seconds"] for t in be.trace if t["kind"] == "remap"]
    run_peak, kept = clock.run_peak - base, clock.after_run - base
    require(run_peak <= 4 * shard_bytes + kept,
            f"offload run: peak device memory {gib(run_peak)} exceeds four shards above the "
            f"{gib(kept)} the engine keeps")
    meas_peak = torch.cuda.max_memory_allocated() - base
    blocks, nbytes = (a - b for a, b in zip(pinned(), pins))
    log(f"  simulate {run.seconds:.3f} s (cold: a first run pins its host states) = "
        f"{sum(t['seconds'] for t in stages):.3f} s streamed stages + {sum(remaps):.3f} s host "
        f"remaps + the rest; pinned {gib(nbytes)} in {blocks} blocks; overlap_ratio "
        f"{be.overlap_ratio:.3f}; peak device memory {gib(run_peak)} ({run_peak / shard_bytes:.2f}"
        f" shards; the engine keeps {gib(kept)}) against a {gib(8 << eng.n)} state; measuring "
        f"{gib(meas_peak)} ({card})")
    m = clock.seconds
    log(f"  measured in {sum(m.values()):.3f} s: shard masses {m['masses']:.3f} s, sampling "
        f"{OFFLOAD_SHOTS} shots {m['sampling']:.3f} s ({len(np.unique(res.samples >> L))} "
        "distinct shards, "
        f"each a host float64 CDF of 2^{L} amplitudes), marginal {m['marginal']:.3f} s, "
        f"expectation {m['expectation']:.3f} s; the CLI call {cli_s:.1f} s ({card})")

    # the in-card run of the same plan, shard by shard against the offload state
    t0 = time.time()
    in_card = ExecutionEngine(eng.circuit, eng.plan, device="cuda")
    want = in_card.run_packed()
    sync("cuda")
    card_s = time.time() - t0
    fid, diff, _ = shard_fidelity(run.state, want, L)
    log(f"  ising({eng.n}) offload vs in-card on one plan, shard by shard: fidelity {fid:.9f}, "
        f"max |difference| {diff:.3e}; in-card compile + run {card_s:.3f} s ({card})")
    require(fid >= FIDELITY_MIN, f"offload fidelity {fid} < {FIDELITY_MIN}")
    run.state = None
    del in_card

    # a warm run after a rebind: no pinned block, no shm program, same state
    gc.collect()
    pins, schedules = pinned(), ops.SCHEDULE_CALLS["shm"]
    eng.bind_circuit(eng.bound_circuit)
    t0 = time.time()
    again = eng.run_packed()
    warm_s = time.time() - t0
    blocks, nbytes = (a - b for a, b in zip(pinned(), pins))
    require(nbytes < shard_bytes and ops.SCHEDULE_CALLS["shm"] == schedules,
            f"a warm offload run after a rebind must pin no state buffer ({gib(nbytes)} "
            f"pinned) and schedule no shm program")
    warm_stages = stage_lines(be, rates, card, "offload warm")
    fid2, _, _ = shard_fidelity(again, want, L)
    require(fid2 >= FIDELITY_MIN, f"warm offload fidelity {fid2} < {FIDELITY_MIN}")
    log(f"  warm run after a rebind: {warm_s:.3f} s; no state buffer pinned ({nbytes} bytes "
        f"in {blocks} staging blocks), no shm program scheduled, fidelity {fid2:.9f} ({card})")
    del again, want
    torch.cuda.empty_cache()

    # every kernel op of the path on shard 0 and the last shard, as launched
    tops = [op for prog in eng.cc.programs for op in prog.ops]
    worst = {"fused": 0.0, "shm": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(1 << L, dtype=torch.complex64, device="cuda", generator=gen)
    ps0 = None
    for s in (0, S - 1):
        ps = be.shard_pass(s, tops, be.new_run(1))
        ps0 = ps0 or ps
        w = hold_ops(ops, ref, eng, ps, x, f"offload shard {s}")
        worst = {k: max(worst[k], w[k]) for k in worst}
    rows = fused_by_k(ops, ref, probe, eng, x, "offload shard 0", launches["by_k"],
                      skip=[row["k"] for row in fused["by_k"]], ps=ps0)
    fused["by_k"] += [by_k_row(row) for row in rows]
    # each stage's kernels alone on one shard (CUDA events), times the shards
    for i, (prog, t) in enumerate(zip(eng.cc.programs, warm_stages)):
        ps = be.shard_pass(0, prog.ops, be.new_run(1))
        ms = probe.time_ms(lambda: be.apply_ops(x, prog, ps), reps=3)
        t["kernels_s"] = ms * S / 1e3
        log(f"  offload stage {i}: its kernels alone {ms:.2f} ms a shard, {t['kernels_s']:.3f} s "
            f"for {S} shards, against {t['seconds']:.3f} s streamed (warm) ({card})")
    del x, run
    release_pinned()
    return {"launches": launches, "worst": worst, "stages": stages, "warm_stages": warm_stages,
            "remaps": remaps, "measure": m, "run_peak": run_peak, "fidelity": [fid, fid2]}


def pergate_phase(ops, ref, probe, card: str, fused: dict, n: int, L: int, R: int) -> dict:
    """``qft(n)`` through the staged offload path and through the per-gate
    baseline (one pass over the host state for each op): shard transfers,
    seconds, their ratios, each state against the in-card run of the
    staged plan, every kernel op of both on shard 0 and the last shard
    against its plain version."""
    from repro_torch.core.generators import FAMILIES
    from repro_torch.sim.engine import ExecutionEngine, engine_for
    from repro_torch.sim.offload import PerGateOffloadExecutor
    from repro_torch.sim.statevector import fidelity

    circ = FAMILIES["qft"](n)
    staged = engine_for(circ, L, R, 0, backend="offload", device="cuda")
    staged.run()  # first use: pins this size and builds the step tables
    ops.reset_kernel_counters()
    before = staged.backend.stats["shard_transfers"]
    t0 = time.time()
    a = staged.run()
    staged_s = time.time() - t0
    staged_moves = staged.backend.stats["shard_transfers"] - before
    S = staged.backend.S
    staged_launches = launches_match(ops, staged, f"qft({n}) staged offload", per_op=S, kinds=())
    want = ExecutionEngine(circ, staged.plan, device="cuda").run()
    fa = fidelity(a.to("cuda"), want)
    del a
    pg = PerGateOffloadExecutor(circ, L, device="cuda")
    ops.reset_kernel_counters()
    t0 = time.time()
    b = pg.run()
    pg_s = time.time() - t0
    pg_launches = launches_match(ops, pg.engine, f"qft({n}) per-gate", per_op=S, kinds=("fused",))
    fb = fidelity(b.to("cuda"), want)
    del b, want
    passes = sum(len(p.ops) for p in pg.engine.cc.programs)
    require(staged_moves == len(staged.cc.programs) * S,
            "staged offload: one transfer per stage and shard")
    require(pg.stats["shard_transfers"] == passes * S, "per-gate: one transfer per op and shard")
    ratio = pg.stats["shard_transfers"] / staged_moves
    require(ratio > 5, f"the per-gate baseline moves only {ratio:.1f}x the staged shards")
    require(min(fa, fb) >= FIDELITY_MIN, f"qft({n}) offload fidelities {fa}, {fb}")
    log(f"  qft({n}) L={L} R={R}: staged offload {staged_s:.3f} s ({staged_moves} shard "
        f"transfers, {len(staged.cc.programs)} stages), per-gate {pg_s:.3f} s "
        f"({pg.stats['shard_transfers']} shard transfers, {passes} passes); transfers "
        f"{ratio:.2f}x, seconds {pg_s / staged_s:.1f}x; fidelity vs in-card {fa:.9f} (staged), "
        f"{fb:.9f} (per-gate) ({card})")
    worst = {"fused": 0.0, "shm": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(1 << L, dtype=torch.complex64, device="cuda", generator=gen)
    for eng, what in ((staged, "staged"), (pg.engine, "per-gate")):
        be = eng.backend
        tops = [op for prog in eng.cc.programs for op in prog.ops]
        ps0 = None
        for s in (0, S - 1):
            ps = be.shard_pass(s, tops, be.new_run(1))
            ps0 = ps0 or ps
            w = hold_ops(ops, ref, eng, ps, x, f"qft({n}) {what} shard {s}")
            worst = {k: max(worst[k], w[k]) for k in worst}
        launches = staged_launches if eng is staged else pg_launches
        rows = fused_by_k(ops, ref, probe, eng, x, f"qft({n}) {what} shard 0", launches["by_k"],
                          skip=[row["k"] for row in fused["by_k"]], ps=ps0)
        fused["by_k"] += [by_k_row(row) for row in rows]
    del x, staged, pg
    release_pinned()
    return {"staged": staged_launches, "pergate": pg_launches, "worst": worst,
            "staged_s": staged_s, "pergate_s": pg_s, "ratio": ratio}


def offload_rows_phase(ops, ref, card: str, n: int, L: int, R: int, B: int, P: int) -> dict:
    """A batch of B basis states of ``qft(n)`` and a sweep of P bindings of
    ``isingparam(n)`` through the offload backend (``[B, 2^L]`` and
    ``[P, 2^L]`` blocks), each row against the in-card ``run_batch`` /
    ``run_sweep`` of the same plan on the card, every kernel op on shard 0
    at the pass's rows against its plain version."""
    from repro_torch.core.generators import FAMILIES, PARAM_FAMILIES
    from repro_torch.sim.engine import ExecutionEngine, engine_for
    from repro_torch.sim.statevector import fidelity

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(13)
    for what, rows in (("batch", B), ("sweep", P)):
        if what == "batch":
            circ = FAMILIES["qft"](n)
            psi0s = torch.zeros(B, 1 << n, dtype=torch.complex64, device="cuda")
            psi0s[torch.arange(B), torch.arange(B)] = 1.0
            off = engine_for(circ, L, R, 0, backend="offload", device="cuda")
            in_card = ExecutionEngine(circ, off.plan, device="cuda")

            def go(e):
                return e.run_batch(psi0s)
        else:
            circ = PARAM_FAMILIES["isingparam"](n)
            rng = np.random.default_rng(29)
            points = [{"J": float(j), "h": float(h)} for j, h in rng.uniform(-1.5, 1.5, (P, 2))]
            off = engine_for(circ, L, R, 0, backend="offload", device="cuda")
            in_card = ExecutionEngine(circ, off.plan, device="cuda")

            def go(e):
                return e.run_sweep(None, points)
        S = off.backend.S
        ops.reset_kernel_counters()
        t0 = time.time()
        got = go(off)
        off_s = time.time() - t0
        launches = launches_match(ops, off, f"offload {what} of {rows}", per_op=S)
        want = go(in_card)
        fids = [fidelity(got[r].to("cuda"), want[r]) for r in range(rows)]
        require(min(fids) >= FIDELITY_MIN, f"offload {what}: fidelities {fids}")
        log(f"  {'qft' if what == 'batch' else 'isingparam'}({n}) L={L} R={R}, offload {what} "
            f"of {rows}: {off_s:.3f} s (first run), {S} shards of [{rows}, 2^{L}]; fidelity vs "
            f"the in-card {what} " + ", ".join(f"{f:.9f}" for f in fids) + f" ({card})")
        del got, want, in_card
        be = off.backend
        run = be.new_run(rows, off.sweep_tables(points) if what == "sweep" else None)
        tops = [op for prog in off.cc.programs for op in prog.ops]
        ps = be.shard_pass(0, tops, run)
        x = torch.randn(rows << L, dtype=torch.complex64, device="cuda", generator=gen)
        worst = hold_ops(ops, ref, off, ps, x, f"offload {what} of {rows}, shard 0")
        out[what] = {"launches": launches, "worst": worst, "fidelity": fids}
        del x, run, ps, off
        torch.cuda.empty_cache()
        release_pinned()
    return out


def host_check() -> int:
    """The spill directory's disk and the host's memory, as ``df -h`` and
    ``free -g`` print them, and its cores; returns the disk's free bytes."""
    os.makedirs(SPILL_ROOT, exist_ok=True)
    for cmd in (["df", "-h", SPILL_ROOT], ["free", "-g"]):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        for line in (proc.stdout or proc.stderr).strip().splitlines():
            log(f"  {cmd[0]}: {line}")
    log(f"  host cores: {os.cpu_count()}")
    return shutil.disk_usage(SPILL_ROOT).free


def store_budget(tier: str, n: int, fraction: float, free_disk: int) -> int:
    """The DRAM budget that keeps ``fraction`` of the state at rest in DRAM,
    raised where the disk could not take half of what spills: a remap
    holds both generations of the state at rest, less what DRAM holds."""
    from repro_torch.sim.shard_store import AT_REST_BYTES_PER_AMP

    at_rest = AT_REST_BYTES_PER_AMP[tier] * (1 << n)
    budget = fraction * at_rest
    if 2 * at_rest - budget > free_disk / 2:
        budget = 2 * at_rest - free_disk / 2
    require(budget < at_rest, f"the spill disk has {gib(free_disk)} free: too little to spill "
                              f"a {gib(at_rest)} {tier} state")
    return int(budget)


def store_phase(simulate, ops, ref, probe, card: str, fused: dict, free_disk: int, tier: str,
                n: int, L: int, R: int, dram_fraction: float, tol: float, xy: bool = False) -> dict:
    """``ising(n)`` through ``--executor offload --storage tier`` with a DRAM
    budget that spills: one launch per op and shard, spills and reloads,
    the run's peak device memory (at most four shards), each stage and
    out-of-core remap with the store's codec and disk seconds, the pinned
    bytes, and the state against the in-card run of the same plan shard by
    shard within the run's own error bound; every kernel op on shards 0 and
    S-1 against its plain version. With ``xy``, Pauli terms with 2 and 3
    non-local X/Y qubits measured on the store's state (peak device memory)
    and on the in-card state."""
    from repro_torch.sim import measure as TM
    from repro_torch.sim.engine import ExecutionEngine

    budget = store_budget(tier, n, dram_fraction, free_disk)
    spill = os.path.join(SPILL_ROOT, f"{tier}{n}")
    shutil.rmtree(spill, ignore_errors=True)
    argv = ["--circuit", "ising", "--n", str(n), "--L", str(L), "--R", str(R), "--executor",
            "offload", "--storage", tier, "--dram-budget-mb", str(budget / 2**20), "--spill-dir",
            spill, "--storage-tol", str(tol), "--observable", "Z0 Z1 + 0.5*X2"]
    log("  " + " ".join(argv))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    pins = pinned()
    t0 = time.time()
    with MeasureClock(TM) as clock:
        run = simulate.main(argv)
    cli_s = time.time() - t0
    eng, be = run.engine, run.engine.backend
    S, shard_bytes = be.S, 8 << L
    launches = launches_match(ops, eng, f"{tier} store path", per_op=S)
    snap = eng.provenance["storage"]
    require(snap["spills"] > 0 and snap["spill_loads"] > 0,
            f"{tier} store: the run must spill and reload ({snap['spills']} spills, "
            f"{snap['spill_loads']} reloads)")
    require(all(np.isfinite(v) for v in run.result.expectations.values()),
            f"{tier} store: expectations must be finite")
    run_peak, kept = clock.run_peak - base, clock.after_run - base
    require(run_peak <= 4 * shard_bytes + kept,
            f"{tier} store run: peak device memory {gib(run_peak)} exceeds four shards above the "
            f"{gib(kept)} the engine keeps")
    blocks, nbytes = (a - b for a, b in zip(pinned(), pins))
    io = {"spill_write_s": 0.0, "spill_read_s": 0.0, "spill_write_bytes": 0, "spill_read_bytes": 0}
    for t in be.trace:
        st = t.get("store")
        what = {"stage": f"stage ({t.get('ops')} ops)", "remap": f"out-of-core remap {t.get('slot')}"
                }.get(t["kind"], t["kind"])
        line = f"  {tier} store {what}: {t['seconds']:.3f} s"
        if st:
            for k in io:
                io[k] += st[k]
            io_s = st["spill_write_s"] + st["spill_read_s"]
            io_b = st["spill_write_bytes"] + st["spill_read_bytes"]
            line += (f"; encode {st['encode_s']:.3f} s, decode {st['decode_s']:.3f} s, disk "
                     f"{gib(st['spill_write_bytes'])} out + {gib(st['spill_read_bytes'])} in in "
                     f"{io_s:.3f} s" + (f" = {io_b / io_s / 1e9:.2f} GB/s" if io_s else ""))
        log(line + f" ({card})")
    stages = [t["seconds"] for t in be.trace if t["kind"] == "stage"]
    remaps = [t["seconds"] for t in be.trace if t["kind"] == "remap"]
    gather = sum(t["seconds"] for t in be.trace if t["kind"] == "gather")
    io_s = io["spill_write_s"] + io["spill_read_s"]
    log(f"  {tier} ising({n}) L={L} R={R}: simulate {run.seconds:.3f} s = {sum(stages):.3f} s "
        f"stages + {sum(remaps):.3f} s out-of-core remaps + {gather:.3f} s gather + the rest "
        f"(filling the store); spill {gib(io['spill_write_bytes'])} written at "
        f"{io['spill_write_bytes'] / max(io['spill_write_s'], 1e-9) / 1e9:.2f} GB/s, "
        f"{gib(io['spill_read_bytes'])} read at "
        f"{io['spill_read_bytes'] / max(io['spill_read_s'], 1e-9) / 1e9:.2f} GB/s ({io_s:.3f} s); "
        f"{snap['spills']} spills, {snap['spill_loads']} reloads, peak at-rest DRAM "
        f"{gib(snap['peak_dram_bytes'])} of a {gib(budget)} budget; error bound "
        f"{snap['relative_error_bound']:.3e} (tol {tol}); peak device memory {gib(run_peak)} "
        f"({run_peak / shard_bytes:.2f} shards; the engine keeps {gib(kept)}); pinned "
        f"{gib(nbytes)} in {blocks} blocks; the CLI call {cli_s:.1f} s ({card})")

    t0 = time.time()
    in_card = ExecutionEngine(eng.circuit, eng.plan, device="cuda")
    want = in_card.run_packed()
    sync("cuda")
    card_s = time.time() - t0
    fid, diff, l2 = shard_fidelity(run.state, want, L)
    bound = snap["relative_error_bound"]
    log(f"  {tier} store vs in-card on one plan, shard by shard: ||difference|| {l2:.3e} against "
        f"the run's bound {bound:.3e}; fidelity {fid:.9f}, max |difference| {diff:.3e}; in-card "
        f"compile + run {card_s:.3f} s ({card})")
    require(l2 <= bound + 1e-5, f"{tier} store: ||store - in-card|| {l2} exceeds the bound {bound}")
    del in_card
    out = {"launches": launches, "seconds": run.seconds, "stages": stages, "remaps": remaps,
           "io": io, "run_peak": run_peak, "pinned": nbytes, "l2": l2, "bound": bound}
    if xy:
        frame = eng.measurement_frame
        nl = [q for q in range(frame.n) if frame.phys_of[q] >= L]
        loc = [q for q in range(frame.n) if frame.phys_of[q] < L]
        terms = [f"X{nl[0]} Y{nl[1]} Z{loc[0]}", f"X{nl[0]} Y{nl[1]} X{nl[2]} Z{loc[1]}"]
        on_card = [TM.StreamingMeasurer(want, frame, "cuda").expectation(t) for t in terms]
        del want
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m = TM.StreamingMeasurer(run.state, frame, "cuda")
        vals, secs = [], []
        for t in terms:
            t0 = time.time()
            vals.append(m.expectation(t))
            secs.append(time.time() - t0)
        xy_peak = torch.cuda.max_memory_allocated() - base
        for t, v, w, sec in zip(terms, vals, on_card, secs):
            mm = t.count("X") + t.count("Y")
            log(f"  <{t}> (m={mm} non-local X/Y): {v:+.9f} on the {tier} store's state in "
                f"{sec:.3f} s, {w:+.9f} on the in-card state ({card})")
            require(abs(v - w) <= 2.1 * l2 + 1e-5,
                    f"<{t}> on the store's state and on the in-card state differ by {abs(v - w)}")
        log(f"  X/Y terms: peak device memory {gib(xy_peak)} ({xy_peak / shard_bytes:.2f} shards), "
            f"against the run's {gib(run_peak)}; a whole group at m=3 would stack "
            f"{gib(2 * 8 * shard_bytes)} ({card})")
        require(xy_peak <= run_peak + shard_bytes,
                f"X/Y measurement peak {gib(xy_peak)} exceeds the run's {gib(run_peak)} plus a shard")
        out.update(xy_peak=xy_peak, xy=dict(zip(terms, vals)))
    else:
        del want
    torch.cuda.empty_cache()

    tops = [op for prog in eng.cc.programs for op in prog.ops]
    worst = {"fused": 0.0, "shm": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn(1 << L, dtype=torch.complex64, device="cuda", generator=gen)
    ps0 = None
    for s in (0, S - 1):
        ps = be.shard_pass(s, tops, be.new_run(1))
        ps0 = ps0 or ps
        w = hold_ops(ops, ref, eng, ps, x, f"{tier} store shard {s}")
        worst = {k: max(worst[k], w[k]) for k in worst}
    rows = fused_by_k(ops, ref, probe, eng, x, f"{tier} store shard 0", launches["by_k"],
                      skip=[row["k"] for row in fused["by_k"]], ps=ps0)
    fused["by_k"] += [by_k_row(row) for row in rows]
    del x, run
    release_pinned()
    shutil.rmtree(spill, ignore_errors=True)
    out["worst"] = worst
    return out


def checkpoint_phase(card: str, ops, ref, n: int, L: int, R: int) -> dict:
    """``ising(n)`` through the offload backend with ``checkpoint_dir``:
    killed by an injected ``shard_transfer_error`` inside stage 1 (only that
    typed error may end it), then resumed in a fresh engine from the
    journal: the resumed stages' launches, and the state equal to the
    uninterrupted run's bit for bit; the save of each stage timed. The
    uninterrupted run is held against the in-card run of its plan shard by
    shard, and every kernel op of its shards 0 and S-1 against its plain
    version."""
    from repro_torch.core.generators import FAMILIES
    from repro_torch.sim import faults
    from repro_torch.sim.engine import ExecutionEngine, engine_for

    circ = FAMILIES["ising"](n)
    shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    plain = engine_for(circ, L, R, 0, backend="offload", device="cuda", cache=None)
    t0 = time.time()
    want = plain.run()
    plain_s = time.time() - t0
    S = plain.backend.S
    on_card = ExecutionEngine(circ, plain.plan, device="cuda").run()
    fid, diff, _ = shard_fidelity(want, on_card, L)
    del on_card
    torch.cuda.empty_cache()
    log(f"  ising({n}) uninterrupted offload run vs in-card on one plan, shard by shard: "
        f"fidelity {fid:.9f}, max |difference| {diff:.3e} ({card})")
    require(fid >= FIDELITY_MIN, f"checkpoint phase: offload fidelity {fid} < {FIDELITY_MIN}")
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(1 << L, dtype=torch.complex64, device="cuda", generator=gen)
    tops = [op for prog in plain.cc.programs for op in prog.ops]
    worst = {"fused": 0.0, "shm": 0.0}
    for s in (0, S - 1):
        ps = plain.backend.shard_pass(s, tops, plain.backend.new_run(1))
        w = hold_ops(ops, ref, plain, ps, x, f"checkpoint plan shard {s}")
        worst = {k: max(worst[k], w[k]) for k in worst}
    del x, ps
    kw = dict(backend="offload", device="cuda", cache=None, checkpoint_dir=CHECKPOINT_DIR)
    eng = engine_for(circ, L, R, 0, **kw)
    require(len(eng.cc.programs) >= 2, "the checkpoint phase needs a plan of two stages")
    plan = faults.FaultPlan(seed=1).add("shard_transfer_error", site="offload.shard",
                                        after=S + S // 2, count=1)
    killed = None
    t0 = time.time()
    with faults.inject(plan):
        try:
            eng.run()
        except faults.ShardTransferError as e:
            killed = e
    kill_s = time.time() - t0
    require(killed is not None and killed.injected and f"offload.shard{S // 2}" in str(killed),
            "the checkpointed run must end with the injected shard_transfer_error in stage 1")
    saves = [t for t in eng.backend.trace if t["kind"] == "checkpoint"]
    require(eng.backend.stats["checkpointed_stages"] >= 1
            and os.path.exists(os.path.join(CHECKPOINT_DIR, "journal.json")),
            "the killed run must leave a checkpoint")
    fresh = engine_for(circ, L, R, 0, **kw)
    ops.reset_kernel_counters()
    t0 = time.time()
    got = fresh.run()
    resume_s = time.time() - t0
    start = fresh.backend.stats["resumed_stages"]
    require(start >= 1, "the fresh engine must resume from the journal")
    want_launches = {k: S * sum(op.kind == k for prog in fresh.cc.programs[start:]
                                for op in prog.ops) for k in ("fused", "shm")}
    launches = ops.kernel_call_counts()
    require(launches == want_launches,
            f"resumed run: kernel launches {launches} != the resumed stages' ops {want_launches}")
    diff = max_err(got.to("cuda"), want.to("cuda"))
    require(torch.equal(got, want), f"the resumed state differs from the uninterrupted run's "
                                    f"(max |difference| {diff})")
    require(not os.listdir(CHECKPOINT_DIR), "a finished run must delete its checkpoint")
    saves += [t for t in fresh.backend.trace if t["kind"] == "checkpoint"]
    loads = [t["seconds"] for t in fresh.backend.trace if t["kind"] == "resume"]
    log(f"  ising({n}) L={L} R={R}, {len(eng.cc.programs)} stages: uninterrupted offload run "
        f"{plain_s:.3f} s; checkpointed run killed in stage 1 at shard {S // 2} after "
        f"{kill_s:.3f} s; a fresh engine resumed at stage {start} in {resume_s:.3f} s (the "
        f"checkpoint read in {sum(loads):.3f} s); state equal to the uninterrupted run's bit "
        f"for bit; launches {launches}; each _save_state: "
        + ", ".join(f"stage {t['stage']} {gib(t['bytes'])} in {t['seconds']:.3f} s = "
                    f"{t['bytes'] / t['seconds'] / 1e9:.2f} GB/s" for t in saves) + f" ({card})")
    del want, got, plain, eng, fresh
    release_pinned()
    return {"launches": dict(launches, by_k=ops.fused_call_counts_by_k()), "plain_s": plain_s,
            "kill_s": kill_s, "resume_s": resume_s, "saves": [t["seconds"] for t in saves],
            "fidelity": fid, "worst": worst}


def grad_launches(eng, obs: str, per_op: int = 1) -> tuple:
    """The launches of one ``value_and_grad`` (or one fused ``grad_sweep``):
    the forward plan's ops times ``per_op`` (shards, offloaded), then one
    ``fused_apply`` per non-identity Pauli op, two per gate (``U†`` on ψ
    and on λ) and one per symbolic slot. Returns ``(by kind, fused by k)``."""
    from repro_torch.sim.measure import PauliSum

    want, by_k = {"fused": 0, "shm": 0}, {}

    def add(k, count):
        want["fused"] += count
        by_k[k] = by_k.get(k, 0) + count

    for prog in eng.cc.programs:
        for op in prog.ops:
            if op.kind == "fused":
                add(len(op.local_bits), per_op)
            elif op.kind == "shm":
                want["shm"] += per_op
    for t in PauliSum.coerce(obs).terms:
        for _ in t.ops:
            add(1, 1)
    for g in eng.circuit.gates:
        add(len(g.qubits), 2 + len(g.param_slots))
    return want, by_k


def check_grad_launches(ops, eng, obs: str, what: str, calls: int = 1, per_op: int = 1) -> dict:
    """The launches since the last reset are ``calls`` times those of one
    value_and_grad (:func:`grad_launches`), by kind and by width."""
    want, by_k = grad_launches(eng, obs, per_op)
    want = {k: calls * v for k, v in want.items()}
    by_k = {k: calls * v for k, v in by_k.items()}
    got, got_k = ops.kernel_call_counts(), ops.fused_call_counts_by_k()
    log(f"  {what}: kernel launches {got}, fused by k {got_k}; {calls} x (forward plan "
        f"{eng.op_counts()}" + (f" x {per_op} shards" if per_op > 1 else "")
        + f" + the reverse sweep of {len(eng.circuit.gates)} gates)")
    require(got == want and got_k == by_k,
            f"{what}: launches {got} by k {got_k} != forward + sweep {want} by k {by_k}")
    return dict(got, by_k=got_k)


def hold_sweep_sample(ops, ref, probe, eng, obs: str, x: torch.Tensor, fused: dict,
                      launches_by_k: dict, what: str) -> float:
    """A sample of the reverse sweep's ``fused_apply`` launches as the
    sweep makes them (one shard of 2^n, the bound circuit's tables): for
    the first gate with a parameter at k=1 and at k=2, its ``U†`` and its
    derivative, a gate without one, and a Pauli X; each against its plain
    version on ``x``. Then at k=1 and k=2 (where no row has them) the
    kernel timed beside its plain version and one torch.matmul, as rows of
    ``fused["by_k"]``. Returns the worst error."""
    from repro_torch.core import gates as G

    n = eng.n
    prog = eng.adjoint_program(obs)
    inv, d = prog.tensors(eng.bound_circuit)
    vidx = torch.zeros(1, dtype=torch.int32, device=x.device)
    sample, seen, slot = [], set(), 0
    for k, g in enumerate(eng.circuit.gates):
        key = (len(g.qubits), bool(g.param_slots))
        if key not in seen:
            seen.add(key)
            sample.append((f"U† of {g.name}{g.qubits}", inv[k], g.qubits))
            if g.param_slots:
                sample.append((f"dU of {g.name}{g.qubits}", d[slot], g.qubits))
        slot += len(g.param_slots)
    sample.append(("Pauli X0", G.X, (0,)))
    worst, by_width = 0.0, {}
    for label, mat, bits in sample:
        u = torch.from_numpy(np.ascontiguousarray(mat, dtype=np.complex64)).to(x.device)
        u = u.reshape(1, *mat.shape)
        err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, n),
                      ref.fused_apply_ref(x.clone(), u, vidx, bits, n))
        sync(x.device.type)
        require(err < ATOL, f"{what}: fused_apply on {label} disagrees with its plain version")
        log(f"  {what}: {label} k={len(bits)}: max |kernel - plain| = {err:.3e}")
        worst = max(worst, err)
        by_width.setdefault(len(bits), (u, bits, err))
    have = {row["k"] for row in fused["by_k"]}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for k in (1, 2):
            if k in have or k not in by_width:
                continue
            u, bits, err = by_width[k]
            ms = probe.time_ms(lambda: ops.fused_apply(x, u, vidx, bits, n))
            plain_ms = probe.time_ms(lambda: ref.fused_apply_ref(x, u, vidx, bits, n), reps=3)
            xt, ut = x.view(-1, 1 << k), u[0].transpose(0, 1).contiguous()
            matmul_ms = probe.time_ms(lambda: torch.matmul(xt, ut))
            cmacs = (1 << k) * (1 << n)
            row = entry("fused_apply", launches_by_k.get(k, 0), err, ms, plain_ms,
                        2 * (8 << n) + u.numel() * 8 + 4, TF32_PASSES * KARATSUBA_OPS * cmacs,
                        TF32_OPS_PER_S, 8 * cmacs, matmul_ms,
                        f"{what}: k={k} bits={list(bits)} V=1 n={n} (padded to I x U on 4 bits)")
            fused["by_k"].append(by_k_row(dict(row, k=k, path=what)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return worst


def vqe_phase(simulate, ops, ref, probe, card: str, fused: dict) -> dict:
    """The ``--vqe`` loop through the CLI (``VQE_PATH``): 1 + ``VQE_STEPS``
    value_and_grad calls, each launch counted; then at the first step's
    angles the value_and_grad split (forward, λ, sweep) and a trace, the
    gradient against the same sweep through the plain version on the same
    forward state, against central finite differences of the on-card
    energy (measured by the port's measurer, another algorithm) and
    against the complex128 oracle on the observable's light cone; a sample
    of the sweep's launches against the plain version."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.adjoint import AdjointProgram, adjoint_gradients_np
    from repro_torch.sim.measure import apply_pauli_sum, measurer_for

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    t0 = time.time()
    run = simulate.main(VQE_PATH)
    sync("cuda")
    cli_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    eng = run.engine
    calls = len(run.grad_seconds)
    require(calls == VQE_STEPS + 1 and len(run.energies) == calls
            and all(np.isfinite(run.energies)) and bool(np.all(np.isfinite(run.theta))),
            f"VQE: {VQE_STEPS + 1} finite energies and angles")
    launches = check_grad_launches(ops, eng, VQE_OBS, "VQE loop", calls=calls)
    log(f"  VQE energies {run.energies}; value_and_grad seconds {run.grad_seconds} (the first "
        f"builds the adjoint program); {run.seconds:.3f} s for {VQE_STEPS} steps = "
        f"{run.seconds / VQE_STEPS:.3f} "
        f"s/step; peak device memory {gib(peak)} against a {gib(8 << eng.n)} state; engine "
        f"built in {run.build_seconds:.3f} s; the CLI call {cli_s:.1f} s ({card})")

    theta0 = np.random.default_rng(VQE_SEED).uniform(0.0, 2 * np.pi, 2).astype(np.float32)
    sync("cuda")
    t0 = time.time()
    value, grads = eng.value_and_grad(VQE_OBS, params=theta0)
    total_s = time.time() - t0
    require(abs(value - run.energies[0]) <= 1e-6,
            f"VQE: value_and_grad at the first angles {value} != the CLI's {run.energies[0]}")
    t0 = time.time()
    psi = eng.run()
    sync("cuda")
    forward_s = time.time() - t0
    t0 = time.time()
    lam = apply_pauli_sum(psi.view(1, -1), VQE_OBS)
    sync("cuda")
    lam_s = time.time() - t0
    del lam
    log(f"  value_and_grad at the first angles: {total_s:.3f} s = forward {forward_s:.3f} s + "
        f"λ = H|ψ⟩ {lam_s:.3f} s + reverse sweep {total_s - forward_s - lam_s:.3f} s ({card})")
    plain = AdjointProgram(eng.circuit, VQE_OBS, device="cuda", use_kernels=False)
    t0 = time.time()
    pv, pg = plain.sweep_(psi.view(1, -1), *plain.tensors(eng.bound_circuit))
    plain_s = time.time() - t0
    del psi
    torch.cuda.empty_cache()
    pv, pg = float(pv[0]), pg[0]
    log(f"  against the plain version's sweep on the same state ({plain_s:.3f} s): value "
        f"{value:+.9f} vs {pv:+.9f}, gradient {grads} vs {pg}")
    require(abs(value - pv) <= VALUE_ATOL and np.abs(grads - pg).max() <= GRAD_ATOL,
            "VQE: the kernel sweep and the plain sweep disagree")
    t0 = time.time()
    ov, og = adjoint_gradients_np(PARAM_FAMILIES["isingparam"](LIGHT_CONE_N), theta0, VQE_OBS)
    log(f"  against the complex128 oracle at n={LIGHT_CONE_N} ({time.time() - t0:.1f} s): value "
        f"{ov:+.9f}, gradient {og}; differences {abs(value - ov):.3e}, "
        f"{np.abs(grads - og).max():.3e}")
    require(abs(value - ov) <= VALUE_ATOL and np.abs(grads - og).max() <= GRAD_ATOL,
            "VQE: the gradient disagrees with the complex128 oracle on the light cone")

    def energy(th):
        packed = eng.run_packed(params=th)
        return measurer_for(packed, eng.measurement_frame, eng).expectation(VQE_OBS)

    th = theta0.astype(np.float64)
    fd = np.array([(energy(th + FD_EPS * e) - energy(th - FD_EPS * e)) / (2 * FD_EPS)
                   for e in np.eye(len(th))])
    rel = float(np.abs(grads - fd).max() / np.abs(fd).max())
    log(f"  against central differences of the on-card energy (eps {FD_EPS}): {fd}; "
        f"max difference {rel:.3e} of the gradient's size (limit {FD_RTOL})")
    require(rel <= FD_RTOL, "VQE: the gradient disagrees with finite differences")
    eng.bind(theta0)

    trace_run(lambda: eng.value_and_grad(VQE_OBS), total_s, "value_and_grad")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(1 << eng.n, dtype=torch.complex64, device="cuda", generator=gen)
    worst = hold_sweep_sample(ops, ref, probe, eng, VQE_OBS, x, fused, launches["by_k"],
                              f"isingparam({eng.n}) reverse sweep")
    del x
    torch.cuda.empty_cache()
    return {"launches": launches, "worst": {"fused": worst, "shm": 0.0}, "peak": peak,
            "grad_seconds": run.grad_seconds, "split": [forward_s, lam_s, total_s],
            "n": eng.n}


def oracle_phase(ops, card: str, n: int, L: int, R: int, reps: int) -> dict:
    """``value_and_grad`` of ``su2param(n, reps)`` on the card against the
    complex128 adjoint oracle on the host, with its launches."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.adjoint import adjoint_gradients_np
    from repro_torch.sim.engine import engine_for

    sym = PARAM_FAMILIES["su2param"](n, reps=reps)
    t0 = time.time()
    eng = engine_for(sym, L, R, 0, device="cuda")
    build_s = time.time() - t0
    theta = np.random.default_rng(31).uniform(0.0, 2 * np.pi, len(sym.param_names))
    ops.reset_kernel_counters()
    t0 = time.time()
    value, grads = eng.value_and_grad(ORACLE_OBS, params=theta)
    card_s = time.time() - t0
    launches = check_grad_launches(ops, eng, ORACLE_OBS, f"su2param({n})")
    t0 = time.time()
    ov, og = adjoint_gradients_np(sym, theta, ORACLE_OBS)
    oracle_s = time.time() - t0
    dv, dg = abs(value - ov), float(np.abs(grads - og).max())
    log(f"  su2param({n}, reps={reps}) L={L} R={R}: {len(sym.gates)} gates, {len(theta)} "
        f"parameters; value_and_grad {card_s:.3f} s on the card (engine built in {build_s:.2f} "
        f"s), the complex128 oracle {oracle_s:.1f} s on the host; value {value:+.9f} vs "
        f"{ov:+.9f} ({dv:.3e}), gradient max difference {dg:.3e} ({card})")
    require(dv <= VALUE_ATOL and dg <= GRAD_ATOL,
            f"su2param({n}): value_and_grad disagrees with the complex128 oracle")
    return {"launches": launches, "seconds": card_s, "value_err": dv, "grad_err": dg}


def grad_sweep_phase(ops, card: str, n: int, L: int, R: int, P: int) -> dict:
    """``grad_sweep`` of P bindings of ``isingparam(n)`` on the in-card
    backend: one ``[P, 2^n]`` forward sweep and one reverse sweep, each
    application one launch for all P (a single point's count), each row
    against ``value_and_grad`` of that point alone."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.engine import engine_for

    eng = engine_for(PARAM_FAMILIES["isingparam"](n), L, R, 0, device="cuda")
    require(eng.backend.supports_fused_grad(), "the in-card backend must fuse grad_sweep")
    batch = np.random.default_rng(37).uniform(0.0, 2 * np.pi, (P, 2))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    t0 = time.time()
    vals, grads = eng.grad_sweep(batch, VQE_OBS)
    sweep_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = check_grad_launches(ops, eng, VQE_OBS, f"grad_sweep of {P}")
    worst, point_s = 0.0, 0.0
    for p in range(P):
        t0 = time.time()
        v, g = eng.value_and_grad(VQE_OBS, params=batch[p])
        point_s += time.time() - t0
        err = max(abs(vals[p] - v), float(np.abs(grads[p] - g).max()))
        require(err <= ROW_ATOL, f"grad_sweep row {p} differs from its point alone by {err}")
        worst = max(worst, err)
    log(f"  isingparam({n}) L={L} R={R}, P={P}: grad_sweep {sweep_s:.3f} s = {sweep_s / P:.3f} "
        f"s/point, value_and_grad point by point {point_s / P:.3f} s/point; rows against the "
        f"points alone: max difference {worst:.3e}; peak device memory {gib(peak)} ({card})")
    return {"launches": launches, "sweep_s": sweep_s, "point_s": point_s, "peak": peak,
            "err": worst}


def offload_grad_phase(ops, card: str, n: int, L: int, R: int) -> dict:
    """``value_and_grad`` through the offload backend (the forward state
    streamed through the card shard by shard, then uploaded for the sweep)
    against the in-card engine's."""
    from repro_torch.core.generators import PARAM_FAMILIES
    from repro_torch.sim.engine import engine_for

    sym = PARAM_FAMILIES["isingparam"](n)
    theta = np.random.default_rng(41).uniform(0.0, 2 * np.pi, 2)
    off = engine_for(sym, L, R, 0, backend="offload", device="cuda")
    require(not off.backend.supports_fused_grad(), "offload sweeps gradients point by point")
    ops.reset_kernel_counters()
    t0 = time.time()
    value, grads = off.value_and_grad(VQE_OBS, params=theta)
    off_s = time.time() - t0
    launches = check_grad_launches(ops, off, VQE_OBS, f"offload isingparam({n})",
                                   per_op=off.backend.S)
    in_card = engine_for(sym, L, R, 0, device="cuda")
    t0 = time.time()
    cv, cg = in_card.value_and_grad(VQE_OBS, params=theta)
    card_s = time.time() - t0
    err = max(abs(value - cv), float(np.abs(grads - cg).max()))
    log(f"  isingparam({n}) L={L} R={R}: offload value_and_grad {off_s:.3f} s, in-card "
        f"{card_s:.3f} s; max difference {err:.3e} ({card})")
    require(err <= GRAD_ATOL, f"offload value_and_grad differs from the in-card one by {err}")
    del off, in_card
    release_pinned()
    return {"launches": launches, "offload_s": off_s, "in_card_s": card_s, "err": err}


def plan_line(eng) -> str:
    """Stages, ``fused`` ops by width and ``shm`` ops of an engine's plan."""
    by_k = {}
    for prog in eng.cc.programs:
        for op in prog.ops:
            if op.kind == "fused":
                by_k[len(op.local_bits)] = by_k.get(len(op.local_bits), 0) + 1
    counts = eng.op_counts()
    return (f"{eng.plan.n_stages} stages, fused by k {dict(sorted(by_k.items()))}, "
            f"{counts.get('shm', 0)} shm, {counts.get('diag', 0)} diag")


def calibration_phase(ops, card: str) -> dict:
    """The profiler on the card: ``python -m repro_torch.sim.profiler --L
    28 --repeats 3 --verify`` through ``main(argv)``, into the smoke's own
    calibration directory. Every measured field positive and finite,
    printed beside the analytic constant it replaces; both hand kernels
    launched by the profile; ``--verify`` passed."""
    from repro_torch.core.cost_model import DEFAULT_COST_MODEL
    from repro_torch.sim import profiler

    ops.reset_kernel_counters()
    t0 = time.time()
    rc = profiler.main(["--L", str(CALIBRATION_L), "--repeats", str(CALIBRATION_REPEATS),
                        "--verify"])
    profile_s = time.time() - t0
    require(rc == 0, "profiler --verify: the engine under the calibrated model disagrees with "
                     "the dense oracle")
    launches = dict(ops.kernel_call_counts(), by_k=ops.fused_call_counts_by_k())
    require(launches["fused"] > 0 and launches["shm"] > 0,
            f"the profile must launch both hand kernels: {launches}")
    calib = profiler.load_calibration(profiler.default_calibration_path())
    meas, raw = calib["measurements"], calib["meta"]["raw"]
    require(calib["fingerprint"]["platform"] == "cuda" and calib["meta"]["L"] == CALIBRATION_L,
            f"calibration fingerprint {calib['fingerprint']}, L {calib['meta']['L']}")
    for field in sorted(meas):
        v = meas[field]
        require(math.isfinite(v) and v > 0, f"calibrated {field} = {v}")
        log(f"  {field:<18} {v:12.4f}  (analytic {getattr(DEFAULT_COST_MODEL, field):g}) ({card})")
    log("  raw: fused_apply us by k " + json.dumps({k: round(v, 1) for k, v in
                                                   raw["fusion"]["per_k_us"].items()})
        + f"; shm dense 1/5 members {raw['shm']['dense_us']}, diag {raw['shm']['diag_us']}; "
        f"pass {raw['pass']['elementwise_us']:.1f} us; link round trip "
        f"{raw['host_link']['roundtrip_us']:.0f} us; disk round trip "
        f"{raw['disk']['roundtrip_us'] / 1e6:.2f} s in {raw['disk']['dir']}")
    log(f"  profile + verify {profile_s:.1f} s (profile alone {calib['meta']['profile_time_s']:.1f}"
        f" s); launches {launches}")
    return {"launches": launches, "measurements": meas, "seconds": profile_s}


def calibrated_phase(ops, ref, probe, card: str, name: str, fused: dict) -> dict:
    """``name(n)`` (``CALIBRATED``) planned under the resolved calibration
    (``engine_for`` with no cost model) and under the analytic constants:
    each plan's stages, ``fused`` widths and ``shm`` ops and its warm run
    seconds, both states against the dense per-gate oracle on the card,
    launches equal to the plan; the calibrated engine's kernel ops against
    their plain versions."""
    import scipy

    from repro_torch.core.cost_model import DEFAULT_COST_MODEL
    from repro_torch.core.generators import FAMILIES
    from repro_torch.sim import profiler
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    n, L, R = CALIBRATED["n"], CALIBRATED["L"], CALIBRATED["R"]
    circ = FAMILIES[name](n)
    t0 = time.time()
    oracle = dense_simulate(circ, device="cuda")
    oracle_s = time.time() - t0
    out, launches = {}, {}
    for label, cm in (("calibrated", None), ("analytic", DEFAULT_COST_MODEL)):
        t0 = time.time()
        eng = engine_for(circ, L, R, 0, cost_model=cm, cache=None, device="cuda")
        build_s = time.time() - t0
        if cm is None:
            src = eng.provenance["calibration"]
            require(src["source"] == "calibrated", f"{name}({n}) planned on {src}")
        eng.run()  # warm: index tensors, step tables
        ops.reset_kernel_counters()
        torch.cuda.synchronize()
        t0 = time.time()
        state = eng.run()
        torch.cuda.synchronize()
        run_s = time.time() - t0
        launches[label] = launches_match(ops, eng, f"{label} {name}({n})", kinds=())
        require(launches[label]["fused"] + launches[label]["shm"] > 0,
                f"{label} {name}({n}) launched no kernel")
        fid = fidelity(state, oracle)
        del state
        require(fid >= FIDELITY_MIN, f"{label} {name}({n}) fidelity {fid} < {FIDELITY_MIN}")
        log(f"  {label:<10} {name}({n}) L={L} R={R}: {plan_line(eng)}; planned and built in "
            f"{build_s:.2f} s; run {run_s:.4f} s; fidelity {fid:.9f} (host scipy "
            f"{scipy.__version__}; {card})")
        out[label] = {"run_s": run_s, "build_s": build_s, "fidelity": fid,
                      "plan": plan_line(eng), "engine": eng}
    log(f"  dense oracle {oracle_s:.1f} s; calibrated run / analytic run = "
        f"{out['calibrated']['run_s'] / out['analytic']['run_s']:.3f}")
    del oracle
    torch.cuda.empty_cache()
    eng = out["calibrated"]["engine"]
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(1 << n, dtype=torch.complex64, device="cuda", generator=gen)
    worst = hold_ops(ops, ref, eng, eng.backend.pass_of(), x, f"calibrated {name}({n})")
    rows = fused_by_k(ops, ref, probe, eng, x, f"calibrated {name}({n})",
                      launches["calibrated"]["by_k"], skip=[r["k"] for r in fused["by_k"]])
    fused["by_k"] += [by_k_row(row) for row in rows]
    del x, eng
    for v in out.values():
        v.pop("engine")
    torch.cuda.empty_cache()
    return {"launches": launches["calibrated"], "analytic_launches": launches["analytic"],
            "worst": worst, "runs": out}


def autotune_phase(simulate, ops, ref, card: str) -> dict:
    """``--autotune`` on ``ising(27)`` L=25 R=2 (``AUTOTUNE``) through the CLI: every
    candidate's replay, the choice and its speedup, the tuning's peak device
    memory; then ``engine_for`` with default knobs is a cache hit that runs
    no solver, and the tuned run holds against the dense oracle."""
    from repro_torch.core import kernelization, staging
    from repro_torch.core.generators import FAMILIES
    from repro_torch.sim.engine import DEFAULT_CACHE, engine_for
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_kernel_counters()
    t0 = time.time()
    run = simulate.main(AUTOTUNE_PATH)
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = dict(ops.kernel_call_counts(), by_k=ops.fused_call_counts_by_k())
    tuned = run.engine.provenance["autotune"]
    for cand, us in sorted(tuned["replay_us"].items(), key=lambda kv: kv[1]):
        log(f"  candidate {cand:<18} replay {us:12.1f} us")
    log(f"  chose '{tuned['chosen']}' ({tuned['speedup_vs_default']:.3f}x vs default, "
        f"{len(tuned['replay_us'])} candidates, tuning {tuned['tune_time_s']:.1f} s, the CLI "
        f"{cli_s:.1f} s); peak device memory of the tuning {gib(peak)}; launches {launches}; "
        f"tuned plan {plan_line(run.engine)} ({card})")
    require(peak <= 2.25 * (8 << AUTOTUNE["n"]),
            f"the tuning's peak {gib(peak)} is more than one run's two states")
    solves = (dict(staging.SOLVER_CALLS), dict(kernelization.SOLVER_CALLS))
    hits = DEFAULT_CACHE.hits
    again = engine_for(FAMILIES["ising"](AUTOTUNE["n"]), AUTOTUNE["L"], AUTOTUNE["R"], 0,
                       device="cuda")
    require(again is run.engine and DEFAULT_CACHE.hits == hits + 1,
            "engine_for with default knobs must hit the tuned engine")
    require((dict(staging.SOLVER_CALLS), dict(kernelization.SOLVER_CALLS)) == solves,
            "the tuned cache hit must run no ILP or DP solver")
    fid = fidelity(run.state, dense_simulate(again.circuit, device="cuda"))
    require(fid >= FIDELITY_MIN, f"tuned ising fidelity {fid} < {FIDELITY_MIN}")
    log(f"  engine_for(default knobs): cache hit on the tuned engine, no solver call; "
        f"fidelity {fid:.9f}")
    run.state = None
    worst = {"fused": 0.0, "shm": 0.0}
    if tuned["chosen"] != "default":  # the default is the calibrated plan, held above
        gen = torch.Generator(device="cuda").manual_seed(23)
        x = torch.randn(1 << again.n, dtype=torch.complex64, device="cuda", generator=gen)
        worst = hold_ops(ops, ref, again, again.backend.pass_of(), x, "tuned ising(30)")
        del x
    torch.cuda.empty_cache()
    return {"launches": launches, "chosen": tuned["chosen"], "peak_bytes": peak,
            "speedup": tuned["speedup_vs_default"], "replay_us": tuned["replay_us"],
            "fidelity": fid, "worst": worst}


def _built_engines():
    """Record the (backend, use_kernels) of every engine construction while
    the context is open."""
    from repro_torch.sim import engine as teng

    class Recorder:
        def __enter__(self):
            self.seen, self.real = [], teng.ExecutionEngine.__init__
            real, seen = self.real, self.seen

            def init(eng, circuit, plan, use_kernels=True, device=None, **kw):
                be = kw.get("backend", "cuda")
                seen.append((be if isinstance(be, str) else be.name, use_kernels))
                real(eng, circuit, plan, use_kernels, device, **kw)

            teng.ExecutionEngine.__init__ = init
            return self

        def __exit__(self, *exc):
            teng.ExecutionEngine.__init__ = self.real

    return Recorder()


def launches_since(ops, before: dict) -> dict:
    """The kernel launches, by kernel, since the counts ``before``."""
    return {k: v - before[k] for k, v in ops.kernel_call_counts().items()}


def faults_phase(ops, card: str) -> dict:
    """The integrity guard and the build faults at n=28: clean guarded
    ``run`` and ``run_packed`` (no retry; the guard's seconds); a NaN
    injected into each, recovered by one re-run of the plan through the
    hand kernels (twice a clean run's launches) to the clean state; a
    guarded sweep of 4 ``isingparam(28)`` bindings with one poisoned row,
    only that row re-run; ``xla_trace_error`` at
    ``cuda.setup`` and ``pallas_lowering_error`` at ``engine.init`` raise
    their typed errors out of ``engine_for`` with no other engine built."""
    import random

    from repro_torch.core.generators import FAMILIES, PARAM_FAMILIES
    from repro_torch.sim import faults
    from repro_torch.sim.engine import engine_for
    from repro_torch.sim.faults import PallasLoweringError, XlaTraceError
    from repro_torch.sim.statevector import fidelity

    n, L, R = FAULTS["n"], FAULTS["L"], FAULTS["R"]
    ops.reset_kernel_counters()
    eng = engine_for(FAMILIES["ising"](n), L, R, 0, cache=None, device="cuda")
    report = {}
    for entry in ("run", "run_packed"):
        fn = getattr(eng, entry)
        fn(verify=True)  # warm: the run's and the guard's buffers
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        before = ops.kernel_call_counts()
        t0 = time.time()
        clean = fn(verify=True)
        torch.cuda.synchronize()
        guarded_s = time.time() - t0
        per_run = launches_since(ops, before)
        require("integrity_retries" not in eng.provenance,
                f"a clean guarded {entry} recorded a retry")
        t0 = time.time()
        eng._norm_of(clean)
        torch.cuda.synchronize()
        norm_s = time.time() - t0
        before = ops.kernel_call_counts()
        t0 = time.time()
        with faults.inject(faults.FaultPlan(seed=3).add("nan_amplitudes", count=1)) as plan:
            out = fn(verify=True)
        torch.cuda.synchronize()
        retry_s = time.time() - t0
        require(plan.fires == {"nan_amplitudes": 1}, f"{entry}: the fault fired {plan.fires}")
        retried = launches_since(ops, before)
        require(sum(per_run.values()) > 0
                and retried == {k: 2 * v for k, v in per_run.items()},
                f"{entry}: the retry must re-run the plan through the kernels "
                f"(a clean run {per_run}, with the retry {retried})")
        prov = eng.provenance
        require(prov.pop("integrity_retries") == prov.pop("integrity_recovered") == 1,
                f"{entry}: one retry, recovered")
        fid = fidelity(out, clean)
        require(fid >= FIDELITY_MIN, f"recovered {entry} fidelity {fid} < {FIDELITY_MIN}")
        same = torch.equal(out, clean)
        log(f"  {entry}(verify=True) ising({n}) L={L} R={R}: clean {guarded_s:.4f} s against "
            f"{plain_s:.4f} s unguarded (the norm pass {norm_s * 1e3:.2f} ms), no retry; NaN "
            f"injected: one re-run through the kernels ({retried} launches), {retry_s:.3f} s, "
            f"fidelity to the clean run {fid:.9f}, bit for bit {same} ({card})")
        report[entry] = {"guarded_s": guarded_s, "plain_s": plain_s, "norm_s": norm_s,
                         "retry_s": retry_s,
                         "fidelity": fid, "bit_for_bit": same}
        del clean, out
    del eng
    torch.cuda.empty_cache()

    P = FAULTS["P"]
    sym = PARAM_FAMILIES["isingparam"](n)
    swp = engine_for(sym, L, R, 0, cache=None, device="cuda")
    rng = np.random.default_rng(29)
    points = [{"J": float(j), "h": float(h)} for j, h in rng.uniform(-1.5, 1.5, size=(P, 2))]
    before = ops.kernel_call_counts()
    clean = swp.run_sweep(None, points)
    per_sweep = launches_since(ops, before)
    seed = 5
    row = random.Random(seed).randrange(P)  # the plan's first draw: the row it poisons
    before = ops.kernel_call_counts()
    t0 = time.time()
    with faults.inject(faults.FaultPlan(seed=seed).add("nan_amplitudes", count=1,
                                                       site="engine.run_sweep")):
        out = swp.run_sweep(None, points, verify=True)
    torch.cuda.synchronize()
    sweep_s = time.time() - t0
    retried = launches_since(ops, before)
    require(swp.bound_circuit is None, "the row's retry must leave the engine unbound")
    swp.bind(points[row])
    before = ops.kernel_call_counts()
    swp.run()
    per_run = launches_since(ops, before)
    require(sum(per_run.values()) > 0
            and retried == {k: per_sweep[k] + per_run[k] for k in per_sweep},
            f"the poisoned row must be re-run through the kernels (a clean sweep {per_sweep}, "
            f"one run {per_run}, the sweep with its retry {retried})")
    require(swp.provenance["integrity_retries"] == swp.provenance["integrity_recovered"] == 1,
            "the sweep must retry one row")
    fids = [fidelity(out[p], clean[p]) for p in range(P)]
    require(min(fids) >= FIDELITY_MIN, f"sweep rows against the clean sweep: {fids}")
    require(all(torch.equal(out[p], clean[p]) for p in range(P) if p != row),
            "the clean rows must come through untouched")
    log(f"  run_sweep(verify=True) of {P} isingparam({n}) bindings, row {row} poisoned: that row "
        f"alone re-run through the kernels ({retried} launches with the sweep's); "
        f"{sweep_s:.3f} s; the row bit for bit {torch.equal(out[row], clean[row])}; row "
        f"fidelities to the clean sweep "
        f"{[round(f, 9) for f in fids]}")
    report["sweep"] = {"seconds": sweep_s, "row": row, "fidelity": fids}
    del clean, out, swp
    torch.cuda.empty_cache()

    small = FAMILIES["ising"](n)
    for point, site, error in (("xla_trace_error", "cuda.setup", XlaTraceError),
                               ("pallas_lowering_error", "engine.init", PallasLoweringError)):
        with _built_engines() as rec, faults.inject(
                faults.FaultPlan(seed=2).add(point, site=site)) as plan:
            try:
                engine_for(small, L, R, 0, cache=None, device="cuda")
            except error as e:
                raised = e
            else:
                raised = None
        require(raised is not None and raised.injected, f"{point} at {site} must raise "
                                                         f"{error.__name__}")
        require(rec.seen == [("cuda", True)] and plan.fires == {point: 1},
                f"{point}: engines built {rec.seen}, fires {plan.fires}")
        log(f"  {point} at {site}: {type(raised).__name__} out of engine_for; engines "
            f"attempted {rec.seen} (no other backend, no plain versions)")
    launches = dict(ops.kernel_call_counts(), by_k=ops.fused_call_counts_by_k())
    log(f"  launches of the faults phase {launches}")
    report["launches"] = launches
    return report


def spy_engine(ops, eng, stride: int) -> list:
    """Record every ``run``, ``run_packed`` and ``run_sweep`` of ``eng`` (as
    instance attributes over the class's methods; :func:`unspy` removes
    them): the entry, its points, the kernel launches of the call, its stage
    loop's seconds (the engine's own timing, to the device's last op) and
    every ``stride``-th amplitude of each output row, on the host."""
    calls = []
    for entry in ("run", "run_packed", "run_sweep"):
        def spy(*a, _real=getattr(type(eng), entry), _entry=entry, **kw):
            before = ops.kernel_call_counts()
            out = _real(eng, *a, **kw)
            launched = launches_since(ops, before)
            rows = out.reshape(-1, 1 << eng.n)
            calls.append({"entry": _entry, "points": a[1] if _entry == "run_sweep" else None,
                          "rows": rows.shape[0], "launches": launched,
                          "loop_s": eng.timings[_entry]["last_us"] / 1e6,
                          "sample": rows[:, ::stride].cpu()})
            return out
        setattr(eng, entry, spy)
    return calls


def unspy(eng) -> None:
    for entry in ("run", "run_packed", "run_sweep"):
        eng.__dict__.pop(entry, None)


def serve_phase(ops, ref, card: str, device: str = "cuda") -> dict:
    """The port's simulation service on the card (``repro_torch.serve``, the
    entry points ``python -m repro_torch.launch.serve_sim`` drives): one
    ``SimulationService`` with its defaults (CUDA, the hand kernels), two
    weighted tenants, planned on the card's calibration.

    One warm-up request per structure (cold builds), then one burst of 44
    requests: every response a cache hit with no solver call and no shm
    program scheduled, each batch one launch per compiled op whatever its
    rows, the qft dedup group one run; every response held against the same
    binding run alone on the same engine (expectations, marginals and counts;
    every STRIDE-th amplitude of each served row) and the first point of
    each structure against the dense per-gate oracle; every kernel op of a
    served ``isingparam`` batch against its plain version. Then the faults (a
    malformed rider alone, a NaN recovered by one re-run through the
    kernels, a kernel build failure quarantined), the JSON-lines front end
    on the loopback, and each structure's warm run planned on the
    calibration against the analytic constants."""
    import asyncio

    from repro_torch.core import kernelization, staging
    from repro_torch.core.cost_model import DEFAULT_COST_MODEL
    from repro_torch.core.generators import FAMILIES, PARAM_FAMILIES
    from repro_torch.launch.serve_sim import handle_client
    from repro_torch.serve import ServeConfig, SimRequest, SimulationService
    from repro_torch.serve.service import WarmPool
    from repro_torch.sim import faults
    from repro_torch.sim.engine import circuit_key_for, engine_for
    from repro_torch.sim.faults import CircuitQuarantined, PallasLoweringError
    from repro_torch.sim.measure import measure_to_result, measurer_for
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    n, L, R, stride = SERVE["n"], SERVE["L"], SERVE["R"], SERVE["stride"]
    mn, mL = SERVE["main_n"], SERVE["main_L"]
    syms = {"isingparam": PARAM_FAMILIES["isingparam"](n),
            "su2param": PARAM_FAMILIES["su2param"](n, reps=SERVE["su2param_reps"])}
    concrete = {"qft": (FAMILIES["qft"](n), L), "ising": (FAMILIES["ising"](mn), mL)}
    rng = np.random.default_rng(SERVE["seed"])

    def point(name):
        lo, hi = (-1.5, 1.5) if name == "isingparam" else (0.1, 6.2)
        return rng.uniform(lo, hi, len(syms[name].param_names))

    def param_request(i, name, params=None, tenant=None):
        shots = SERVE["shots"] if i in SERVE["shot_requests"] else 0
        return SimRequest(circuit=syms[name], params=point(name) if params is None else params,
                          tenant=tenant or ("gold", "free")[(i // 2) % 2], shots=shots,
                          marginals=((0, 1),) if shots else (), observables=(SERVE_OBS,),
                          seed=i, L=L, R=R)

    def concrete_request(name, tenant):
        circ, cl = concrete[name]
        return SimRequest(circuit=circ, tenant=tenant, L=cl, R=R,
                          observables=(SERVE_OBS,) if name == "ising" else ())

    svc = SimulationService(ServeConfig(**SERVE_CONFIG) if device == "cuda"
                            else ServeConfig(**SERVE_CONFIG, device=device))
    require(svc.pool.device.type == device and svc.cfg.use_kernels,
            "the service must default to the card and the hand kernels")
    structures = ["isingparam", "su2param", "qft", "ising"]

    def ckey(name):
        circ, cl = (syms[name], L) if name in syms else concrete[name]
        return circuit_key_for(circ, cl, R, 0, device=svc.pool.device)

    async def warm_and_burst():
        async with svc:
            cold = {}
            for i, name in enumerate(structures):
                req = (param_request(-1, name, tenant="gold") if name in syms
                       else concrete_request(name, "gold"))
                t0 = time.time()
                resp = await svc.submit(req)
                cold[name] = (time.time() - t0, resp.timings["bind_s"])
            engines = {name: svc.pool.cache.peek(key) for name, key in zip(
                structures, [ckey(s) for s in structures])}
            spies = {name: spy_engine(ops, eng, stride) for name, eng in engines.items()}
            reqs = [param_request(i, ("isingparam", "su2param")[i % 2])
                    for i in range(SERVE["requests"])]
            reqs += [concrete_request("qft", ("gold", "free")[i % 2]) for i in range(SERVE["qft"])]
            reqs.append(concrete_request("ising", "gold"))
            raw = {}
            real_observe = svc.metrics.observe

            def observe(name, value):
                raw.setdefault(name, []).append(value)
                real_observe(name, value)

            before = (staging.SOLVER_CALLS["ilp"], staging.SOLVER_CALLS["greedy"],
                      kernelization.SOLVER_CALLS["dp"], WarmPool.shm_schedules(),
                      svc.metrics.counter("cache_misses"), svc.metrics.counter("sweep_rows"),
                      svc.metrics.counter("sweep_rows_padding"))
            svc.metrics.observe = observe
            sync(device)
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            ops.reset_kernel_counters()
            t0 = time.time()
            resps = await asyncio.gather(*[svc.submit_nowait(r) for r in reqs],
                                         return_exceptions=True)
            sync(device)
            wall = time.time() - t0
            launches = dict(ops.kernel_call_counts(), by_k=ops.fused_call_counts_by_k())
            peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
            del svc.metrics.observe
            after = (staging.SOLVER_CALLS["ilp"], staging.SOLVER_CALLS["greedy"],
                     kernelization.SOLVER_CALLS["dp"], WarmPool.shm_schedules(),
                     svc.metrics.counter("cache_misses"), svc.metrics.counter("sweep_rows"),
                     svc.metrics.counter("sweep_rows_padding"))
            for eng in engines.values():
                unspy(eng)
            return cold, engines, spies, reqs, resps, raw, before, after, wall, launches, peak

    (cold, engines, spies, reqs, resps, raw, before, after, wall, launches,
     peak) = asyncio.run(warm_and_burst())
    stats = svc.stats()
    log(f"  calibration the service plans on: {json.dumps(stats['calibration'])}")
    require(device != "cuda" or stats["calibration"]["source"] == "calibrated",
            f"the serve phase must plan on the card's calibration: {stats['calibration']}")
    for name in structures:
        log(f"  cold {name}: first request {cold[name][0]:.3f} s (bind_s {cold[name][1]:.3f} s: "
            f"plan and build); plan {plan_line(engines[name])}")
    failed = [(i, r) for i, r in enumerate(resps) if isinstance(r, Exception)]
    require(not failed, f"served requests failed: {failed[:3]}")
    require(all(r.cache_hit for r in resps), "every warm request must be a cache hit")
    require(after[:3] == before[:3], f"warm serving ran a solver: {before[:3]} -> {after[:3]}")
    require(after[3] == before[3], f"warm serving scheduled shm programs: {before[3]} -> {after[3]}")
    require(after[4] == before[4], "warm serving missed the cache")
    require(launches["fused"] > 0 and launches["shm"] > 0,
            f"the served burst must launch both kernels: {launches}")
    batches = []
    for name, calls in spies.items():
        counts = engines[name].op_counts()
        want = {"fused": counts.get("fused", 0), "shm": counts.get("shm", 0)}
        for c in calls:
            require(c["launches"] == want, f"{name}: a batch of {c['rows']} rows launched "
                                           f"{c['launches']}, the plan has {want} ops")
            batches.append((name, c["entry"], c["rows"], c["launches"], c["loop_s"]))
    require(sum(b[3]["fused"] for b in batches) == launches["fused"]
            and sum(b[3]["shm"] for b in batches) == launches["shm"],
            "every launch of the burst must come from a served batch")
    qft_calls = spies["qft"]
    qft_resps = [r for req, r in zip(reqs, resps) if req.circuit is concrete["qft"][0]]
    require(len(qft_calls) == 1 and qft_calls[0]["entry"] == "run"
            and all(r.batch_size == SERVE["qft"] for r in qft_resps)
            and len({r.amp0 for r in qft_resps}) == 1,
            f"the {SERVE['qft']} identical qft requests must dedup into one run")
    rows = after[5] - before[5]
    padding = after[6] - before[6]
    sizes = raw["batch_size"]
    e2e = [r.timings["e2e_s"] for r in resps]
    log(f"  burst of {len(reqs)} requests in {wall:.3f} s = {len(reqs) / wall:.3f} requests/s; "
        f"e2e p50 {np.percentile(e2e, 50):.6f} s, p99 {np.percentile(e2e, 99):.6f} s; stage p50s: "
        + ", ".join(f"{k} {np.percentile([r.timings[k] for r in resps], 50):.6f} s"
                    for k in ("queue_wait_s", "batch_form_s", "bind_s", "execute_s"))
        + f", measure_s {np.percentile(raw['measure_s'], 50):.6f} s (per batch); "
        f"{len(sizes)} batches, coalesce factor {sum(sizes) / len(sizes):.4f}; rows run "
        f"{rows:.0f} for {rows - padding:.0f} requested rows (padded-row share "
        f"{padding / max(rows, 1):.4f}); peak device memory {gib(peak)} ({card})")
    loops = sum(c["loop_s"] for calls in spies.values() for c in calls)
    log("  batches (structure, entry, rows, launches, stage loop s): "
        + "; ".join(f"{b[0]} {b[1]} {b[2]} {b[3]} {b[4]:.4f}" for b in batches)
        + f"; stage loops {loops:.3f} s of the burst's {wall:.3f} s: the device idle at least "
        f"{1 - loops / wall:.4f} of it")
    log(f"  no solver call, no shm program scheduled ({after[3]} in the process), no cache "
        f"miss; launches of the burst {launches}")

    # every response against the same binding run alone on the same engine
    t0 = time.time()
    worst_amp, worst_exp, bitwise = 0.0, 0.0, True
    for req, resp in zip(reqs, resps):
        name = next(k for k, s in syms.items() if s is req.circuit) if req.params is not None \
            else ("qft" if req.circuit is concrete["qft"][0] else "ising")
        eng = engines[name]
        if req.params is not None:
            pt = dict(zip(eng.param_names, np.asarray(req.params, dtype=np.float64)))
            call, row = next((c, i) for c in spies[name] if c["points"] is not None
                             for i, p in enumerate(c["points"]) if p == pt)
            alone = eng.run_packed(params=pt)
        else:
            call, row = spies[name][0], 0
            alone = eng.run() if req.wants_state else eng.run_packed()
        got, want = call["sample"][row], alone.reshape(-1)[::stride].cpu()
        err = max_err(got, want)
        bitwise = bitwise and torch.equal(got, want)
        worst_amp = max(worst_amp, err)
        require(err < SERVE_ATOL, f"{name} request {req.request_id}: served amplitudes differ "
                                  f"from the run alone by {err}")
        if req.wants_state:
            require(abs(resp.amp0 - complex(alone.reshape(-1)[0].item())) < SERVE_ATOL,
                    f"{name}: amp0 differs from the run alone")
        else:
            want_res = measure_to_result(
                measurer_for(alone, eng.measurement_frame, eng), backend="cuda",
                shots=req.shots, seed=req.seed, marginals=req.marginals,
                observables=req.observables)
            for k, v in want_res.expectations.items():
                e = abs(resp.result.expectations[k] - v)
                worst_exp = max(worst_exp, e)
                require(e < SERVE_ATOL, f"{name}: <{k}> differs from the run alone by {e}")
            for q, m in want_res.marginals.items():
                require(float(np.abs(resp.result.marginals[q] - m).max()) < SERVE_ATOL,
                        f"{name}: marginal {q} differs from the run alone")
            if req.shots:
                require(resp.result.counts() == want_res.counts(),
                        f"{name}: the served shots differ from the run alone's")
        del alone
    log(f"  every response against its binding run alone on the same engine ({time.time() - t0:.1f}"
        f" s): every {stride}th amplitude of each row max |diff| {worst_amp:.3e} (bit for bit "
        f"{bitwise}), expectations max |diff| {worst_exp:.3e}, marginals within {SERVE_ATOL}, the "
        f"{len(SERVE['shot_requests'])} shot requests' counts equal")

    # the first point of each structure against the dense per-gate oracle
    t0 = time.time()
    fids = {}
    for name in structures:
        eng = engines[name]
        if name in syms:
            first = next(r for r in reqs if r.circuit is syms[name])
            bound = syms[name].bind(dict(zip(eng.param_names, first.params)))
            state = eng.run(params=dict(zip(eng.param_names, first.params)))
        else:
            bound = concrete[name][0]
            state = eng.run()
        fids[name] = fidelity(state, dense_simulate(bound, device=device))
        del state
        require(fids[name] >= FIDELITY_MIN, f"served {name} fidelity {fids[name]}")
    log("  first point of each structure against the dense oracle on the " + device + ": "
        + ", ".join(f"{k} {v:.9f}" for k, v in fids.items()) + f" ({time.time() - t0:.1f} s)")

    # every kernel op of one served batch against its plain version
    eng = engines["isingparam"]
    call = max(spies["isingparam"], key=lambda c: c["rows"])
    worst = hold_sweep_ops(ops, ref, eng, eng.backend.pass_of(call["rows"],
                                                             eng.sweep_tables(call["points"])),
                           seed=43, what=f"served isingparam({n}) batch of {call['rows']}")
    del spies

    # faults and the front end, on the same warm service
    async def faults_and_front_end():
        async with svc:
            good = [param_request(100 + i, "isingparam", tenant="free") for i in range(3)]
            bad = param_request(103, "isingparam", params=np.array([0.1, 0.2, 0.3]))
            got = await asyncio.gather(*[svc.submit_nowait(r) for r in good + [bad]],
                                       return_exceptions=True)
            require(all(not isinstance(g, Exception) and g.batch_size == 4 for g in got[:3])
                    and isinstance(got[3], ValueError),
                    f"a malformed rider must fail alone: {[type(g).__name__ for g in got]}")
            eng = engines["isingparam"]
            counts = eng.op_counts()
            per_run = {"fused": counts.get("fused", 0), "shm": counts.get("shm", 0)}
            nan_reqs = [param_request(110 + i, "isingparam") for i in range(4)]
            before = ops.kernel_call_counts()
            with faults.inject(faults.FaultPlan(seed=5).add(
                    "nan_amplitudes", count=1, site="engine.run_sweep")) as plan:
                nan_resps = await asyncio.gather(*[svc.submit_nowait(r) for r in nan_reqs])
            retried = launches_since(ops, before)
            require(plan.fires == {"nan_amplitudes": 1}, f"the NaN fired {plan.fires}")
            require(retried == {k: 2 * v for k, v in per_run.items()},
                    f"the poisoned row must be re-run once through the kernels: {retried}, "
                    f"a batch launches {per_run}")
            require(all(r.provenance and r.provenance["integrity_retries"] == 1
                        and r.provenance["integrity_recovered"] == 1 for r in nan_resps),
                    "integrity_retries must be in every response's provenance")
            worst_nan = 0.0
            for req, resp in zip(nan_reqs, nan_resps):
                alone = eng.run_packed(params=dict(zip(eng.param_names, req.params)))
                want = measurer_for(alone, eng.measurement_frame, eng).expectation(SERVE_OBS)
                worst_nan = max(worst_nan, abs(next(iter(resp.result.expectations.values()))
                                               - want))
                del alone
            require(worst_nan < SERVE_ATOL, f"the recovered batch differs by {worst_nan}")
            for key in ("integrity_retries", "integrity_recovered"):
                eng.provenance.pop(key)
            log(f"  a rider with 3 parameters in a batch of 4 failed alone (ValueError); a NaN "
                f"in one row of a served batch of 4 recovered by one re-run through the kernels "
                f"({retried} launches with the batch's), expectations within {worst_nan:.3e} "
                f"of the runs alone, integrity_retries 1 in each response's provenance")
            ghz = FAMILIES["ghz"](n)
            seen = []
            with _built_engines() as rec, faults.inject(faults.FaultPlan(seed=2).add(
                    "pallas_lowering_error", site="engine.init")) as plan:
                for _ in range(svc.cfg.breaker_threshold):
                    try:
                        await svc.submit(SimRequest(circuit=ghz, L=L, R=R))
                    except PallasLoweringError as e:
                        seen.append(e)
                try:
                    await svc.submit(SimRequest(circuit=ghz, L=L, R=R))
                    quarantined = None
                except CircuitQuarantined as e:
                    quarantined = e
            require(len(seen) == svc.cfg.breaker_threshold and all(e.injected for e in seen),
                    "each build must fail typed (PallasLoweringError)")
            require(quarantined is not None and quarantined.retry_after > 0,
                    "the structure must be quarantined with a retry_after")
            require(rec.seen == [("cuda", True)] * svc.cfg.breaker_threshold,
                    f"engines attempted {rec.seen}: no plain versions, no other backend")
            log(f"  pallas_lowering_error at engine.init x{len(seen)}: PallasLoweringError each "
                f"time, then CircuitQuarantined (retry_after {quarantined.retry_after:.1f} s); "
                f"engines attempted {rec.seen}")

            server = await asyncio.start_server(lambda r, w: handle_client(svc, r, w),
                                                "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                valid = param_request(120, "isingparam", tenant="gold")
                lines = [json.dumps({"id": 1, "family": "isingparam", "n": n, "L": L, "R": R,
                                     "params": list(map(float, valid.params)),
                                     "observables": [SERVE_OBS], "tenant": "gold"}),
                         "{not json", json.dumps({"cmd": "stats"})]
                writer.write(("\n".join(lines) + "\n").encode())
                await writer.drain()
                replies = [json.loads(await asyncio.wait_for(reader.readline(), 120))
                           for _ in lines]
                writer.close()
            finally:
                server.close()
                await server.wait_closed()
            answer = next(r for r in replies if r.get("rid") == 1)
            malformed = next(r for r in replies if r.get("error") == "bad_json")
            snap = next(r for r in replies if "stats" in r)
            require(answer["ok"] and answer["batch_size"] == 1 and answer["cache_hit"],
                    f"the valid line: {answer}")
            alone = eng.run_packed(params=dict(zip(eng.param_names, valid.params)))
            want = measurer_for(alone, eng.measurement_frame, eng).expectation(SERVE_OBS)
            del alone
            require(abs(next(iter(answer["expectations"].values())) - want) < SERVE_ATOL,
                    "the front end's expectation differs from the run alone")
            require(not malformed["ok"] and malformed["rid"] is None and snap["ok"]
                    and snap["stats"]["warm_pool"]["size"] == 4,
                    f"the malformed line and stats: {malformed}, {snap.get('ok')}")
            log(f"  front end on 127.0.0.1:{port}: the valid line answered (expectation "
                f"{next(iter(answer['expectations'].values())):.6f}, as the run alone), the "
                f"malformed line {malformed['error']}, stats answered "
                f"(warm pool {snap['stats']['warm_pool']['size']} engines)")

    asyncio.run(faults_and_front_end())

    # each served structure's warm run under the calibration and the analytic constants
    runs = {}
    for name in structures:
        eng = engines[name]
        circ, cl = (syms[name], L) if name in syms else concrete[name]
        pt = None
        if name in syms:
            first = next(r for r in reqs if r.circuit is syms[name])
            pt = dict(zip(eng.param_names, first.params))
        t0 = time.time()
        ana = engine_for(circ, cl, R, 0, cost_model=DEFAULT_COST_MODEL, cache=None,
                         device=device)
        build_s = time.time() - t0
        out = {}
        for label, e in (("calibrated", eng), ("analytic", ana)):
            e.run(params=pt)  # warm
            sync(device)
            t0 = time.time()
            state = e.run(params=pt)
            sync(device)
            out[label] = (time.time() - t0, state, plan_line(e))
        fid = fidelity(out["calibrated"][1], out["analytic"][1])
        require(fid >= FIDELITY_MIN, f"{name}: calibrated and analytic states differ ({fid})")
        runs[name] = {k: v[0] for k, v in out.items()}
        log(f"  {name}: warm run calibrated {out['calibrated'][0]:.4f} s ({out['calibrated'][2]})"
            f", analytic {out['analytic'][0]:.4f} s ({out['analytic'][2]}; planned in "
            f"{build_s:.1f} s); ratio {out['calibrated'][0] / out['analytic'][0]:.3f}; fidelity "
            f"between them {fid:.9f} ({card})")
        del out, state, ana
    del engines
    svc.pool.cache.clear()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "worst": worst, "runs": runs, "wall_s": wall,
            "peak_bytes": peak}


def _lm_inputs(cfg, batch: int, seq: int, seed: int) -> tuple:
    """Tokens [batch, seq] and the audio/vision stub input (bf16) from a CPU
    generator, on the card."""
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, dtype=torch.int32)
    stub = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    extras = None
    if stub:
        x = torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen)
        extras = {stub: x.to(torch.bfloat16).cuda()}
    return toks.cuda(), extras


def lm_cache_against_forward(model, seed: int, sensitivity: bool = False,
                             trace: str = "") -> dict:
    """Prefill of LM["prompt"] tokens into a cache of prompt + gen, then
    LM["gen"] teacher-forced decode steps, each step's logits against one
    forward over all prompt + gen tokens without a cache; the forward's
    logits kept for a twin's comparison. ``sensitivity``: also how far the
    same forward's logits move when every entry of the embedding table
    moves by one float32 ulp (a seeded random sign): the model's own
    rounding floor at these inputs. ``trace``: the last decode step runs
    under torch.profiler (device time and kernels against the mean
    untraced step), with this label."""
    P, G = LM["prompt"], LM["gen"]
    toks, extras = _lm_inputs(model.cfg, LM["batch"], P + G, seed)
    params = model.cast_params()
    with torch.no_grad():
        full = model.forward(toks, extras=extras, params=params)[0][:, P - 1:].float()
    out = {}
    if sensitivity:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        emb = params["embed"]
        sign = torch.randint(0, 2, emb.shape, generator=gen, device="cuda", dtype=torch.int8)
        with torch.no_grad():
            moved = emb * (1 + (2 * sign - 1) * 2.0**-24)
            del sign
            pert = model.forward(toks, extras=extras, params=dict(params, embed=moved))[0]
        out["sensitivity"] = float((pert[:, P - 1:].float() - full).abs().max())
        del moved, pert
    t0 = time.perf_counter()
    last, cache = model.prefill(toks[:, :P], extras=extras, cache_len=P + G, params=params)
    steps = [last.float()]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    held = {"cache": cache}
    for i in range(G):
        def step(i=i):
            logits, held["cache"] = model.decode_step(toks[:, P + i: P + i + 1], held["cache"],
                                                      extras=extras, params=params)
            steps.append(logits.float())
        if trace and i == G - 1:
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t1) / (G - 1)
            trace_run(step, step_s, trace)
        else:
            step()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cache = held["cache"]
    require(cache["len"] == P + G, f"cache len {cache['len']} != {P + G}")
    cached = torch.stack(steps, dim=1)  # positions P-1 .. P+G-1
    require(bool(torch.isfinite(cached).all()), "cached logits must be finite")
    out.update(err=float((cached - full).abs().max()), scale=float(full.abs().max()),
               forward=full, cached=cached, seconds=seconds)
    return out


def lm_phase(ops, card: str) -> dict:
    """LM serving at full width (see ``LM``): each arch through
    ``serve_llm.main`` (tokens' shape and range, prefill seconds, decode ms
    a step and tokens per second, peak device memory), then its float32
    twin's cache against its forward within LM["atol"] (or twice the twin's
    rounding floor, where that is larger); qwen2 also in its
    bf16, whose cache-against-forward departure must stay within twice the
    bf16 forward's own departure from the float32 twin on the same weights
    and positions (the cached path rounds the same ops at other shapes, so
    it departs from the float32 values by as much as the forward does, and
    two such departures add); then qwen2's first LM["cpu_layers"] layers at full
    width, float32, on the card against the same weights on the CPU within
    LM["atol"]. The LM path reaches no ``pallas_call``: neither hand
    kernel may launch."""
    import contextlib
    import dataclasses
    import io
    import re

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve_llm
    from repro_torch.models.transformer import Model

    B, P, G = LM["batch"], LM["prompt"], LM["gen"]
    ops.reset_kernel_counters()
    figures = {}
    for name in LM["archs"]:
        cfg = get_arch(name)
        t0 = time.time()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tokens = serve_llm.main(["--arch", name, *LM_SERVE])
        peak = torch.cuda.max_memory_allocated()
        for line in buf.getvalue().splitlines():
            log(f"  {line}")
        require(tuple(tokens.shape) == (B, G) and tokens.dtype == torch.int32
                and tokens.device.type == "cuda", f"{name}: tokens {tuple(tokens.shape)}")
        # the head has padded_vocab rows (the reference's, unmasked): ids up to it
        require(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.padded_vocab,
                f"{name}: a token outside the head's rows")
        out = buf.getvalue()
        t_prefill = float(re.search(rf"prefill: {B}x{P} tokens in ([\d.]+)s", out).group(1))
        t_decode = float(re.search(rf"decode: {B}x{G - 1} tokens in ([\d.]+)s", out).group(1))
        fig = {"prefill_s": t_prefill, "prefill_tok_s": B * P / t_prefill,
               "decode_ms_step": 1e3 * t_decode / (G - 1),
               "decode_tok_s": B * (G - 1) / t_decode, "peak_bytes": peak}
        log(f"  {name}: prefill {t_prefill:.3f}s ({fig['prefill_tok_s']:.0f} tok/s), decode "
            f"{fig['decode_ms_step']:.2f} ms a step ({fig['decode_tok_s']:.0f} tok/s), peak "
            f"{gib(peak)} ({peak} bytes) ({card})")
        del tokens
        torch.cuda.empty_cache()

        twin_cfg = dataclasses.replace(cfg, dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(LM["seed"])
        twin = Model(twin_cfg, generator=gen)
        chk = lm_cache_against_forward(twin, LM["seed"], sensitivity=True,
                                       trace=f"{name} float32 decode step")
        bound = max(LM["atol"], 2 * chk["sensitivity"])
        fig.update(f32_err=chk["err"], f32_scale=chk["scale"], f32_floor=chk["sensitivity"],
                   f32_bound=bound)
        log(f"  {name} float32 twin: cache against forward max |diff| {chk['err']:.3e} on "
            f"logits up to {chk['scale']:.3f} (prefill + {G} decode steps in "
            f"{chk['seconds']:.3f}s); bound {bound:.3e} = the larger of {LM['atol']} and twice "
            f"the forward's move under a one-ulp embedding ({chk['sensitivity']:.3e})")
        require(chk["err"] <= bound, f"{name}: float32 cache against forward "
                f"{chk['err']:.3e} > {bound:.3e}")
        if name == LM["bf16_arch"]:
            gen = torch.Generator(device="cuda").manual_seed(LM["seed"])
            model = Model(cfg, generator=gen)  # the twin's weights: same seed, same draws
            bf = lm_cache_against_forward(model, LM["seed"], trace=f"{name} bf16 decode step")
            floor = float((bf["forward"] - chk["forward"]).abs().max())
            cached_dep = float((bf["cached"] - chk["forward"]).abs().max())
            fig.update(bf16_err=bf["err"], bf16_floor=floor, bf16_cached_departure=cached_dep,
                       bf16_bound=2 * floor)
            log(f"  {name} bf16: cache against forward max |diff| {bf['err']:.4f}; bound "
                f"{2 * floor:.4f} = twice the bf16 forward's departure from the float32 twin "
                f"({floor:.4f}; the cached path's departure {cached_dep:.4f})")
            require(bf["err"] <= 2 * floor, f"{name}: bf16 cache against forward "
                    f"{bf['err']:.4f} > {2 * floor:.4f}")
            del model, bf
        del twin, chk
        torch.cuda.empty_cache()
        fig["seconds"] = time.time() - t0
        figures[name] = fig

    name = LM["bf16_arch"]
    cfg = dataclasses.replace(get_arch(name), dtype="float32", n_layers=LM["cpu_layers"])
    t0 = time.time()
    cpu = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(LM["seed"]))
    card_model = Model(cfg)
    card_model.load_state_dict(cpu.state_dict())
    toks, _ = _lm_inputs(cfg, 2, LM["cpu_tokens"], LM["seed"])
    with torch.no_grad():
        on_card = card_model.forward(toks)[0].cpu()
        on_cpu = cpu.forward(toks.cpu())[0]
    err = float((on_card - on_cpu).abs().max())
    figures["card_vs_cpu"] = {"arch": name, "layers": LM["cpu_layers"], "err": err,
                              "scale": float(on_cpu.abs().max())}
    log(f"  {name} at full width, {LM['cpu_layers']} layers, float32: card against CPU max "
        f"|diff| {err:.3e} on logits up to {figures['card_vs_cpu']['scale']:.3f} "
        f"({time.time() - t0:.1f}s)")
    require(err <= LM["atol"], f"{name}: card against CPU {err:.3e} > {LM['atol']}")
    del cpu, card_model
    torch.cuda.empty_cache()
    launched = ops.kernel_call_counts()
    require(not any(launched.values()), f"the LM path launched a hand kernel: {launched}")
    log(f"  hand-kernel launches on the LM path: {launched} (it reaches no pallas_call)")
    return {"figures": figures, "launches": dict(launched, by_k={})}


# LM training (repro_torch.launch.train, make_train_step, AdamW over the
# model's parameters, the checkpoint manager): qwen2-1.5b at full width and
# depth (28 layers, tied 151936-row head), bf16, remat on, `steps` steps of
# batch x seq tokens, then one step with remat off; mamba2-1.3b (48 layers:
# the chunked SSD's backward) for `second_steps` steps; the reference test's
# learning criterion (tests/test_train.py::test_training_loss_decreases:
# reduced qwen2, 120 steps, 8 x 64, lr 2e-3, a drop of 0.3 between the
# means of the first and last three logged losses); one float32 step of
# qwen2 cut to `layers` layers at full width, card against CPU (float32
# moments; loss within rtol 1e-5, each gradient leaf within 1e-4 of its
# largest entry, parameters within 0.5 lr); and a run of qwen2 cut to
# `layers` layers (a 2.6 GB checkpoint: fp32 masters, bf16 moments) that
# stops at ckpt_steps[0] and a second call that resumes to ckpt_steps[1]
# (`ckpt_every` past both, so each call saves once, at its end: two saves
# under build/train_ckpt; the background save is held on the CPU, in
# tests/test_torch_train_cli.py).
TRAIN = {"arch": "qwen2-1.5b", "batch": 8, "seq": 128, "steps": 10, "lr": 1e-3, "warmup": 2,
         "second": "mamba2-1.3b", "second_steps": 3, "seed": 0, "reduced": False,
         "learn": ["--steps", "120", "--global-batch", "8", "--seq", "64", "--lr", "2e-3",
                   "--log-every", "10"], "learn_drop": 0.3,
         "layers": 2, "cpu_batch": 2, "cpu_seq": 64, "cpu_lr": 2e-3,
         "ckpt_steps": (2, 3), "ckpt_every": 10}
TRAIN_CKPT_DIR = os.path.join(HERE, "build", "train_ckpt")


def _peak(device: str) -> int:
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def _fresh(device: str) -> None:
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _train_argv(spec: dict, arch: str, steps: int, device: str) -> list:
    return (["--arch", arch, "--steps", str(steps), "--global-batch", str(spec["batch"]),
             "--seq", str(spec["seq"]), "--lr", str(spec["lr"]), "--warmup",
             str(spec["warmup"]), "--log-every", "1", "--seed", str(spec["seed"]),
             "--device", device] + (["--reduced"] if spec["reduced"] else []))


def _same_state(a_model, a_opt, b_params: dict, b_opt, what: str) -> None:
    """Bit for bit: ``a``'s parameters, moments and step against ``b``'s."""
    for name, p in a_model.named_parameters():
        for x, y, part in ((p, b_params[name], "param"), (a_opt.m[name], b_opt.m[name], "m"),
                           (a_opt.v[name], b_opt.v[name], "v")):
            require(x.dtype == y.dtype and torch.equal(x.detach(), y.detach()),
                    f"{what}: {part} {name} differs")
    require(int(a_opt.step) == int(b_opt.step), f"{what}: step {int(a_opt.step)} != "
            f"{int(b_opt.step)}")


def train_phase(ops, card: str, device: str = "cuda", spec: dict = TRAIN) -> dict:
    """LM training on the card (see ``TRAIN``): ``train.run`` at full width
    (finite, decreasing; step ms, tokens per second, peak; one traced step),
    a step without remat (its peak above remat's), the second family, the
    learning criterion, a float32 step card against CPU, and a stop and
    resume through checkpoints. The training path reaches no
    ``pallas_call``: neither hand kernel may launch. ``device="cpu"`` with
    ``spec["reduced"]`` dry-runs it on the host."""
    import contextlib
    import dataclasses
    import statistics

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault_tolerance import RunJournal

    def config(arch):
        cfg = get_arch(arch)
        return cfg.reduced() if spec["reduced"] else cfg

    ops.reset_kernel_counters()
    figures = {}
    B, S = spec["batch"], spec["seq"]

    # full width and depth, remat on, through the entry point
    arch = spec["arch"]
    _fresh(device)
    t0 = time.time()
    run = train.run(_train_argv(spec, arch, spec["steps"], device))
    remat_peak = _peak(device)
    losses = [h["loss"] for h in run.logged]
    gnorms = [h["grad_norm"] for h in run.logged]
    dts = [h["dt"] for h in run.logged]
    step_s = statistics.median(dts[2:])
    require(len(losses) == spec["steps"] and all(np.isfinite(losses + gnorms)),
            f"{arch}: a loss or grad norm is not finite: {losses} {gnorms}")
    require(np.mean(losses[-3:]) < losses[0], f"{arch}: the last three losses' mean "
            f"{np.mean(losses[-3:]):.4f} is not below the first {losses[0]:.4f}")
    fig = {"step_ms": 1e3 * step_s, "first_step_ms": [1e3 * d for d in dts[:2]],
           "tok_s": B * S / step_s, "peak_bytes": remat_peak, "losses": losses,
           "grad_norms": gnorms, "seconds": time.time() - t0}
    log(f"  {arch} (full width, {config(arch).n_layers} layers, remat): step "
        f"{fig['step_ms']:.1f} ms (median after the first two, {fig['first_step_ms'][0]:.0f} "
        f"and {fig['first_step_ms'][1]:.0f} ms), {fig['tok_s']:.0f} tok/s, peak "
        f"{gib(remat_peak)} ({remat_peak} bytes); losses {losses[0]:.4f} -> mean of the last "
        f"three {np.mean(losses[-3:]):.4f} ({card})")
    if device == "cuda":
        opt_cfg = adamw.AdamWConfig(lr=spec["lr"], warmup_steps=spec["warmup"],
                                    total_steps=spec["steps"])
        data = SyntheticDataset(SyntheticConfig(vocab_size=run.model.cfg.vocab_size,
                                                seq_len=S, global_batch=B, seed=spec["seed"]))
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(spec["steps"]).items()}
        step_fn = steps.make_train_step(run.model, opt_cfg)
        held = {"params": dict(run.model.named_parameters()), "opt": run.opt_state}

        def one_step():
            held["params"], held["opt"], _ = step_fn(held["params"], held["opt"], batch)

        trace_run(one_step, step_s, f"{arch} train step")
        del held, step_fn
    del run
    _fresh(device)
    cfg = config(arch)
    model = steps.build_model(cfg, device, torch.Generator(device=device).manual_seed(
        spec["seed"]), remat=False)
    opt_cfg = adamw.AdamWConfig(lr=spec["lr"], warmup_steps=spec["warmup"],
                                total_steps=spec["steps"])
    params = dict(model.named_parameters())
    data = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                            global_batch=B, seed=spec["seed"]))
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(0).items()}
    sync(device)
    t0 = time.perf_counter()
    _, _, metrics = steps.make_train_step(model, opt_cfg)(params, adamw.init(opt_cfg, params),
                                                         batch)
    loss0 = float(metrics["loss"])
    sync(device)
    fig.update(no_remat_peak_bytes=_peak(device), no_remat_step_ms=1e3 * (
        time.perf_counter() - t0))
    require(abs(loss0 - losses[0]) <= 1e-3 * abs(losses[0]),
            f"{arch}: the first step's loss without remat {loss0} is not remat's {losses[0]}")
    log(f"  {arch} without remat: one step {fig['no_remat_step_ms']:.1f} ms, peak "
        f"{gib(fig['no_remat_peak_bytes'])} ({fig['no_remat_peak_bytes']} bytes) against remat's "
        f"{gib(remat_peak)}: remat saves {gib(fig['no_remat_peak_bytes'] - remat_peak)}; its "
        f"first loss {loss0:.4f} (remat's {losses[0]:.4f})")
    if device == "cuda":
        require(remat_peak < fig["no_remat_peak_bytes"], f"{arch}: remat's peak {remat_peak} is "
                f"not below no remat's {fig['no_remat_peak_bytes']}")
    figures[arch] = fig
    del model, params, metrics, batch
    _fresh(device)

    # the second family at full width
    arch = spec["second"]
    t0 = time.time()
    run = train.run(_train_argv(spec, arch, spec["second_steps"], device))
    peak = _peak(device)
    losses = [h["loss"] for h in run.logged]
    gnorms = [h["grad_norm"] for h in run.logged]
    dts = [h["dt"] for h in run.logged]
    require(len(losses) == spec["second_steps"] and all(np.isfinite(losses + gnorms)),
            f"{arch}: a loss or grad norm is not finite: {losses} {gnorms}")
    figures[arch] = {"step_ms": 1e3 * statistics.median(dts[1:]), "first_step_ms": 1e3 * dts[0],
                     "tok_s": B * S / statistics.median(dts[1:]), "peak_bytes": peak,
                     "losses": losses, "grad_norms": gnorms, "seconds": time.time() - t0}
    log(f"  {arch} (full width, {config(arch).n_layers} layers, remat): step "
        f"{figures[arch]['step_ms']:.1f} ms (median after the first, "
        f"{figures[arch]['first_step_ms']:.0f} ms), {figures[arch]['tok_s']:.0f} tok/s, peak "
        f"{gib(peak)} ({peak} bytes); losses {losses} ({card})")
    del run
    _fresh(device)

    # the reference test's learning criterion
    t0 = time.time()
    hist = train.main(["--arch", spec["arch"], "--reduced", *spec["learn"], "--device", device])
    first = float(np.mean([h["loss"] for h in hist[:3]]))
    last = float(np.mean([h["loss"] for h in hist[-3:]]))
    figures["learning"] = {"first3": first, "last3": last, "seconds": time.time() - t0}
    log(f"  reduced {spec['arch']}, {' '.join(spec['learn'])}: mean of the first three logged "
        f"losses {first:.4f}, of the last three {last:.4f} (a drop of {first - last:.4f}; at "
        f"least {spec['learn_drop']}) in {time.time() - t0:.1f}s")
    require(last < first - spec["learn_drop"], f"no learning: {first:.3f} -> {last:.3f}")
    _fresh(device)

    # one float32 step, card against CPU, at full width cut to `layers` layers
    t0 = time.time()
    cfg = dataclasses.replace(config(spec["arch"]), dtype="float32", n_layers=spec["layers"])
    opt_cfg = adamw.AdamWConfig(lr=spec["cpu_lr"], warmup_steps=0, moment_dtype="float32")
    card_model = steps.build_model(cfg, device, torch.Generator(device=device).manual_seed(
        spec["seed"]))
    cpu = steps.build_model(cfg, "cpu")
    cpu.load_state_dict(card_model.state_dict())
    b = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=spec["cpu_seq"],
                                         global_batch=spec["cpu_batch"],
                                         seed=spec["seed"])).batch(0)
    out = []
    for model, dev in ((cpu, "cpu"), (card_model, device)):
        # make_train_step's two halves, the gradients kept for the comparison
        params = dict(model.named_parameters())
        loss, _ = model.loss({k: torch.from_numpy(v).to(dev) for k, v in b.items()},
                             params=model.tree(params))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        loss = loss.detach()
        params, _, metrics = adamw.update(opt_cfg, grads, adamw.init(opt_cfg, params), params)
        out.append((loss.item(), {k: g.cpu() for k, g in grads.items()},
                    {k: p.detach().cpu() for k, p in params.items()},
                    float(metrics["grad_norm"])))
        del grads, params, loss
    (want_l, want_g, want_p, want_n), (got_l, got_g, got_p, got_n) = out
    g_err = max(float((got_g[k] - want_g[k]).abs().max() / want_g[k].abs().max().clamp_min(
        1e-30)) for k in want_g)
    p_err = max(float((got_p[k] - want_p[k]).abs().max()) for k in want_p)
    figures["card_vs_cpu"] = {"layers": spec["layers"], "loss": want_l,
                              "loss_rel": abs(got_l - want_l) / abs(want_l), "grad_rel": g_err,
                              "param_abs": p_err, "grad_norm_rel": abs(got_n - want_n) / want_n,
                              "seconds": time.time() - t0}
    log(f"  {spec['arch']} at full width, {spec['layers']} layers, float32, one step on the card "
        f"against the CPU: loss {got_l:.6f} against {want_l:.6f} (rel "
        f"{figures['card_vs_cpu']['loss_rel']:.2e}), worst gradient leaf {g_err:.2e} of its "
        f"largest entry, grad norm rel {figures['card_vs_cpu']['grad_norm_rel']:.2e}, "
        f"parameters max |d| {p_err:.2e} ({p_err / opt_cfg.lr:.3f} lr) "
        f"({time.time() - t0:.1f}s)")
    require(abs(got_l - want_l) <= 1e-5 * abs(want_l), "card against CPU: the loss differs")
    require(g_err <= 1e-4, f"card against CPU: a gradient leaf differs by {g_err:.2e}")
    require(p_err <= 0.5 * opt_cfg.lr, f"card against CPU: parameters differ by {p_err:.2e}")
    del cpu, card_model, out, want_g, got_g, want_p, got_p
    _fresh(device)

    # stop and resume through checkpoints, at full width cut to `layers` layers
    t0 = time.time()
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    argv = (_train_argv(spec, spec["arch"], 0, device)
            + ["--ckpt-dir", TRAIN_CKPT_DIR, "--ckpt-every", str(spec["ckpt_every"])])
    at = argv.index("--steps") + 1

    @contextlib.contextmanager
    def cut_depth():
        real = train.get_arch
        train.get_arch = lambda name: dataclasses.replace(real(name), n_layers=spec["layers"])
        try:
            yield
        finally:
            train.get_arch = real

    stop, end = spec["ckpt_steps"]
    ckpt = CheckpointManager(TRAIN_CKPT_DIR)
    with cut_depth():
        argv[at] = str(stop)
        first_run = train.run(argv)
        like = {"params": dict(first_run.model.named_parameters()), "opt": first_run.opt_state}
        saved = ckpt.restore(stop, like)
        _same_state(first_run.model, first_run.opt_state, saved["params"], saved["opt"],
                    f"the checkpoint of step {stop}")
        nbytes = sum(os.path.getsize(os.path.join(TRAIN_CKPT_DIR, f"step_{stop:08d}", f))
                     for f in ("state.npz", "manifest.json"))
        del first_run, like, saved
        _fresh(device)
        argv[at] = str(end)
        second_run = train.run(argv)
    journal = RunJournal(os.path.join(TRAIN_CKPT_DIR, "journal.json")).read()
    require(second_run.start_step == stop and journal == {"restarts": 1, "last_step": end},
            f"resume: started at {second_run.start_step}, journal {journal}")
    require(ckpt.all_steps() == [stop, end], f"checkpoints {ckpt.all_steps()}")
    like = {"params": dict(second_run.model.named_parameters()), "opt": second_run.opt_state}
    saved = ckpt.restore(end, like)
    _same_state(second_run.model, second_run.opt_state, saved["params"], saved["opt"],
                f"the checkpoint of step {end}")
    figures["checkpoint"] = {"bytes": nbytes, "journal": journal, "seconds": time.time() - t0}
    log(f"  {spec['arch']} at full width, {spec['layers']} layers: stopped at step {stop} (a "
        f"{nbytes} byte checkpoint), resumed to {end}: journal {journal}; both checkpoints "
        f"restored bit for bit equal to the saved state ({time.time() - t0:.1f}s)")
    del second_run, like, saved
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    _fresh(device)

    launched = ops.kernel_call_counts()
    require(not any(launched.values()), f"the training path launched a hand kernel: {launched}")
    log(f"  hand-kernel launches on the training path: {launched} (it reaches no pallas_call)")
    return {"figures": figures, "launches": dict(launched, by_k={})}


# LM sharding (A14c, A14e: models/sharding.py, models/parallel.py,
# launch/mesh.py, MoE's exchange, attention, MLA, Mamba-2 and the vocabulary
# tensor parallel over the model axis, serve_llm/train with
# --data-par/--model-par under torchrun): qwen2-1.5b at full width on
# `ranks` gloo ranks of the one card as data x model (NCCL takes one rank
# per card), one torchrun whose ranks first probe which collectives gloo
# runs on CUDA tensors (each in turn: gloo aborts the process on CUDA
# send/recv; the path uses all-gather, all-reduce with SUM and MAX, and
# reduce-scatter), then call the two CLIs' run in process, bf16 at full
# depth: serve_llm (4 prompts of 128, `gen` generated: decode ms a step;
# each rank's shards of the weights at rest, every layer gathered at its
# use) and train (`train_steps` steps of 8 x 128, remat: step ms, the
# second step's), each with its collective bytes per rank and every rank's
# peak (serving's from a reset after the build); every rank's bytes (the
# cast: none at rest; the prefill, a decode step, each train step) must
# equal the census of the same steps on a fake group of the same mesh
# (`--lm-shard-census`, run beside the torchrun with no card visible). The
# same serving again by hand, at rest and from the gathered tree
# (`parallel.full` of the cast, held through the run): every decision's
# logits and tokens (and the CLI's tokens) equal bit for bit on every rank
# (a gather copies; the arithmetic is the same), and each rank's serving
# peak at rest below the gathered tree's. Then
# the float32 checks of each of `check_archs` (dense GQA; Mamba-2's heads;
# MLA and MoE), the model cut to `check_layers` layers at full width (TF32
# off), ranks against rank 0's one-card run of the same weights (a MoE's a
# data shard at a time): prefill logits and `check_gen` - 1 teacher-forced
# decode steps on the one-card run's greedy tokens within twice the
# one-card float32 floor (the larger of the move under a one-ulp embedding
# and of each row run alone: the card's own rounding on other GEMM shapes,
# which a mesh also changes); one train step's loss (rtol 1e-5), grad norm
# (rtol 1e-5), every leaf's gradient (within 1e-4 of its largest one-card
# entry) and the parameters (0.5 lr, where the one-card gradient exceeds
# twice its leaf's largest difference, so the signs agree: AdamW's first
# step makes a whole step of lr of a gradient's sign);
# each arch's model-axis-local leaves and collectives by kind printed. The
# path reaches no pallas_call: no hand kernel may launch, on any rank.
LM_SHARD = {"arch": "qwen2-1.5b", "ranks": 4, "data": 2, "model": 2, "batch": 4, "prompt": 128,
            "gen": 4, "train_batch": 8, "seq": 128, "train_steps": 2, "lr": 1e-3, "seed": 0,
            "check_archs": ("qwen2-1.5b", "mamba2-1.3b", "deepseek-v2-lite-16b"),
            "check_layers": 2, "check_gen": 4, "check_lr": 2e-3, "timeout": 600,
            "device": "cuda", "reduced": False}
GLOO_PROBE = ("all_gather", "all_reduce", "all_reduce_max", "broadcast",
              "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single")


def probe_collectives(device: str) -> dict:
    """Each collective of GLOO_PROBE on tensors of ``device`` over the
    default group: ``{name: "works" | "wrong" | "raises ..."}`` (every rank
    calls it; a collective that aborts the process ends the run)."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((1024,), float(rank + 1), device=device)
    total = sum(range(1, world + 1))
    found = {}
    for name in GLOO_PROBE:
        try:
            if name == "all_gather":
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                ok = float(torch.cat(parts).sum()) == 1024 * total
            elif name == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                ok = float(y[0]) == total
            elif name == "all_reduce_max":
                y = x.clone()
                dist.all_reduce(y, op=dist.ReduceOp.MAX)
                ok = float(y[0]) == world
            elif name == "broadcast":
                y = x.clone()
                dist.broadcast(y, 0)
                ok = float(y[0]) == 1.0
            elif name == "all_gather_into_tensor":
                y = torch.empty(1024 * world, device=device)
                dist.all_gather_into_tensor(y, x)
                ok = float(y.sum()) == 1024 * total
            elif name == "reduce_scatter_tensor":
                y = torch.empty(1024 // world, device=device)
                dist.reduce_scatter_tensor(y, x)
                ok = float(y[0]) == total
            else:
                y = torch.empty_like(x)
                dist.all_to_all_single(y, x)
                ok = float(y.sum()) == (1024 // world) * total
            sync(device)
            found[name] = "works" if ok else "wrong"
        except RuntimeError as e:
            found[name] = f"raises {str(e).splitlines()[0][:80]}"
    return found


def lm_shard_argv(spec: dict, cli: str) -> list:
    """``serve_llm``'s or ``train``'s arguments for ``lm_shard_phase``'s
    bf16 runs on the mesh."""
    mesh = ["--arch", spec["arch"], "--seed", str(spec["seed"]), "--data-par", str(spec["data"]),
            "--model-par", str(spec["model"]), "--dist-backend", "gloo", "--device",
            spec["device"]] + (["--reduced"] if spec["reduced"] else [])
    if cli == "serve":
        return mesh + ["--batch", str(spec["batch"]), "--prompt-len", str(spec["prompt"]),
                       "--gen-len", str(spec["gen"])]
    return mesh + ["--steps", str(spec["train_steps"]), "--global-batch",
                   str(spec["train_batch"]), "--seq", str(spec["seq"]), "--lr", str(spec["lr"]),
                   "--warmup", "2", "--log-every", "1"]


def lm_shard_check_rank(spec_path: str) -> None:
    """Under torchrun, each rank of ``lm_shard_phase`` (see LM_SHARD): the
    gloo probe; ``serve_llm.run`` and ``train.run`` in bf16 at full depth,
    in this process (they join its group), rank 0 keeping what they print,
    every rank its collective bytes and the served tokens; the same
    serving by hand at rest and from the gathered tree
    (:func:`lm_shard_serve_twice`); then the float32 checks of each of
    ``spec["check_archs"]`` (:func:`lm_shard_check_arch`). Rank 0 writes
    the figures to ``spec["out"]``."""
    import contextlib
    import io

    import torch.distributed as dist

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import ops
    from repro_torch.launch import dist as launch_dist
    from repro_torch.launch import serve_llm, train
    from repro_torch.launch.mesh import make_host_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_kernel_counters()
    ctx = launch_dist.join("gloo", spec["device"])
    gloo = probe_collectives(spec["device"])
    clis, moved = {}, {}
    for name, cli in (("serve", serve_llm), ("train", train)):
        _fresh(spec["device"])
        printed = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(printed):
            done = cli.run(lm_shard_argv(spec, name))
        clis[name] = {"printed": printed.getvalue(), "seconds": time.time() - t0}
        if name == "serve":
            clis[name]["tokens"] = done.tokens.cpu()
        moved[name] = done.collective_bytes
        del done
    _fresh(spec["device"])
    mesh = make_host_mesh(data=spec["data"], model=spec["model"], device=spec["device"])
    twice = lm_shard_serve_twice(spec, ctx, mesh)
    served = clis["serve"].pop("tokens")
    _fresh(spec["device"])
    archs = {arch: lm_shard_check_arch(spec, arch, ctx, mesh) for arch in spec["check_archs"]}
    rest, whole = twice["rest"], twice["gathered"]
    gathered = [None] * ctx.world
    dist.all_gather_object(gathered, {"archs": {a: {k: v for k, v in f.items() if k in (
        "loss", "serve_moved", "train_moved")} for a, f in archs.items()},
        "cli_moved": moved, "launches": ops.kernel_call_counts(),
        "peak": _peak(spec["device"]),
        "serve_peaks": {"rest": rest["peak"], "gathered": whole["peak"]},
        "bitwise": {"logits": bool(torch.equal(rest["logits"], whole["logits"])),
                    "tokens": bool(torch.equal(rest["tokens"], whole["tokens"])),
                    "cli_tokens": bool(torch.equal(served, whole["tokens"]))}})
    if ctx.rank == 0:
        twice = {"seconds": twice["seconds"], "steps": rest["logits"].shape[0],
                 "max_abs_diff": float((rest["logits"] - whole["logits"]).abs().max()),
                 "scale": float(whole["logits"].abs().max())}
        with open(spec["out"], "w") as f:
            json.dump({"clis": clis, "gloo": gloo, "archs": archs, "ranks": gathered,
                       "twice": twice, "lr": spec["check_lr"]}, f)
    ctx.close()


def lm_shard_serve_twice(spec: dict, ctx, mesh) -> dict:
    """``lm_shard_check_rank``'s bf16 serving again by hand, on the CLI's
    weights and prompts: at rest (``Model.cast_params``: each rank's cast
    shards, every layer gathered at its use, as the CLI serves) and from
    the gathered tree (``parallel.full`` of the same cast, made ready once
    and held through the run). Each run: its greedy tokens, every decision's
    logits (float32 on the host: exact for bf16) and this rank's serving
    peak (``max_memory_allocated`` from a reset after the build to the end
    of decode)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import build_model
    from repro_torch.models import parallel

    dev, B, P, G = ctx.device, spec["batch"], spec["prompt"], spec["gen"]
    cfg = get_arch(spec["arch"])
    cfg = cfg.reduced() if spec["reduced"] else cfg
    model = build_model(cfg, dev, torch.Generator(device=dev).manual_seed(spec["seed"]),
                        remat=False, mesh=mesh)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(spec["seed"])).to(dev)
    out = {}
    t0 = time.time()
    for how in ("rest", "gathered"):
        _fresh(spec["device"])
        params = model.cast_params()
        if how == "gathered":
            params = parallel.full(params)
        logits, cache = model.prefill(prompts, cache_len=P + G, params=params)
        got, toks = [], []
        for i in range(G):
            if i:
                logits, cache = model.decode_step(toks[-1], cache, params=params)
            got.append(logits.float().cpu())
            toks.append(torch.argmax(logits, dim=-1).to(torch.int32)[:, None])
        sync(spec["device"])
        out[how] = {"logits": torch.stack(got), "tokens": torch.cat(toks, 1).cpu(),
                    "peak": _peak(spec["device"])}
        del params, cache, logits, toks
    out["seconds"] = time.time() - t0
    return out


def lm_shard_check_arch(spec: dict, arch: str, ctx, mesh) -> dict:
    """One arch's float32 check in ``lm_shard_check_rank``: the model cut to
    ``spec["check_layers"]`` layers at full width (TF32 off); rank 0 runs
    it on one card first (the others wait), then every rank on the mesh.
    A MoE's capacity and aux loss are per data shard (as the reference's),
    so its one-card run takes each data shard's rows alone: serving a shard
    at a time, training a microbatch a shard. Returns rank 0's figures
    (logit errors against the one-ulp floor; the step's gradients, loss,
    grad norm and parameters against one card) and every rank's: the leaves
    that stay
    local on the model axis, and ``COLLECTIVES`` by kind for serving (the
    cast, prefill and decode) and for the train step."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.launch.steps import build_model, make_train_step
    from repro_torch.models.parallel import COLLECTIVES, gather_full, reset_collectives
    from repro_torch.optim import adamw

    dev = ctx.device
    cfg = get_arch(arch)
    cfg = dataclasses.replace(cfg.reduced() if spec["reduced"] else cfg, dtype="float32",
                              n_layers=spec["check_layers"])
    B, P, G, seed = spec["batch"], spec["prompt"], spec["check_gen"], spec["seed"]
    shards = spec["data"] if cfg.is_moe else 1
    rows = [slice(i * B // shards, (i + 1) * B // shards) for i in range(shards)]
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=torch.Generator().manual_seed(
        seed), dtype=torch.int32).to(dev)
    opt = adamw.AdamWConfig(lr=spec["check_lr"], warmup_steps=0, moment_dtype="float32")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=spec["seq"], global_batch=B, seed=seed)).batch(0).items()}

    def weights():
        return torch.Generator(device=dev).manual_seed(seed)

    def by_kind():
        return {k: list(v) for k, v in COLLECTIVES.items()}

    def grads(model, parts):
        """Each parameter's gradient of the loss: the mean over ``parts``
        (each data shard's rows on one card; the global batch on the mesh)."""
        pp = dict(model.named_parameters())
        acc = None
        for r in parts:
            loss, _ = model.loss({k: v[r] for k, v in batch.items()})
            g = torch.autograd.grad(loss, list(pp.values()), allow_unused=True,
                                    materialize_grads=True)
            acc = list(g) if acc is None else [a + b for a, b in zip(acc, g)]
            del loss, g
        return {k: a / len(parts) for k, a in zip(pp, acc)}

    out = {}
    ref = {}
    if ctx.rank == 0:
        one = build_model(cfg, dev, weights(), remat=False)
        params = one.cast_params()
        with torch.no_grad():
            emb = params["embed"]
            sign = torch.randint(0, 2, emb.shape, generator=weights(), device=dev,
                                 dtype=torch.int8)
            moved = dict(params, embed=emb * (1 + (2 * sign - 1) * 2.0**-24))
            base = torch.cat([one.forward(prompts[r], params=params)[0][:, -1] for r in rows])
            pert = torch.cat([one.forward(prompts[r], params=moved)[0][:, -1] for r in rows])
            # the card's own rounding on other GEMM shapes: each row alone (a
            # MoE's rows keep their shards: its capacity is per batch)
            alone = torch.cat([one.forward(prompts[i:i + 1], params=params)[0][:, -1]
                               for i in range(B)]) if shards == 1 else base
        out["ulp_floor"] = float((pert - base).abs().max())
        out["row_floor"] = float((alone - base).abs().max())
        out["floor"] = max(out["ulp_floor"], out["row_floor"])
        del moved, pert, base, alone
        steps_l, toks = [], []
        for r in rows:  # each data shard's rows alone (one shard off a MoE)
            logits, cache = one.prefill(prompts[r], cache_len=P + G, params=params)
            got, tok = [logits], [torch.argmax(logits, -1)[:, None]]
            for _ in range(G - 1):
                logits, cache = one.decode_step(tok[-1], cache, params=params)
                got.append(logits)
                tok.append(torch.argmax(logits, -1)[:, None])
            steps_l.append(got)
            toks.append(torch.cat(tok, 1))
            del cache
        ref["logits"] = [torch.cat(s) for s in zip(*steps_l)]
        ref["tokens"] = torch.cat(toks)
        del one, params
        _fresh(spec["device"])
        # the gradients, then the step (a microbatch a data shard)
        one = build_model(cfg, dev, weights())
        ref["grads"] = {k: g.detach() for k, g in grads(one, rows).items()}
        pp = dict(one.named_parameters())
        pp, _, m = make_train_step(one, opt, microbatches=shards)(pp, adamw.init(opt, pp), batch)
        ref["loss"], ref["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
        ref["params"] = {k: v.detach() for k, v in pp.items()}
        del one, pp, m, sign
        _fresh(spec["device"])
        held = [ref["tokens"].cpu()]
    else:
        held = [None]
    dist.broadcast_object_list(held, src=0)
    tokens = held[0].to(dev)

    sharded = build_model(cfg, dev, weights(), remat=False, mesh=mesh)
    out["local"] = sorted(k for k, _ in sharded.named_parameters()
                          if sharded.par.local_on_model(k))
    reset_collectives()
    params = sharded.cast_params()
    out["serve_moved"] = {"weights": by_kind()}
    reset_collectives()
    logits, cache = sharded.prefill(prompts, cache_len=P + G, params=params)
    out["serve_moved"]["prefill"] = by_kind()
    got = [logits]
    reset_collectives()
    for i in range(G - 1):
        logits, cache = sharded.decode_step(tokens[:, i:i + 1], cache, params=params)
        got.append(logits)
    out["serve_moved"]["decode"] = by_kind()
    if ctx.rank == 0:
        out["scale"] = float(ref["logits"][0].abs().max())
        out["serve_err"] = [float((a - b).abs().max()) for a, b in zip(got, ref["logits"])]
    del sharded, params, cache, got
    _fresh(spec["device"])

    sharded = build_model(cfg, dev, weights(), mesh=mesh)
    # each leaf's gradient within 1e-4 of its largest one-card entry; the
    # step's parameters within 0.5 lr where the one-card gradient is above
    # twice the leaf's largest difference (the mesh's sign is then its), as
    # AdamW's first step turns a gradient's sign into a whole step of lr
    grad_err, held, total = 0.0, 0, 0
    keep = {}
    for k, g in grads(sharded, [slice(None)]).items():
        whole = gather_full(g)
        if ctx.rank == 0:
            want = ref["grads"].pop(k)
            scale = max(float(want.abs().max()), 1e-30)
            diff = float((whole - want).abs().max())
            grad_err = max(grad_err, diff / scale)
            keep[k] = want.abs() > 2 * diff
            held, total = held + int(keep[k].sum()), total + keep[k].numel()
            del want
        del whole, g
    pp = dict(sharded.named_parameters())
    reset_collectives()
    pp, _, m = make_train_step(sharded, opt)(pp, adamw.init(opt, pp), batch)
    out["train_moved"] = by_kind()
    out["loss"], out["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
    worst = 0.0
    for k, p in pp.items():
        whole = gather_full(p)
        if ctx.rank == 0:
            d = (whole - ref["params"][k]).abs()[keep.pop(k)]
            worst = max([worst] + ([float(d.max())] if d.numel() else []))
            del d
        del whole
    if ctx.rank == 0:
        out.update(ref_loss=ref["loss"], ref_grad_norm=ref["grad_norm"], param_err=worst,
                   grad_err=grad_err, param_held=[held, total], shards=shards)
    del sharded, pp, m, ref
    _fresh(spec["device"])
    return out


def lm_shard_census(out_path: str) -> None:
    """``chip_smoke.py --lm-shard-census OUT``, with no card visible: the
    census (``launch/hlo_analysis.Census``, on ``meta`` tensors over a fake
    group of 4 ranks as data 2 x model 2) of the steps ``lm_shard_phase``'s
    bf16 CLIs run: a train step (``train_batch`` x ``seq``, remat, one
    microbatch) and serving (the weights' cast, the prefill, a decode step
    of the ``gen - 1``): each one's collective bytes a rank; and the
    census's peak live bytes a rank of that serving at rest and from the
    gathered tree (``parallel.full`` of the cast), with the live and peak
    bytes once the weights are ready (the parameters: ``argument``)."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun, hlo_analysis as ha
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import abstract_state, build_model, make_decode_step, \
        make_train_step
    from repro_torch.models import parallel
    from repro_torch.optim import adamw

    spec = LM_SHARD
    torch.set_num_threads(1)
    cfg = get_arch(spec["arch"])

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    out = {}
    with dryrun.fake_group(spec["ranks"]):
        mesh = make_host_mesh(data=spec["data"], model=spec["model"], device="cpu")
        model = build_model(cfg, "meta", mesh=mesh)
        params, opt_state = abstract_state(model, adamw.AdamWConfig())
        batch = {k: meta(spec["train_batch"], spec["seq"]) for k in ("tokens", "labels")}
        with ha.Census() as c:
            make_train_step(model, adamw.AdamWConfig())(params, opt_state, batch)
        out["train"] = c.step.moved
        del model, params, opt_state
        model = build_model(cfg, "meta", remat=False, mesh=mesh)
        B, P, G = spec["batch"], spec["prompt"], spec["gen"]
        peaks, ready = {}, {}
        for how in ("rest", "gathered"):
            with ha.Census() as c:
                with ha.section("weights"):
                    weights = model.cast_params()
                    if how == "gathered":
                        weights = parallel.full(weights)
                ready[how] = [c.live, c.peak]
                with ha.section("prefill"):
                    logits, cache = model.prefill(meta(B, P), cache_len=P + G, params=weights)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                step = make_decode_step(model)
                with ha.section("decode"):
                    for _ in range(G - 1):
                        tok, cache = step(weights, tok, cache)
                del weights, logits, cache, tok
            peaks[how] = c.memory["peak"]
            if how == "rest":
                out["serve"] = {"weights": c["weights"].moved, "prefill": c["prefill"].moved,
                                "decode": c["decode"].moved // (G - 1)}
        out["serve_peaks"] = peaks
        out["serve_weights_ready"] = dict(ready, argument=c.argument)
    with open(out_path, "w") as f:
        json.dump(out, f)


def _printed_peaks(out: str, device: str) -> list:
    """The ranks' peaks a CLI printed on the card (none on the CPU: one
    zero a rank)."""
    import re

    if device != "cuda":
        return [0] * LM_SHARD["ranks"]
    found = re.search(r"^peak device memory per rank: ([\d, ]+) bytes", out, re.M)
    return [int(x) for x in found.group(1).split(", ")]


def lm_shard_phase(ops, card: str, spec: dict = LM_SHARD) -> dict:
    """See ``LM_SHARD``: one ``torchrun`` of ``lm_shard_check_rank``, beside
    ``chip_smoke.py --lm-shard-census`` in a process with no card visible.
    ``spec=dict(LM_SHARD, device="cpu", reduced=True)`` dry-runs it on the
    host (its census is the full-width one: the phase then holds the
    ranks' bytes against it only on the card)."""
    import re
    import signal
    import statistics

    world = spec["ranks"]
    os.makedirs(RESULTS_DIR, exist_ok=True)
    spec_path = os.path.join(RESULTS_DIR, f"lm-shard-{os.getpid()}.json")
    res_path = os.path.join(RESULTS_DIR, f"lm-shard-{os.getpid()}-out.json")
    census_path = os.path.join(RESULTS_DIR, f"lm-shard-{os.getpid()}-census.json")
    with open(spec_path, "w") as f:
        json.dump(dict(spec, out=res_path), f)
    census = subprocess.Popen(
        ["nice", "-n", "10", sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--lm-shard-census", census_path], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    try:
        _, seconds = torchrun_launch(world, [os.path.join(HERE, "chip_smoke.py"),
                                             "--lm-shard-check", spec_path], spec["timeout"])
        _, err = census.communicate(timeout=spec["timeout"])
    finally:
        if census.poll() is None:
            os.killpg(census.pid, signal.SIGKILL)
            census.communicate()
    require(census.returncode == 0, f"the census of the sharded steps failed:\n{err[-3000:]}")
    with open(res_path) as f:
        chk = json.load(f)
    with open(census_path) as f:
        counted = json.load(f)
    for path in (spec_path, res_path, census_path):
        os.remove(path)
    clis = chk.pop("clis")
    figures = {"seconds": seconds, "census": counted}
    log(f"  gloo on {spec['device']} tensors, {world} ranks: "
        + ", ".join(f"{k} {v}" for k, v in chk["gloo"].items()))
    for name in ("all_gather", "all_reduce", "all_reduce_max", "reduce_scatter_tensor"):
        require(chk["gloo"][name] == "works", f"gloo's {name}: {chk['gloo'][name]} (the sharded "
                "LM path uses it)")

    # bf16 at full depth through the entry points
    out, took = clis["serve"]["printed"], clis["serve"]["seconds"]
    B, P, G = spec["batch"], spec["prompt"], spec["gen"]
    t_prefill = float(re.search(rf"^prefill: {B}x{P} tokens in ([\d.]+)s", out, re.M).group(1))
    t_decode = float(re.search(rf"^decode: {B}x{G - 1} tokens in ([\d.]+)s", out,
                               re.M).group(1))
    moved = dict(zip(("weights", "prefill", "decode"), map(int, re.search(
        r"^collective bytes per rank: weights (\d+), prefill (\d+), decode (\d+) a step",
        out, re.M).groups())))
    peaks = _printed_peaks(out, spec["device"])
    require(len(peaks) == world and len(re.findall(r"^prefill:", out, re.M)) == 1,
            "serve_llm on the mesh: one rank prints, every rank's peak")
    figures["serve"] = {"seconds": took, "prefill_s": t_prefill,
                        "decode_ms_step": 1e3 * t_decode / (G - 1), "collective_bytes": moved,
                        "peaks": peaks}
    log(f"  serve_llm bf16 on {spec['data']} x {spec['model']}: prefill {t_prefill:.3f}s, decode "
        f"{figures['serve']['decode_ms_step']:.2f} ms a step; collective bytes per rank: "
        f"weights {moved['weights']}, prefill {moved['prefill']}, decode {moved['decode']} a "
        f"step; peaks {peaks} bytes; {took:.1f}s in main ({card})")
    for line in out.splitlines():
        if line.startswith("   ["):
            log("  " + line)

    # the same serving by hand: at rest against the gathered tree
    tw = chk["twice"]
    rest = [r["serve_peaks"]["rest"] for r in chk["ranks"]]
    whole = [r["serve_peaks"]["gathered"] for r in chk["ranks"]]
    figures["serve"].update(rest_peaks=rest, gathered_peaks=whole, twice_s=tw["seconds"])
    log(f"  the same weights and prompts served again by hand ({tw['seconds']:.1f}s), at rest "
        f"and from the gathered tree (parallel.full of the cast): prefill and {tw['steps'] - 1} "
        f"decode steps' logits max |d| {tw['max_abs_diff']:.3e} on logits up to "
        f"{tw['scale']:.3f}; per rank bit for bit (logits, tokens, the CLI's tokens): "
        + "; ".join(f"{r['bitwise']}" for r in chk["ranks"]))
    log(f"  each rank's serving peak (from a reset after the build to the end of decode): at "
        f"rest {rest} bytes (the CLI's {peaks}), the gathered tree {whole} bytes: "
        + ", ".join(str(w - r) for r, w in zip(rest, whole)) + f" bytes less at rest ({card}); "
        f"the census's peaks of the same serving on the fake group (meta tensors: the "
        f"parameters, weights, caches and activations it sees live): at rest "
        f"{counted['serve_peaks']['rest']}, the gathered tree "
        f"{counted['serve_peaks']['gathered']} bytes; [live, peak] once the weights are ready: "
        f"at rest {counted['serve_weights_ready']['rest']}, the gathered tree "
        f"{counted['serve_weights_ready']['gathered']} (the parameters "
        f"{counted['serve_weights_ready']['argument']})")
    figures["serve"]["census_peaks"] = counted["serve_peaks"]
    for r, rank in enumerate(chk["ranks"]):
        require(all(rank["bitwise"].values()), f"rank {r}: serving at rest is not the gathered "
                f"tree's bit for bit: {rank['bitwise']}")
    require(spec["device"] != "cuda" or all(r < w for r, w in zip(rest, whole)),
            f"a rank's serving peak at rest {rest} is not below the gathered tree's {whole}")

    out, took = clis["train"]["printed"], clis["train"]["seconds"]
    steps = re.findall(r"^step +(\d+) loss +([\d.]+) gnorm +([\d.]+) lr \S+ +(\d+) ms$", out,
                       re.M)
    require(len(steps) == spec["train_steps"], f"train on the mesh printed {len(steps)} steps")
    losses = [float(s[1]) for s in steps]
    ms = [float(s[3]) for s in steps]
    moved = [int(x) for x in re.search(r"^collective bytes per rank a step: ([\d, ]+)$", out,
                                       re.M).group(1).split(", ")]
    peaks = _printed_peaks(out, spec["device"])
    require(all(np.isfinite(losses)) and len(peaks) == world, f"train on the mesh: {losses}")
    figures["train"] = {"seconds": took, "step_ms": statistics.median(ms[1:]),
                        "first_step_ms": ms[0], "losses": losses, "collective_bytes": moved,
                        "peaks": peaks,
                        "tok_s": spec["train_batch"] * spec["seq"] * 1e3 / statistics.median(
                            ms[1:])}
    log(f"  train bf16 on {spec['data']} x {spec['model']} (remat, {spec['train_batch']} x "
        f"{spec['seq']}): step {figures['train']['step_ms']:.0f} ms (median after the first, "
        f"{ms[0]:.0f} ms), {figures['train']['tok_s']:.0f} tok/s; losses {losses}; collective "
        f"bytes per rank a step {moved}; peaks {peaks} bytes; {took:.1f}s in main ({card})")

    # every rank's bytes against the census of the same steps on a fake group
    log(f"  the census of the same steps on a fake {spec['data']} x {spec['model']} group (meta "
        f"tensors, no card): a train step {counted['train']}, serving {counted['serve']} bytes a "
        f"rank")
    full_width = not spec["reduced"]
    for r, rank in enumerate(chk["ranks"]):
        got = {"train": rank["cli_moved"]["train"], "serve": rank["cli_moved"]["serve"]}
        require(len(set(got["train"])) == 1, f"rank {r}'s train steps moved {got['train']}")
        require(not full_width or (got["train"][0] == counted["train"]
                                   and got["serve"] == counted["serve"]),
                f"rank {r} moved {got}, the census counts {counted}")

    # float32 at full width, cut depth: ranks against rank 0's one-card run
    figures["float32"] = {}
    for arch, a in chk["archs"].items():
        bound = 2 * a["floor"]
        p_bound = 0.5 * chk["lr"]
        figures["float32"][arch] = dict(a, bound=bound, param_bound=p_bound)
        log(f"  {arch} float32, {spec['check_layers']} layers at full width: model-axis-local "
            f"leaves {a['local']}")
        log(f"  {arch} collectives a rank by kind [calls, bytes]: the cast "
            f"{a['serve_moved']['weights']}, prefill {a['serve_moved']['prefill']}, "
            f"{spec['check_gen'] - 1} decode steps {a['serve_moved']['decode']}, the train step "
            f"{a['train_moved']}")
        log(f"  {arch} float32, {world} ranks against rank 0's one-card run"
            + (f" (a data shard at a time: {a['shards']} shards, the MoE's capacity and aux "
               "per shard)" if a["shards"] > 1 else "")
            + ": prefill and "
            f"{spec['check_gen'] - 1} decode steps max |d| "
            + ", ".join(f"{e:.2e}" for e in a["serve_err"])
            + f" on logits up to {a['scale']:.3f} (bound {bound:.3e}: twice the one-card floor, "
            f"the larger of one ulp of the embedding's move {a['ulp_floor']:.3e} and each row "
            f"alone's {a['row_floor']:.3e}); gradients max |d| {a['grad_err']:.2e} of each "
            f"leaf's largest (bound 1e-4); train step loss {a['loss']:.6f} against "
            f"{a['ref_loss']:.6f}, grad norm {a['grad_norm']:.6f} against "
            f"{a['ref_grad_norm']:.6f}, parameters max |d| {a['param_err']:.2e} "
            f"({a['param_err'] / chk['lr']:.3f} lr; bound 0.5 lr) on the "
            f"{a['param_held'][0]} of {a['param_held'][1]} entries whose one-card gradient "
            f"exceeds twice its leaf's largest difference")
        require(max(a["serve_err"]) <= bound, f"{arch} float32 on the mesh: logits differ from "
                "one card")
        require(abs(a["loss"] - a["ref_loss"]) <= 1e-5 * abs(a["ref_loss"]),
                f"{arch} float32 on the mesh: the step's loss differs from one card")
        require(abs(a["grad_norm"] - a["ref_grad_norm"]) <= 1e-5 * a["ref_grad_norm"],
                f"{arch} float32 on the mesh: the grad norm differs from one card")
        require(a["grad_err"] <= 1e-4, f"{arch} float32 on the mesh: gradients differ")
        require(a["param_err"] <= p_bound, f"{arch} float32 on the mesh: parameters differ")
        require(all(r["archs"][arch]["loss"] == a["loss"] for r in chk["ranks"]),
                f"{arch}: the ranks' losses differ")
        require(all(r["archs"][arch]["train_moved"] == a["train_moved"] for r in chk["ranks"]),
                f"{arch}: the ranks' collectives differ")
        require(a["local"], f"{arch}: no leaf stays local on the model axis")
    log(f"  {seconds:.1f}s launch to exit")
    launched = {k: sum(r["launches"][k] for r in chk["ranks"]) for k in ("fused", "shm")}
    require(not any(launched.values()) and not any(ops.kernel_call_counts().values()),
            f"the sharded LM path launched a hand kernel: ranks {launched}, this process "
            f"{ops.kernel_call_counts()}")
    return {"figures": figures, "launches": {"fused": 0, "shm": 0, "by_k": {}}}


# The dry run (repro_torch.launch.dryrun, launch/hlo_analysis.py): two cells
# of the reference's sweep, each `python -m repro_torch.launch.dryrun` with
# no card visible (CUDA_VISIBLE_DEVICES empty; the census runs on meta
# tensors over a fake group of 256 or 512 ranks), started first and run on
# the host's other cores beside the census on the card: one full-width qwen2-1.5b bf16 train step
# (remat, 8 x 128, as train_phase runs it) and one decode step (4 rows after
# a 128-token prefill, the weights cast as jitted_serve_step casts them, as
# lm_phase runs it), each against the card's own figures: the census's peak
# live bytes within `peak_rtol` of max_memory_allocated over the same step
# after a reset, its count of ops that do device work within `ops_ratio`x of
# the profiler's kernel count (trace_run's), and its flops / 989e12 and
# bytes_upper / 3.35e12 (an H100 SXM's data-sheet peaks at 700 W) beside the
# step's measured ms.
DRYRUN = {"cells": (("qwen2-1.5b", "train_4k", "single"), ("deepseek-v3-671b", "decode_32k",
                                                             "multi")),
          "timeout": 300, "arch": "qwen2-1.5b", "batch": 8, "seq": 128, "serve_batch": 4,
          "prompt": 128, "gen": 8, "seed": 0, "repeats": 3, "peak_rtol": 0.10, "ops_ratio": 2.0,
          "device": "cuda", "reduced": False}
DRYRUN_DIR = os.path.join(HERE, "build", "dryrun_smoke")


def start_dryrun_cells(spec: dict) -> list:
    """``spec["cells"]`` through the dry-run CLI, each in its own process
    (and session: killed whole on a timeout) with no card visible, under
    ``nice`` (they share the host with the card's steps), all started now."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.path.join(HERE, "src"))
    procs = []
    for arch, shape, mesh in spec["cells"]:
        cmd = ["nice", "-n", "10", sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--results-dir", DRYRUN_DIR]
        procs.append(subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True, start_new_session=True))
    return procs


def dryrun_cells(spec: dict, procs: list, t0: float, card: str) -> dict:
    """The cells of :func:`start_dryrun_cells` (started at ``t0``): each
    exited 0 with one cell ok; their figures. The caller kills what is
    left of ``procs`` if this raises."""
    cells = {}
    for (arch, shape, mesh), proc in zip(spec["cells"], procs):
        try:
            out, err = proc.communicate(timeout=max(1.0, spec["timeout"] - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"the dry run of {arch} {shape} {mesh} overran "
                               f"{spec['timeout']} s") from None
        require(proc.returncode == 0 and "dry-run done: 1 ok, 0 skipped, 0 failed" in out,
                f"dry run {arch} {shape} {mesh} exited {proc.returncode}:\n{out[-2000:]}\n"
                f"{err[-3000:]}")
        with open(os.path.join(DRYRUN_DIR, f"{arch}__{shape}__{mesh}.json")) as f:
            cell = json.load(f)
        rl, step = cell["roofline"], cell["census"]["step"]
        colls = ", ".join(f"{k} x{v['count']} {v['moved']}" for k, v in
                          step["collectives"].items())
        log(f"  {arch} {shape} on {cell['mesh']} ({cell['n_chips']} ranks, no card visible): a "
            f"device {rl['flops']:.4g} flops, {rl['hbm_bytes']:.4g} bytes fused "
            f"({rl['hbm_bytes_upper']:.4g} unfused), {step['ops']} ops; collectives {colls} "
            f"bytes moved ({rl['coll_bytes']:.4g} traffic); peak {rl['peak_bytes']} bytes of "
            f"80e9 (fits: {rl['fits']}); compute {rl['t_compute_s']:.4g}s, memory "
            f"{rl['t_memory_s']:.4g}s, collective {rl['t_collective_s']:.4g}s: {rl['dominant']}; "
            f"traced in {cell['trace_s']:.1f}s ({cell['wall_s']:.1f}s the cell)")
        cells[f"{arch}|{shape}|{mesh}"] = {
            "flops": rl["flops"], "bytes": rl["hbm_bytes"], "bytes_upper": rl["hbm_bytes_upper"],
            "ops": step["ops"], "collectives": step["collectives"], "peak": rl["peak_bytes"],
            "fits": rl["fits"], "dominant": rl["dominant"], "trace_s": cell["trace_s"],
            "wall_s": cell["wall_s"]}
    cells["seconds"] = time.time() - t0
    return cells


def census_against_card(what: str, step, census_step, spec: dict, card: str) -> dict:
    """``census_step()`` (the step once more, its census returned) against
    the card's figures of ``step()``: measured ms (median of
    ``spec["repeats"]``), the peak over it after a reset, and the
    profiler's kernel count."""
    import statistics

    from repro_torch.launch import hlo_analysis as ha

    device = spec["device"]
    ms = []
    for _ in range(spec["repeats"]):
        sync(device)
        t0 = time.perf_counter()
        step()
        sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
    step_ms = statistics.median(ms)
    gc.collect()
    sync(device)
    before = torch.cuda.memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    census = census_step()
    sync(device)
    card_peak = _peak(device)
    traced = trace_run(step, step_ms / 1e3, what) if device == "cuda" else {"kernels": 0}
    hw = ha.HardwareSpec()
    c = ha.Tally(flops=sum(t.flops for t in census.sections.values()),
                 bytes=sum(t.bytes for t in census.sections.values()),
                 bytes_upper=sum(t.bytes_upper for t in census.sections.values()),
                 ops=sum(t.ops for t in census.sections.values()),
                 dtensor_ops=sum(t.dtensor_ops for t in census.sections.values()))
    fig = {"step_ms": step_ms, "census_peak": census.peak, "card_peak": card_peak,
           "census_argument": census.argument, "card_before": before, "census_ops": c.ops,
           "card_kernels": traced["kernels"], "flops": c.flops, "bytes_upper": c.bytes_upper,
           "bytes": c.bytes, "t_compute_ms": 1e3 * c.flops / hw.peak_flops,
           "t_memory_ms": 1e3 * c.bytes_upper / hw.hbm_bw, "dtensor_ops": c.dtensor_ops}
    fig["peak_ratio"] = census.peak / card_peak if card_peak else None
    fig["ops_ratio"] = c.ops / traced["kernels"] if traced["kernels"] else None
    log(f"  {what}: census peak {census.peak} bytes (arguments {census.argument}) against "
        f"max_memory_allocated {card_peak} (allocated before it {before}): "
        f"{fig['peak_ratio'] or 0:.4f}; {c.ops} ops against the profiler's "
        f"{traced['kernels']} kernels: {fig['ops_ratio'] or 0:.3f}; {c.flops:.4g} flops / "
        f"989e12 = {fig['t_compute_ms']:.3f} ms and {c.bytes_upper:.4g} bytes / 3.35e12 = "
        f"{fig['t_memory_ms']:.3f} ms against the step's {step_ms:.1f} ms ({card})")
    require(c.dtensor_ops == 0, f"{what}: the census saw {c.dtensor_ops} DTensor ops")
    if device == "cuda":
        require(abs(fig["peak_ratio"] - 1) <= spec["peak_rtol"],
                f"{what}: the census's peak {census.peak} is not within {spec['peak_rtol']:.0%} "
                f"of the card's {card_peak}")
        require(1 / spec["ops_ratio"] <= fig["ops_ratio"] <= spec["ops_ratio"],
                f"{what}: {c.ops} ops against {traced['kernels']} kernels")
    return fig


def dryrun_phase(ops, card: str, spec: dict = DRYRUN) -> dict:
    """See ``DRYRUN``; the cells run in processes of their own while the
    card's steps run. ``spec=dict(DRYRUN, device="cpu", reduced=True)``
    dry-runs it on the host (the census steps on the CPU, where the
    census counts nothing: its work is the host's)."""
    import signal

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    t0 = time.time()
    ops.reset_kernel_counters()
    procs = start_dryrun_cells(spec)  # on the host's other cores while the card's steps run
    try:
        figures = {}
        device = spec["device"]
        cfg = get_arch(spec["arch"])
        cfg = cfg.reduced() if spec["reduced"] else cfg
        gen = torch.Generator(device=device).manual_seed(spec["seed"])

        # a train step as train_phase runs it
        _fresh(device)
        model = steps.build_model(cfg, device, gen)
        opt_cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=10)
        params = dict(model.named_parameters())
        held = {"opt": adamw.init(opt_cfg, params)}
        data = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                                                global_batch=spec["batch"], seed=spec["seed"]))
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(0).items()}
        step_fn = steps.make_train_step(model, opt_cfg)

        def train_step():
            _, held["opt"], _ = step_fn(params, held["opt"], batch)

        def train_census():
            with ha.Census() as census:
                train_step()
            return census

        train_step()  # the first step pays cuBLAS's start
        figures["train"] = census_against_card(
            f"{spec['arch']} train step ({spec['batch']} x {spec['seq']}, remat)", train_step,
            train_census, spec, card)
        del model, params, held, batch, step_fn
        _fresh(device)

        # a decode step as lm_phase runs it: the weights cast (as
        # jitted_serve_step does), then one step on the prefilled cache
        model = steps.build_model(cfg, device, gen, remat=False)
        B, P, G = spec["serve_batch"], spec["prompt"], spec["gen"]
        prompts = torch.randint(0, cfg.vocab_size, (B, P), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(spec["seed"])).to(device)
        logits, cache = model.prefill(prompts, cache_len=P + G, params=model.cast_params())
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        del logits
        decode = steps.make_decode_step(model)
        pos = cache["len"]

        def decode_step():
            cache["len"] = pos  # each repeat decodes the same position
            decode(model.cast_params(), tok, cache)

        def decode_census():
            with ha.Census() as census:
                cache["len"] = pos
                with ha.section("weights"):
                    weights = model.cast_params()
                decode(weights, tok, cache)
            return census

        decode_step()
        figures["decode"] = census_against_card(
            f"{spec['arch']} decode step ({B} rows at position {P}, the weights cast)", decode_step,
            decode_census, spec, card)
        del model, cache, prompts, tok, decode
        _fresh(device)
        figures["cells"] = dryrun_cells(spec, procs, t0, card)
    finally:
        for p in procs:  # a phase that failed leaves no cell running
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    launched = ops.kernel_call_counts()
    require(not any(launched.values()), f"the dry run launched a hand kernel: {launched}")
    figures["seconds"] = time.time() - t0
    return {"figures": figures, "launches": dict(launched, by_k={})}


EXAMPLES = {"timeout": 300, "train": ["--d-model", "768", "--layers", "12", "--steps", "120"],
            "device": "cuda"}


def run_example(name: str, args: list, timeout: float) -> tuple:
    """``python -m repro_torch.examples.<name> args`` (:func:`session_run`:
    a timeout kills it with any ranks it spawned): ``(stdout lines,
    seconds, kernel launches)``; raises unless it exited 0 with ``OK``
    last."""
    out, err, rc, seconds = session_run(["-m", f"repro_torch.examples.{name}", *args], timeout,
                                        name)
    lines = out.splitlines()
    require(rc == 0 and lines and lines[-1] == "OK",
            f"{name} exited {rc} without OK:\n{out[-3000:]}\n{err[-5000:]}")
    counts = json.loads(_after(lines, "kernel launches: "))
    counts["by_k"] = {int(k): v for k, v in counts["by_k"].items()}
    return lines, seconds, counts


def _after(lines: list, prefix: str) -> str:
    """What follows ``prefix`` on the first line that starts with it."""
    found = [line[len(prefix):] for line in lines if line.startswith(prefix)]
    require(bool(found), f"no line starts with {prefix!r}")
    return found[0]


def examples_phase(card: str, spec: dict = EXAMPLES) -> dict:
    """The four twins of ``examples/`` on the card (module docstring): each
    one's seconds, key figures and kernel launches (``launches``, by twin)."""
    import re

    t_phase = time.time()
    figures, launches = {}, {}

    lines, sec, counts = run_example("quickstart", ["--device", spec["device"]],
                                     spec["timeout"])
    ops_ = json.loads(_after(lines, "compiled ops: "))
    fid = float(_after(lines, "fidelity vs dense reference: "))
    require(counts["shm"] == ops_.get("shm", 0) > 0 and counts["fused"] == ops_.get("fused", 0),
            f"quickstart launched {counts} for its plan's ops {ops_}")
    figures["quickstart"] = {"seconds": sec, "fidelity": fid, "ops": ops_}
    launches["quickstart"] = counts
    log(f"  quickstart: {sec:.1f}s, fidelity {fid:.8f}, ops {ops_}, launches {counts} ({card})")

    lines, sec, counts = run_example("simulate_qft", ["--device", spec["device"]],
                                     spec["timeout"])
    fids = {m.group(1): float(m.group(2)) for m in
            (re.match(r"  fidelity\[(.+)\] = (\S+)$", line) for line in lines) if m}
    paths = {m.group(1).strip(): float(m.group(2)) for m in
             (re.match(r"  (\S.{27}) +(\d+\.\d+)s$", line) for line in lines) if m}
    obs = {m.group(1): (float(m.group(2)), float(m.group(3))) for m in
           (re.match(r"  (\w+) +<obs>=(\S+) \(ref (\S+)\)", line) for line in lines) if m}
    joined = float(re.match(r"(\S+)s", _after(lines, "launch: 8 ranks joined their group "))
                   .group(1))
    require(len(fids) == 4 and min(fids.values()) > 0.9999, f"simulate_qft fidelities {fids}")
    require(set(obs) == {"shardmap", "cuda", "offload"}, f"simulate_qft measured {obs}")
    require(counts["fused"] > 0 and counts["shm"] > 0,
            f"simulate_qft must launch both kernels: {counts}")
    figures["simulate_qft"] = {"seconds": sec, "launch_s": joined, "fidelity": fids,
                               "path_s": paths, "obs": obs}
    launches["simulate_qft"] = counts
    log(f"  simulate_qft: {sec:.1f}s, of it {joined:.1f}s until the 8 ranks joined; fidelities "
        f"{fids}; paths {paths} s; <obs> (ref) {obs}; launches {counts} ({card})")

    lines, sec, counts = run_example("serve_lm", ["--device", spec["device"]],
                                     spec["timeout"])
    rates = {k: float(_after(lines, f"{k}: ").split("(")[1].split()[0].replace(",", ""))
             for k in ("prefill", "decode")}
    figures["serve_lm"] = {"seconds": sec, "tok_per_s": rates}
    launches["serve_lm"] = counts
    log(f"  serve_lm: {sec:.1f}s, prefill {rates['prefill']} tok/s, decode {rates['decode']} "
        f"tok/s, launches {counts} ({card})")

    lines, sec, counts = run_example("train_lm", spec["train"] + ["--device", spec["device"]],
                                     spec["timeout"])
    first, last = (float(v) for v in _after(lines, "loss: ").split()[:3:2])
    done = _after(lines, "done: ")
    require(last < first, f"train_lm's loss did not fall: {first} -> {last}")
    figures["train_lm"] = {"seconds": sec, "first_loss": first, "last_loss": last, "done": done}
    launches["train_lm"] = counts
    log(f"  train_lm {' '.join(spec['train'])}: {sec:.1f}s, loss {first} -> {last}, {done}, "
        f"launches {counts} ({card})")
    for name in ("serve_lm", "train_lm"):
        require(launches[name]["fused"] == launches[name]["shm"] == 0,
                f"{name} reaches no pallas_call, yet launched {launches[name]}")
    figures["seconds"] = time.time() - t_phase
    return {"figures": figures, "launches": launches}


def width_rows(ops, ref, probe, ks, n: int) -> list:
    """``fused_apply`` rows at widths ``ks`` that no plan launched (the
    profile's k on bits 0..k-1 of one shard of 2^n): against the plain
    version, timed beside it and one torch.matmul, with the bounds."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = random_state(n, gen)
    vidx = torch.zeros(1, dtype=torch.int32, device="cuda")
    rows = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for k in ks:
            u = random_unitaries(1, k, gen)
            bits = list(range(k))
            err = max_err(ops.fused_apply(x.clone(), u, vidx, bits, n),
                          ref.fused_apply_ref(x.clone(), u, vidx, bits, n))
            require(err < ATOL, f"fused_apply k={k} disagrees with its plain version")
            ms = probe.time_ms(lambda: ops.fused_apply(x, u, vidx, bits, n))
            plain_ms = probe.time_ms(lambda: ref.fused_apply_ref(x, u, vidx, bits, n), reps=3)
            xt, ut = x.view(-1, 1 << k), u[0].transpose(0, 1).contiguous()
            mm_ms = probe.time_ms(lambda: torch.matmul(xt, ut))
            cmacs = (1 << k) * (1 << n)
            row = entry("fused_apply", 0, err, ms, plain_ms, 2 * (8 << n) + u.numel() * 8 + 4,
                        TF32_PASSES * KARATSUBA_OPS * cmacs, TF32_OPS_PER_S, 8 * cmacs, mm_ms,
                        f"calibration: k={k} bits={bits} V=1 n={n}")
            rows.append(by_k_row(dict(row, k=k, path="calibration")))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return rows


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build, ops, probe, ref
    from repro_torch.launch import simulate
    from repro_torch.sim.statevector import fidelity, simulate as dense_simulate

    shutil.rmtree(CALIBRATION_DIR, ignore_errors=True)
    os.makedirs(CALIBRATION_DIR)
    os.environ["REPRO_CALIBRATION_DIR"] = CALIBRATION_DIR
    os.environ.pop("REPRO_CALIBRATION", None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    t_start = time.time()

    log("== build")
    t0 = time.time()
    ops.load()
    log(f"  built and loaded in {time.time() - t0:.1f}s")
    for line in probe.ptxas_lines(build):
        log(f"  {line}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    log("== kernels vs plain versions (n=30, L=28)")
    sweep_err = kernel_sweep(ops, ref, 30, 28, gen)
    torch.cuda.empty_cache()

    log("== main path: " + " ".join(MAIN_PATH))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_counters()
    run = simulate.main(MAIN_PATH)
    torch.cuda.synchronize()
    launches = launches_match(ops, run.engine, "main path")
    launches_by_k = ops.fused_call_counts_by_k()
    peak = torch.cuda.max_memory_allocated()
    res = run.result
    amps = 1 << run.engine.n
    require(res.samples.shape == (1024,) and bool(np.all((res.samples >= 0) & (res.samples < amps))),
            "shots must be 1024 basis-state indices")
    marg = res.marginals[(0, 1, 2)]
    require(marg.shape == (8,) and bool(np.all(np.isfinite(marg))) and abs(marg.sum() - 1) < 1e-4,
            "the marginal must be a finite distribution over 8 outcomes")
    require(all(np.isfinite(v) for v in res.expectations.values()), "expectations must be finite")
    log(f"  simulate {run.seconds:.3f}s = {amps / run.seconds / 1e6:.1f} Mamps/s; "
        f"peak device memory {gib(peak)}")
    state = run.engine.finalize(run.state)
    run.state = None
    t0 = time.time()
    oracle = dense_simulate(run.engine.circuit, device="cuda")
    fid = fidelity(state, oracle)
    log(f"  fidelity vs dense per-gate oracle on the card: {fid:.9f} "
        f"(oracle {time.time() - t0:.1f}s)")
    require(fid >= 1 - 1e-5, f"fidelity {fid} < 1 - 1e-5")
    del state, oracle
    torch.cuda.empty_cache()

    log("== trace of the main path's stage loop")
    trace_run(run.engine.run_packed, run.seconds)
    torch.cuda.empty_cache()

    log("== kernel figures on the main path's ops")
    kernels = figures(ops, ref, probe, run.engine, gen, sweep_err, launches, launches_by_k)
    main_plan = (run.engine.circuit, run.engine.plan)
    del run
    torch.cuda.empty_cache()

    log("== checked path: " + " ".join(CHECKED_PATH))
    checked = simulate.main(CHECKED_PATH)
    require(round(checked.fidelity, 6) == 1.0, f"qft(22) fidelity {checked.fidelity}")
    del checked
    torch.cuda.empty_cache()

    log("== engine path: " + " ".join(ENGINE_PATH))
    paths = {"ising30": dict(launches, by_k=launches_by_k)}
    worst = []
    eng_run = engine_phase(simulate, ops, ref, ENGINE_PATH, card)
    paths["isingparam30_engine"] = eng_run["launches"]
    worst.append(eng_run["worst"])
    fused = kernels[0]
    new_rows = fused_by_k(ops, ref, probe, eng_run["engine"], eng_run["x"], "engine path",
                          eng_run["launches"]["by_k"], skip=[row["k"] for row in fused["by_k"]])
    fused["by_k"] += [by_k_row(row) for row in new_rows]
    del eng_run, new_rows
    torch.cuda.empty_cache()
    log("== sweep: isingparam({n}) L={L} R={R}, P={P} bindings".format(**SWEEP))
    sweep = sweep_phase(ops, ref, **SWEEP, card=card)
    paths["isingparam28_sweep16"] = sweep["launches"]
    worst.append(sweep["worst"])
    torch.cuda.empty_cache()
    log("== batch: qft({n}) L={L} R={R}, B={B} basis states".format(**BATCH))
    batch = batch_phase(ops, ref, **BATCH, card=card)
    paths["qft28_batch3"] = batch["launches"]
    worst.append(batch["worst"])
    torch.cuda.empty_cache()

    t_shardmap = time.time()
    log("== shardmap: the main path's plan on {ranks} ranks of one gloo group, one 2^28 shard "
        "each".format(**SHARDMAP))
    shardmap = shardmap_phase(ops, card, *main_plan)
    paths["ising30_shardmap4"] = shardmap["launches"]
    worst.append(shardmap["worst"])
    torch.cuda.empty_cache()
    log("== shardmap over NCCL, world size 1: qft({n}) L={L}".format(**SHARDMAP_NCCL))
    paths["qft28_shardmap_nccl1"] = shardmap_nccl_phase(ops, card, **SHARDMAP_NCCL)["launches"]
    torch.cuda.empty_cache()
    log("== shardmap CLI under one torchrun launch: {ranks} gloo ranks on the one card call "
        "the CLI in process: ".format(**SHARDMAP_CLI) + " ".join(SHARDMAP_CLI_PATH) + "; then "
        + " ".join(SHARDMAP_VQE_PATH) + " --vqe <VQE_OBS + X/Y on device qubits>; then rank 0 "
        "at world size 1 over NCCL: " + " ".join(SHARDMAP_CLI_NCCL_PATH))
    cli_runs = shardmap_cli_phases(ops, ref, probe, card, *main_plan)
    paths["ising30_shardmap4_cli"] = cli_runs["cli"]["launches"]
    paths["isingparam28_shardmap1_cli"] = cli_runs["nccl"]["launches"]
    shardmap_vqe = cli_runs["vqe"]
    paths["isingparam{n}_shardmap4_vqe".format(**SHARDMAP_VQE)] = shardmap_vqe["launches"]
    del cli_runs
    torch.cuda.empty_cache()
    log(f"  the shardmap phases took {time.time() - t_shardmap:.1f}s")

    t_grad = time.time()
    log("== VQE: " + " ".join(VQE_PATH))
    vqe = vqe_phase(simulate, ops, ref, probe, card, fused)
    paths[f"isingparam{vqe['n']}_vqe"] = vqe["launches"]
    worst.append(vqe["worst"])
    fused["by_k"] += shardmap_vqe["rows"]  # after the single-card sweep's rows at those widths
    log("== gradient oracle: su2param({n}, reps={reps}) L={L} R={R}".format(**ORACLE))
    paths["su2param20_grad"] = oracle_phase(ops, card, **ORACLE)["launches"]
    log("== grad_sweep: isingparam({n}) L={L} R={R}, P={P} bindings".format(**GRAD_SWEEP))
    paths["isingparam28_grad_sweep4"] = grad_sweep_phase(ops, card, **GRAD_SWEEP)["launches"]
    torch.cuda.empty_cache()
    log("== offload gradient: isingparam({n}) L={L} R={R}".format(**OFFLOAD_GRAD))
    paths["isingparam28_offload_grad"] = offload_grad_phase(ops, card, **OFFLOAD_GRAD)["launches"]
    torch.cuda.empty_cache()
    log(f"  the gradient phases took {time.time() - t_grad:.1f}s")

    t_offload = time.time()
    log("== host <-> card link (pinned, 2 GiB)")
    rates = link_rates()
    log("  h2d {h2d:.2f} GB/s, d2h {d2h:.2f} GB/s, both at once {both:.2f} GB/s ".format(**rates)
        + f"({card})")
    log("== offload path: " + " ".join(OFFLOAD_PATH))
    off = offload_phase(simulate, ops, ref, probe, card, rates, fused)
    paths["ising31_offload"] = off["launches"]
    worst.append(off["worst"])
    log("== per-gate offload baseline: qft({n}) L={L} R={R}".format(**PERGATE))
    pg = pergate_phase(ops, ref, probe, card, fused, **PERGATE)
    paths["qft26_offload"] = pg["staged"]
    paths["qft26_pergate"] = pg["pergate"]
    worst.append(pg["worst"])
    log("== offload batch and sweep: n={n} L={L} R={R}, B={B}, P={P}".format(**OFFLOAD_ROWS))
    rows = offload_rows_phase(ops, ref, card, **OFFLOAD_ROWS)
    paths["qft28_offload_batch2"] = rows["batch"]["launches"]
    paths["isingparam28_offload_sweep4"] = rows["sweep"]["launches"]
    worst += [rows["batch"]["worst"], rows["sweep"]["worst"]]
    log(f"  the offload phases took {time.time() - t_offload:.1f}s")

    t_store = time.time()
    log("== the host's disk and memory (spill directory build/spill)")
    free_disk = host_check()
    log("== shard store: ising({n}) L={L} R={R}, {tier}, half at rest on disk".format(**STORE))
    store = store_phase(simulate, ops, ref, probe, card, fused, free_disk, xy=True, **STORE)
    paths["ising{n}_store_{tier}".format(**STORE)] = store["launches"]
    worst.append(store["worst"])
    log("== shard store: ising({n}) L={L} R={R}, {tier}, half at rest on disk".format(**STORE_INT8))
    store8 = store_phase(simulate, ops, ref, probe, card, fused, free_disk, **STORE_INT8)
    paths["ising{n}_store_{tier}".format(**STORE_INT8)] = store8["launches"]
    worst.append(store8["worst"])
    log("== stage checkpoints: ising({n}) L={L} R={R}, killed in stage 1 and resumed"
        .format(**CHECKPOINT))
    ckpt = checkpoint_phase(card, ops, ref, **CHECKPOINT)
    paths["ising{n}_checkpoint_resumed".format(**CHECKPOINT)] = ckpt["launches"]
    worst.append(ckpt["worst"])
    log(f"  the store and checkpoint phases took {time.time() - t_store:.1f}s")

    t_cal = time.time()
    log(f"== calibration: python -m repro_torch.sim.profiler --L {CALIBRATION_L} "
        f"--repeats {CALIBRATION_REPEATS} --verify (into build/calibration)")
    paths["calibration_L28"] = calibration_phase(ops, card)["launches"]
    from repro_torch.sim import profiler

    profiler.clear_resolved_cache()
    for name in CALIBRATED["families"]:
        log("== calibrated planning: {name}({n}) L={L} R={R}, calibrated against analytic"
            .format(name=name, **CALIBRATED))
        cal = calibrated_phase(ops, ref, probe, card, name, fused)
        paths[f"{name}{CALIBRATED['n']}_calibrated"] = cal["launches"]
        worst.append(cal["worst"])
    log("== autotune: " + " ".join(AUTOTUNE_PATH))
    tuned = autotune_phase(simulate, ops, ref, card)
    paths["ising{n}_autotune".format(**AUTOTUNE)] = tuned["launches"]
    worst.append(tuned["worst"])
    log("== integrity guard and build faults: ising({n}) L={L} R={R}, sweep of {P}"
        .format(**FAULTS))
    paths["ising28_faults"] = faults_phase(ops, card)["launches"]
    log(f"  the calibration, calibrated, autotune and faults phases took "
        f"{time.time() - t_cal:.1f}s")

    t_serve = time.time()
    log("== serving: SimulationService on the card, isingparam({n}) and su2param({n}, "
        "reps={su2param_reps}) L={L} R={R}, qft({n}), ising({main_n}); max batch 8, max wait "
        "5 ms, tenants gold:4 free:1".format(**SERVE))
    serve = serve_phase(ops, ref, card)
    paths["serve{n}".format(**SERVE)] = serve["launches"]
    worst.append(serve["worst"])
    log(f"  the serving phase took {time.time() - t_serve:.1f}s")
    t_serve = time.time()
    log("== serving on the shardmap backend: serve_sim --backend shardmap under torchrun, "
        "{ranks} gloo ranks on the one card, isingparam({n}) L={L} R={R}, max batch "
        "{max_batch}".format(**SERVE_SHARDMAP))
    paths["isingparam{n}_serve_shardmap4".format(**SERVE_SHARDMAP)] = serve_shardmap_phase(
        card)["launches"]
    log(f"  the shardmap serving phase took {time.time() - t_serve:.1f}s")
    t_lm = time.time()
    log("== LM serving: serve_llm.main at full width, " + ", ".join(LM["archs"]) + "; "
        + " ".join(LM_SERVE) + "; each float32 twin's cache against its forward")
    lm = lm_phase(ops, card)
    paths["lm_serving"] = lm["launches"]
    log("  LM figures: " + json.dumps(lm["figures"]))
    log(f"  the LM serving phase took {time.time() - t_lm:.1f}s")
    t_train = time.time()
    log("== LM training: train.run at full width, {arch} ({steps} steps of {batch} x {seq}, "
        "remat on and off) and {second} ({second_steps} steps); the learning criterion; one "
        "float32 step card against CPU; a stop and resume through checkpoints".format(**TRAIN))
    trained = train_phase(ops, card)
    paths["lm_training"] = trained["launches"]
    log("  train figures: " + json.dumps(trained["figures"]))
    log(f"  the LM training phase took {time.time() - t_train:.1f}s")
    t_shard = time.time()
    log("== LM sharding: {arch} at full width on {ranks} gloo ranks of the one card as data "
        "{data} x model {model}: serve_llm and train under torchrun (bf16), their collective "
        "bytes against the census, then float32 at {check_layers} layers against one card: "
        .format(**LM_SHARD) + ", ".join(LM_SHARD["check_archs"]))
    ops.reset_kernel_counters()
    sharded = lm_shard_phase(ops, card)
    paths["lm_sharded"] = sharded["launches"]
    log("  LM sharding figures: " + json.dumps(sharded["figures"]))
    log(f"  the LM sharding phase took {time.time() - t_shard:.1f}s")
    t_dry = time.time()
    log("== LM dry run: " + ", ".join(" x ".join(c) for c in DRYRUN["cells"]) + " through "
        "repro_torch.launch.dryrun with no card visible; the census of a full-width {arch} train "
        "step and decode step against the card".format(**DRYRUN))
    ops.reset_kernel_counters()
    dry = dryrun_phase(ops, card)
    paths["lm_dryrun"] = dry["launches"]
    log("  dry-run figures: " + json.dumps(dry["figures"]))
    log(f"  the LM dry-run phase took {time.time() - t_dry:.1f}s")
    t_ex = time.time()
    log("== the examples' twins: python -m repro_torch.examples.{quickstart, simulate_qft, "
        "serve_lm, train_lm " + " ".join(EXAMPLES["train"]) + "}")
    torch.cuda.empty_cache()
    ex = examples_phase(card)
    for name, counts in ex["launches"].items():
        paths[f"example_{name}"] = counts
    log("  examples figures: " + json.dumps(ex["figures"]))
    log(f"  the examples phase took {time.time() - t_ex:.1f}s")
    for k in kernels:
        key = "fused" if k["name"] == "fused_apply" else "shm"
        k["launches_by_path"] = {path: counts[key] for path, counts in paths.items()}
        k["max_abs_err"] = max([k["max_abs_err"]] + [w[key] for w in worst])
    for row in fused["by_k"]:
        row["launches_by_path"] = {path: counts["by_k"].get(row["k"], 0)
                                   for path, counts in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        require(row["launches"] > 0, f"no path launched fused_apply at k={row['k']}")
    launched_k = {k for counts in paths.values() for k in counts["by_k"]}
    missing = sorted(launched_k - {row["k"] for row in fused["by_k"]})
    for row in width_rows(ops, ref, probe, missing, CALIBRATION_L):
        row["launches_by_path"] = {path: counts["by_k"].get(row["k"], 0)
                                   for path, counts in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        fused["by_k"].append(row)
    require(launched_k <= {row["k"] for row in fused["by_k"]},
            f"a fused_apply width launched on a path has no row: {sorted(launched_k)}")

    log(f"== done in {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shardmap-cli-check"]:
        shardmap_cli_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--lm-shard-check"]:
        lm_shard_check_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--lm-shard-census"]:
        lm_shard_census(sys.argv[2])
    else:
        main()
