"""The port's tiered shard store (``repro_torch.sim.shard_store``) and the
offload backend's ``storage=`` path on the CPU, held to the JAX package's
``repro.sim.shard_store`` and its ``storage=`` offload engine (the contracts
of ``tests/test_spill.py``).

Tolerances: codec payloads, scales, decoded shards and remapped shards equal
the reference's bit for bit; encode errors within rtol 1e-5 (the L2 norm is
reduced in another order); exact-tier states within atol 1e-5 of the
reference's and of the oracle; bf16/int8 states within the bound each run
reports (plus 1e-5 of complex64 rounding)."""

import ast
import os
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import assert_states_close
from repro.core.cost_model import DEFAULT_COST_MODEL as REF_CM
from repro.core.generators import random_circuit
from repro.sim import shard_store as RS
from repro.sim.compile import RemapSpec as RefRemapSpec
from repro.sim.engine import engine_for as ref_engine_for
from repro.sim.statevector import simulate_np
from repro_torch.core.circuit import Circuit as PCircuit
from repro_torch.core.cost_model import DEFAULT_COST_MODEL
from repro_torch.kernels import ops
from repro_torch.launch.simulate import main as cli
from repro_torch.sim import faults
from repro_torch.sim import shard_store as TS
from repro_torch.sim.engine import OffloadBackend, circuit_key_for, engine_for
from repro_torch.sim.faults import (
    FaultPlan, ShardTransferError, SpillIOError, StorageToleranceError, TRANSIENT_ERRORS,
)
from test_params import _ansatz, _vals

ROOT = Path(__file__).resolve().parents[1]
C8 = random_circuit(8, 40, seed=5)
REF8 = simulate_np(C8).astype(np.complex64)
P8 = PCircuit.from_json(C8.to_json())


def _rand(rng, shape):
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return z.astype(np.complex64)


def _ref_parts(enc):
    return [np.asarray(p).view(np.uint16) if np.asarray(p).dtype.name == "bfloat16"
            else np.asarray(p) for p in enc.parts]


# ======================================================================
# codecs
# ======================================================================

@pytest.mark.parametrize("mode", TS.AT_REST_DTYPES)
def test_codec_matches_reference(mode):
    """Payloads and scales equal the reference's bit for bit (bf16 through
    torch.bfloat16 against ml_dtypes), so do the decoded shards; the
    reported error within rtol 1e-5. Values span 1e-30..1e5."""
    rng = np.random.default_rng(11)
    for shape in [(512,), (2, 256), (1 << 14,)]:
        arr = _rand(rng, shape) * (10.0 ** rng.uniform(-30, 5, size=shape)).astype(np.float32)
        ref, ref_err = RS.encode_shard(arr, mode)
        got, err = TS.encode_shard(arr, mode)
        assert got.mode == ref.mode and tuple(got.shape) == tuple(ref.shape)
        for a, b in zip(_ref_parts(ref), got.parts):
            assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (mode, shape)
        assert got.nbytes == ref.nbytes
        dec = TS.decode_shard(got).numpy()
        assert np.array_equal(dec.view(np.uint8), RS.decode_shard(ref).view(np.uint8))
        assert err == pytest.approx(ref_err, rel=1e-5, abs=1e-12)


@pytest.mark.parametrize("mode", TS.AT_REST_DTYPES)
def test_codec_reported_error_is_exact(mode):
    arr = _rand(np.random.default_rng(0), (512,))
    enc, err = TS.encode_shard(arr, mode)
    out = TS.decode_shard(enc).numpy()
    assert out.shape == arr.shape and out.dtype == arr.dtype
    actual = float(np.linalg.norm((out - arr).view(np.float32)))
    assert err == pytest.approx(actual, rel=1e-5, abs=1e-9)
    if mode == "exact":
        assert err == 0.0 and np.array_equal(out, arr)
    else:
        assert 0.0 < err < 0.05 * np.linalg.norm(arr)


@pytest.mark.parametrize("mode", TS.AT_REST_DTYPES)
def test_codec_decode_is_lossless_from_encoded(mode):
    arr = _rand(np.random.default_rng(1), (2, 128))
    enc, _ = TS.encode_shard(torch.from_numpy(arr), mode)
    a, b = TS.decode_shard(enc), TS.decode_shard(enc)
    assert torch.equal(a, b)
    strided = torch.empty(2, 2, 128, dtype=torch.complex64)[:, 1]  # a remap group's rows
    TS.decode_shard(enc, strided)
    assert torch.equal(strided, a)


def test_codec_at_rest_bytes_match_the_reference():
    arr = _rand(np.random.default_rng(2), (4096,))
    sizes = {m: TS.encode_shard(arr, m)[0].nbytes for m in TS.AT_REST_DTYPES}
    assert sizes["int8"] < sizes["bf16"] < sizes["exact"] == arr.nbytes
    assert TS.AT_REST_BYTES_PER_AMP == RS.AT_REST_BYTES_PER_AMP
    for m in TS.AT_REST_DTYPES:
        assert sizes[m] == pytest.approx(TS.AT_REST_BYTES_PER_AMP[m] * arr.size, rel=0.01)


def test_bf16_tier_without_ml_dtypes_and_no_jax():
    """A process where ``ml_dtypes`` cannot be imported runs the bf16 store
    through the CLI; no module of jax, ml_dtypes or repro is loaded, and no
    port source imports ml_dtypes."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import repro_torch.launch.simulate as s\n"
        "run = s.main(['--circuit', 'qft', '--n', '8', '--L', '5', '--R', '3', '--executor',"
        " 'offload', '--storage', 'bf16:dram_bytes=512', '--check', '--device', 'cpu'])\n"
        "assert run.engine.provenance['storage']['spills'] > 0\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None and"
        " m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     else [])
            assert not any(n.split(".")[0] == "ml_dtypes" for n in names), path


# ======================================================================
# StorageConfig
# ======================================================================

@pytest.mark.parametrize("spec", ["exact", "bf16", "int8", "int8:dram_kib=2:tol=0.1:prefetch=0",
                                  "bf16:dram_bytes=4096:dir=/tmp/x", "exact:dram_kib=1",
                                  "off", "none", ""])
def test_storage_config_parse_matches_reference(spec):
    ref, got = RS.StorageConfig.parse(spec), TS.StorageConfig.parse(spec)
    if ref is None:
        assert got is None and TS.StorageConfig.coerce(spec) is None
        return
    for f in ("at_rest_dtype", "dram_bytes", "spill_dir", "error_tolerance", "prefetch"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.fingerprint() == ref.fingerprint()
    assert got.spill_fraction(1 << 12) == ref.spill_fraction(1 << 12)
    assert TS.StorageConfig.coerce(got) is got
    assert TS.StorageConfig.coerce({"at_rest_dtype": got.at_rest_dtype}).at_rest_dtype == \
        got.at_rest_dtype


def test_storage_config_rejects_like_the_reference():
    for bad in ("fp4", "exact:bogus=1"):
        with pytest.raises(ValueError):
            RS.StorageConfig.parse(bad)
        with pytest.raises(ValueError):
            TS.StorageConfig.parse(bad)
    with pytest.raises(ValueError):
        TS.StorageConfig(dram_bytes=-1)
    with pytest.raises(TypeError):
        TS.StorageConfig.coerce(3)
    fps = {TS.StorageConfig.parse(s).fingerprint()
           for s in ("exact", "bf16", "int8", "exact:dram_kib=1", "exact:tol=0.01")}
    assert len(fps) == 5


@pytest.mark.parametrize("spec", ["exact:dram_kib=1", "bf16", "int8:dram_kib=3"])
def test_apply_to_cost_model_matches_reference(spec):
    ref = RS.StorageConfig.parse(spec).apply_to_cost_model(REF_CM, n=12, L=8)
    got = TS.StorageConfig.parse(spec).apply_to_cost_model(DEFAULT_COST_MODEL, n=12, L=8)
    assert got.at_rest_bytes == ref.at_rest_bytes
    assert got.comm_weight == pytest.approx(ref.comm_weight, rel=1e-12)


# ======================================================================
# LRU and the disk tier
# ======================================================================

def test_lru_eviction_matches_reference_and_model(tmp_path):
    """A seeded put/get trace through both stores: the same resident and
    spilled shards (and so the same eviction and spill order) after every
    step, the reference's LRU model, and bit-identical reads."""
    rng = np.random.default_rng(1234)
    n_shards, shard_len, cap = 8, 64, 3
    stores = []
    for mod, sub in ((RS, "ref"), (TS, "port")):
        cfg = mod.StorageConfig(at_rest_dtype="exact", dram_bytes=cap * shard_len * 8,
                                spill_dir=str(tmp_path / sub))
        stores.append(mod.ShardStore(n_shards, shard_len, (), np.complex64, cfg))
    ref, port = stores
    model: "OrderedDict[int, None]" = OrderedDict()

    def touch(s):
        model.pop(s, None)
        model[s] = None
        while len(model) > cap:
            model.popitem(last=False)

    payload = {s: _rand(rng, (shard_len,)) for s in range(n_shards)}
    for s in range(n_shards):
        ref.put(s, payload[s])
        port.put(s, payload[s])
        touch(s)
    for _ in range(300):
        s = int(rng.integers(n_shards))
        if rng.random() < 0.5:
            payload[s] = _rand(rng, (shard_len,))
            ref.put(s, payload[s])
            port.put(s, torch.from_numpy(payload[s]))
        else:
            assert np.array_equal(port.get_decoded(s).numpy(), payload[s])
            ref.get_decoded(s)
        touch(s)
        assert port.resident_shards() == ref.resident_shards() == tuple(model)
        assert port.spilled_shards() == ref.spilled_shards()
    # disk_bytes: the two spill formats differ in size
    assert {k: v for k, v in port.stats.items() if k != "disk_bytes"} == \
        {k: v for k, v in ref.stats.items() if k != "disk_bytes"}
    assert port.stats["evictions"] > 0 and port.stats["spill_loads"] > 0
    for st in stores:
        st.close()
    assert not os.listdir(tmp_path / "port")  # close() removes every spill file


def test_store_under_concurrent_puts_and_gets(tmp_path):
    """More threads than cores put and read their own shards of one store
    with a budget of two shards (every call evicts or reloads), with a
    short switch interval: each read returns the thread's last put, and
    the DRAM bookkeeping adds up at the end."""
    import threading

    n_threads, per = 12, 2
    store = TS.ShardStore(n_threads * per, 64, (), torch.complex64,
                          TS.StorageConfig(dram_bytes=2 * 64 * 8, spill_dir=str(tmp_path)))
    errors = []

    def work(t):
        rng = np.random.default_rng(t)
        last = {}
        try:
            for _ in range(40):
                s = t * per + int(rng.integers(per))
                if s not in last or rng.random() < 0.5:
                    last[s] = _rand(rng, (64,))
                    store.put(s, last[s])
                else:
                    got = (store.prefetch(s).result() if rng.random() < 0.5
                           else store.get_decoded(s))
                    assert np.array_equal(got.numpy(), last[s])
        except Exception as e:  # noqa: BLE001 - reported through errors
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    with store._lock:
        assert store.dram_bytes == sum(e.nbytes for e in store._dram.values()) <= 2 * 64 * 8
    assert store.stats["spills"] > 0 and store.stats["spill_loads"] > 0
    store.close()
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("mode", TS.AT_REST_DTYPES)
def test_spill_reload_is_bit_stable(mode, tmp_path):
    """A zero budget puts every shard on disk; a reload decodes to exactly
    what the DRAM tier would (the payload crosses the disk unchanged)."""
    rng = np.random.default_rng(7)
    store = TS.ShardStore(4, 128, (), torch.complex64,
                          TS.StorageConfig(at_rest_dtype=mode, dram_bytes=0,
                                           spill_dir=str(tmp_path)))
    shards = [_rand(rng, (128,)) for _ in range(4)]
    for s, arr in enumerate(shards):
        store.put(s, arr)
    assert store.resident_shards() == ()
    for s, arr in enumerate(shards):
        want = TS.decode_shard(TS.encode_shard(arr, mode)[0])
        assert torch.equal(store.get_decoded(s), want)
    if mode == "exact":
        assert store.error_bound == 0.0
    assert store.timing["spill_write_bytes"] > 0 and store.timing["spill_read_bytes"] > 0
    store.close()
    assert not os.listdir(tmp_path)


def test_truncated_spill_file_is_a_typed_error(tmp_path):
    store = TS.ShardStore(2, 64, (), torch.complex64,
                          TS.StorageConfig(dram_bytes=0, spill_dir=str(tmp_path)))
    store.put(0, _rand(np.random.default_rng(3), (64,)))
    (path,) = store._disk.values()
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 8)
    with pytest.raises(SpillIOError):
        store.get_decoded(0)
    store.close()


def _remap_specs():
    rng = np.random.default_rng(21)
    specs = []
    for _ in range(4):
        src = [int(b) for b in rng.permutation(9)]
        flips = sorted(int(b) for b in rng.choice(9, size=int(rng.integers(0, 4)), replace=False))
        specs.append((src, flips))
    specs.append((list(range(9)), [0, 7]))  # flips only
    specs.append(([5, 6, 7, 8, 4, 0, 1, 2, 3], []))  # swap the low and high bits: m=4
    return specs


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("mode,budget", [("exact", None), ("exact", 3), ("int8", 2),
                                         ("bf16", 5)])
def test_remap_matches_reference(lead, mode, budget, tmp_path):
    """``ShardStore.remap`` (random permutations of 9 bits with flips on
    local, moved and fixed bits, L=5): the reference's shards bit for bit,
    its puts, gets and error bound, and no more spills (the port takes each
    input out as it reads it, the reference re-admits it and deletes it
    after the group)."""
    rng = np.random.default_rng(5)
    rows = int(np.prod(lead, dtype=int))
    dram = None if budget is None else int(budget * 32 * rows * TS.AT_REST_BYTES_PER_AMP[mode])
    for src, flips in _remap_specs():
        state = _rand(rng, lead + (512,))
        ref = RS.ShardStore(16, 32, lead, np.complex64, RS.StorageConfig(
            at_rest_dtype=mode, dram_bytes=dram, spill_dir=str(tmp_path / "r"))).fill(state)
        port = TS.ShardStore(16, 32, lead, torch.complex64, TS.StorageConfig(
            at_rest_dtype=mode, dram_bytes=dram, spill_dir=str(tmp_path / "p"))).fill(state)
        spec = RefRemapSpec(src_bit_of=tuple(src), flip_bits=tuple(flips))
        ref.remap(spec, 9)
        port.remap(spec, 9)
        for s in range(16):
            assert np.array_equal(port.get_decoded(s).numpy(), ref.get_decoded(s)), (src, flips)
        for k in ("puts", "gets", "remaps"):
            assert port.stats[k] == ref.stats[k], k
        assert port.stats["spills"] <= ref.stats["spills"]
        assert port.stats["spill_loads"] <= ref.stats["spill_loads"]
        assert len(port.resident_shards()) + len(port.spilled_shards()) == 16
        assert port.error_bound == pytest.approx(ref.error_bound, rel=1e-5)
        if mode == "exact":  # a permutation of the state, exactly
            want = np.empty_like(state)
            idx = np.arange(512)
            old = np.zeros(512, dtype=np.int64)
            for p, b in enumerate(src):
                old |= ((idx >> p) & 1) << b
            for b in flips:
                old ^= 1 << b
            want[..., :] = state[..., old]
            got = port.gather().numpy()
            assert np.array_equal(got, want)
        ref.close()
        port.close()


# ======================================================================
# engine runs through the store
# ======================================================================

def _budget(dtype, shards=2, L=5, rows=1):
    return int(TS.AT_REST_BYTES_PER_AMP[dtype] * (1 << L) * shards * rows)


def _pair(dtype, spilled, circ=C8, L=5, R=3, tol=0.05, **kw):
    spec = dtype + (f":dram_bytes={_budget(dtype)}" if spilled else "") + f":tol={tol}"
    ref = ref_engine_for(circ, L, R, 0, backend="offload", cache=None, storage=spec)
    port = engine_for(PCircuit.from_json(circ.to_json()), L, R, 0, backend="offload",
                      cache=None, storage=spec, device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("spilled", [False, True])
@pytest.mark.parametrize("dtype", TS.AT_REST_DTYPES)
def test_store_run_matches_reference(dtype, spilled):
    """A flat run through the store: exact within atol 1e-5 of the
    reference's run and of the oracle; bf16/int8 within each run's reported
    bound of the oracle and of each other; the same plan, launches per op
    and shard, snapshot keys and counters."""
    ref, port = _pair(dtype, spilled)
    ops.reset_kernel_counters()
    got = port.run().numpy()
    want = np.asarray(ref.run()).reshape(-1)
    counts = port.op_counts()
    S = port.backend.S
    assert ops.kernel_call_counts() == {"fused": S * counts.get("fused", 0),
                                        "shm": S * counts.get("shm", 0)}
    snap, rsnap = port.backend.storage_snapshot(), ref.backend.storage_snapshot()
    assert sorted(snap) == sorted(rsnap)
    assert snap is port.provenance["storage"]
    assert snap["at_rest_dtype"] == dtype and snap["n_shards"] == rsnap["n_shards"]
    for k in ("puts", "gets", "remaps", "prefetches"):
        assert snap[k] == rsnap[k], k
    if spilled:
        assert snap["spills"] > 0 and snap["spill_loads"] > 0
        assert snap["spilled_shards"] * 2 >= snap["n_shards"]
    else:
        assert snap["spills"] == rsnap["spills"] == 0
    if dtype == "exact":
        assert snap["error_bound"] == 0.0
        assert_states_close(got, want, atol=1e-5)
        assert_states_close(got, REF8, atol=1e-5)
    else:
        assert snap["error_bound"] == pytest.approx(rsnap["error_bound"], rel=1e-3)
        assert np.linalg.norm(got - REF8) <= snap["error_bound"] + 1e-5
        assert np.linalg.norm(got - want) <= snap["error_bound"] + rsnap["error_bound"] + 1e-5
        assert snap["relative_error_bound"] <= snap["error_tolerance"]
    for k in ("shard_transfers", "host_remaps", "stage_streams", "memory_passes"):
        assert port.backend.stats[k] == ref.backend.stats[k], k
    kinds = [t["kind"] for t in port.backend.trace]
    assert kinds.count("stage") == len(port.cc.programs) and kinds[-1] == "gather"
    assert all("store" in t for t in port.backend.trace if t["kind"] in ("stage", "remap"))


@pytest.mark.parametrize("prefetch", [True, False])
def test_store_spills_less_than_the_reference(prefetch):
    """Half the shards spilled: each stage streams the resident shards
    first (``stream_order``) and a remap or the gather reads a shard
    without re-admitting it, so a stage moves only the spilled half through
    the disk. The same state as the reference's with fewer spills and
    reloads; without prefetch (no worker racing the LRU order) a stage
    reads and writes exactly the spilled half."""
    spec = f"exact:dram_bytes={_budget('exact', shards=4)}:prefetch={int(prefetch)}"
    ref = ref_engine_for(C8, 5, 3, 0, backend="offload", cache=None, storage=spec)
    port = engine_for(P8, 5, 3, 0, backend="offload", cache=None, storage=spec, device="cpu")
    assert_states_close(port.run().numpy(), np.asarray(ref.run()), atol=1e-5)
    snap, rsnap = port.backend.storage_snapshot(), ref.backend.storage_snapshot()
    assert snap["spills"] < rsnap["spills"] and snap["spill_loads"] < rsnap["spill_loads"]
    stages = [t["store"] for t in port.backend.trace if t["kind"] == "stage"]
    assert stages
    if not prefetch:
        for st in stages:
            assert st["spill_read_bytes"] == st["spill_write_bytes"] == 4 * (8 << 5)


@pytest.mark.parametrize("dtype", ["exact", "int8"])
def test_store_batch_matches_reference(dtype):
    rng = np.random.default_rng(3)
    B = 3
    psi0s = rng.standard_normal((B, 256)) + 1j * rng.standard_normal((B, 256))
    psi0s = (psi0s / np.linalg.norm(psi0s, axis=1, keepdims=True)).astype(np.complex64)
    spec = f"{dtype}:dram_bytes={_budget(dtype, rows=B)}:tol=0.5"
    ref = ref_engine_for(C8, 5, 3, 0, backend="offload", cache=None, storage=spec)
    port = engine_for(P8, 5, 3, 0, backend="offload", cache=None, storage=spec, device="cpu")
    ops.reset_kernel_counters()
    got = port.run_batch(psi0s).numpy()
    assert ops.kernel_call_counts()["fused"] == port.backend.S * port.op_counts().get("fused", 0)
    want = np.asarray(ref.run_batch(psi0s))
    snap = port.backend.storage_snapshot()
    assert got.shape == (B, 256) and snap["spills"] > 0
    for b in range(B):
        oracle = simulate_np(C8, psi0=psi0s[b])
        if dtype == "exact":
            assert_states_close(got[b], want[b], atol=1e-5, msg=f"row {b}")
            assert_states_close(got[b], oracle, atol=1e-5, msg=f"row {b}")
        else:
            assert np.linalg.norm(got[b] - oracle) <= snap["error_bound"] + 1e-5


@pytest.mark.parametrize("dtype", ["exact", "bf16"])
def test_store_sweep_matches_reference(dtype):
    n = 6
    sym = _ansatz(n)
    spec = f"{dtype}:dram_bytes={ {'exact': 512, 'bf16': 256}[dtype]}"
    ref = ref_engine_for(sym, 4, 2, 0, backend="offload", cache=None, storage=spec)
    port = engine_for(PCircuit.from_json(sym.to_json()), 4, 2, 0, backend="offload",
                      cache=None, storage=spec, device="cpu")
    batch = np.stack([_vals(n, s) for s in (7, 8)])
    got = port.run_sweep(None, batch).numpy()
    want = np.asarray(ref.run_sweep(None, batch))
    snap = port.backend.storage_snapshot()
    assert got.shape == (2, 2**n) and snap["spills"] > 0
    for p in range(2):
        oracle = simulate_np(_ansatz(n, list(batch[p])))
        if dtype == "exact":
            assert_states_close(got[p], want[p], atol=1e-5)
            assert_states_close(got[p], oracle, atol=1e-5, msg=f"sweep point {p}")
        else:
            assert np.linalg.norm(got[p] - oracle) <= snap["error_bound"] + 1e-5
    assert port.bound_circuit is None


def test_store_overlap_ratio_holds():
    _, port = _pair("exact", True)
    port.run()
    assert port.backend.overlap_ratio >= 0.8
    assert port.backend.stats["overlapped_dispatches"] > 0


def test_store_run_packed_measures_like_the_exact_run():
    _, port = _pair("exact", True)
    plain = engine_for(P8, 5, 3, 0, backend="offload", cache=None, device="cpu")
    a, b = port.run_packed(), plain.run_packed()
    assert torch.equal(a, b)


def test_tolerance_violation_is_typed(tmp_path):
    port = engine_for(P8, 5, 3, 0, backend="offload", cache=None, device="cpu",
                      storage=f"int8:dram_bytes={_budget('int8')}:tol=1e-6:dir={tmp_path}")
    with pytest.raises(StorageToleranceError):
        port.run()
    assert not isinstance(StorageToleranceError(""), TRANSIENT_ERRORS)
    assert not os.listdir(tmp_path)  # the failed run removed its spill files


@pytest.mark.parametrize("site", ["spill.write", "spill.read"])
def test_spill_io_error_is_typed_and_transient(site, tmp_path):
    spec = f"exact:dram_bytes={_budget('exact')}:dir={tmp_path}"
    with faults.inject(FaultPlan(seed=2).add("spill_io_error", count=1, site=site)):
        with pytest.raises(SpillIOError) as ei:
            engine_for(P8, 5, 3, 0, backend="offload", cache=None, storage=spec,
                       device="cpu").run()
    assert isinstance(ei.value, ShardTransferError) and isinstance(ei.value, TRANSIENT_ERRORS)
    assert ei.value.injected
    assert not os.listdir(tmp_path)
    out = engine_for(P8, 5, 3, 0, backend="offload", cache=None, storage=spec,
                     device="cpu").run().numpy()
    assert_states_close(out, REF8)


def test_shard_transfer_error_in_the_store_loop(tmp_path):
    spec = f"exact:dram_bytes={_budget('exact')}:dir={tmp_path}"
    with faults.inject(FaultPlan(seed=1).add("shard_transfer_error", after=3, count=1)):
        with pytest.raises(ShardTransferError):
            engine_for(P8, 5, 3, 0, backend="offload", cache=None, storage=spec,
                       device="cpu").run()
    assert not os.listdir(tmp_path)


def test_storage_snapshot_keys_match_reference():
    ref, port = _pair("bf16", True)
    port.run()
    ref.run()
    assert sorted(port.provenance["storage"]) == sorted(ref.provenance["storage"])
    assert port.provenance["storage"]["at_rest_dtype"] == "bf16"


# ======================================================================
# keying, env, guard rails and the CLI
# ======================================================================

def test_circuit_key_separates_storage_tiers():
    base = dict(L=5, R=3, G=0, backend="offload", device="cpu")
    keys = {circuit_key_for(P8, storage=s, **base).digest
            for s in (None, "exact", "bf16", "exact:dram_kib=1")}
    assert len(keys) == 4
    assert circuit_key_for(P8, storage="off", **base) == circuit_key_for(P8, **base)


def test_storage_env_forces_offload_tier(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_STORAGE", "exact:dram_kib=1")
    eng = engine_for(P8, 5, 3, 0, backend="offload", cache=None, device="cpu")
    assert eng.backend.storage is not None
    assert_states_close(eng.run().numpy(), REF8)
    assert eng.backend.storage_snapshot()["spills"] > 0
    cud = engine_for(P8, 8, 0, 0, backend="cuda", cache=None, device="cpu")
    assert_states_close(cud.run().numpy(), REF8)
    ckpt = engine_for(P8, 5, 3, 0, backend="offload", cache=None, device="cpu",
                      checkpoint_dir=str(tmp_path))
    assert ckpt.backend.storage is None  # checkpoints keep the env's store away


def test_storage_rejected_for_non_offload_backend_and_with_checkpoints(tmp_path):
    with pytest.raises(ValueError, match="storage"):
        engine_for(P8, 8, 0, 0, backend="cuda", cache=None, storage="exact", device="cpu")
    with pytest.raises(ValueError, match="offload"):
        engine_for(P8, 8, 0, 0, backend="cuda", cache=None, checkpoint_dir=str(tmp_path),
                   device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        OffloadBackend(storage="int8", checkpoint_dir=str(tmp_path))


def test_cli_storage(capsys, tmp_path):
    run = cli(["--circuit", "qft", "--n", "9", "--L", "6", "--R", "3", "--executor", "offload",
               "--storage", "int8", "--dram-budget-mb", "0.001", "--spill-dir", str(tmp_path),
               "--storage-tol", "0.2", "--check", "--device", "cpu"])
    out = capsys.readouterr().out
    snap = run.engine.provenance["storage"]
    assert snap["spills"] > 0 and snap["error_tolerance"] == 0.2
    assert snap["dram_budget_bytes"] == int(0.001 * (1 << 20))
    assert "storage: at-rest int8" in out and "reloads; error bound" in out
    assert abs(run.fidelity - 1.0) <= 2 * snap["relative_error_bound"] + 1e-5
    assert not os.listdir(tmp_path)
    with pytest.raises(SystemExit):
        cli(["--circuit", "qft", "--n", "8", "--L", "5", "--R", "3", "--storage", "int8",
             "--device", "cpu"])
