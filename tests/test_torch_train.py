"""The port's training substrate on the CPU, held to the JAX package's: the
twins of ``tests/test_train.py``'s optimizer, checkpoint, fault-tolerance
and data tests on torch tensors; the synthetic data bit for bit against
``repro.data.synthetic``; checkpoints written by either package restored
by the other; AdamW's name->tensor form against the reference's update on
the same tree; and remat's gradients against no remat."""

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import configs, flat, port_model, ref_params, unflat
from repro.data import synthetic as r_synthetic
from repro.optim import adamw as r_adamw
from repro.train import checkpoint as r_checkpoint
from repro_torch.convert import adamw_state_from_reference
from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from repro_torch.launch import steps
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import RunJournal, StragglerMonitor


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread, so the suite's other
    workers, and the rank processes that other test files run under
    ``nice``, keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ twins of tests/test_train.py


def test_adamw_matches_reference():
    """One step of the port's AdamW (fp32 moments, name->tensor form) vs a
    hand-rolled numpy Adam."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=1_000_000,
                            weight_decay=0.0, clip_norm=1e9,
                            moment_dtype="float32", min_lr_frac=1.0)
    params = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    grads = {"w": torch.tensor([[0.1, -0.2], [0.3, 0.4]])}
    state = adamw.init(cfg, params)
    new_p, state, _ = adamw.update(cfg, grads, state, params)

    g = np.array([[0.1, -0.2], [0.3, 0.4]])
    m = 0.1 * g
    v = 0.05 * g * g
    mhat = m / (1 - 0.9)
    vhat = v / (1 - 0.95)
    ref = np.array([[1.0, -2.0], [0.5, 3.0]]) - 1e-2 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), ref, atol=1e-6)
    assert new_p["w"] is params["w"] and int(state.step) == 1  # written in place


def test_adamw_clip_and_decay():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, clip_norm=0.1,
                            weight_decay=0.5, min_lr_frac=1.0, total_steps=10**6)
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.ones((4, 4)) * 100.0}
    state = adamw.init(cfg, params)
    _, _, metrics = adamw.update(cfg, grads, state, params)
    assert float(metrics["grad_norm"]) == pytest.approx(400.0)


def test_checkpoint_roundtrip_bf16():
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=2)
        state = {
            "a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": {"c": torch.ones((3,), dtype=torch.float32),
                  "s": torch.zeros((), dtype=torch.int32)},
        }
        ck.save(1, state, blocking=True)
        ck.save(2, state, blocking=True)
        ck.save(3, state, blocking=True)
        assert ck.all_steps() == [2, 3]  # keep=2 garbage-collects step 1
        out = ck.restore(3, state)
        assert out["a"].dtype == torch.bfloat16
        torch.testing.assert_close(out["a"], state["a"], rtol=0, atol=0)
        torch.testing.assert_close(out["b"]["s"], state["b"]["s"], rtol=0, atol=0)


def test_checkpoint_async_then_restore():
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=3, async_save=True)
        state = {"w": torch.ones((8, 8))}
        ck.save(5, state)
        state["w"].mul_(2.0)  # the save copied the leaf first: the file keeps ones
        ck.wait()
        step, out = ck.restore_latest({"w": torch.zeros((8, 8))})
        assert step == 5
        np.testing.assert_array_equal(out["w"].numpy(), np.ones((8, 8)))


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0, warmup=2)
    for i in range(5):
        assert not mon.record(i, 0.1)
    assert mon.record(5, 0.5)  # 5x slower -> flagged
    assert mon.flagged == [5]
    assert not mon.record(6, 0.11)


def test_run_journal_restarts():
    with tempfile.TemporaryDirectory() as d:
        j = RunJournal(os.path.join(d, "journal.json"))
        j.update(10)
        assert j.read()["last_step"] == 10
        assert j.mark_restart() == 1
        assert j.mark_restart() == 2


def test_data_determinism_and_signal():
    cfg = SyntheticConfig(vocab_size=101, seq_len=32, global_batch=4, seed=7)
    a = SyntheticDataset(cfg).batch(3)
    b = SyntheticDataset(cfg).batch(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    # labels are next-token shifted
    full_a = np.concatenate([a["tokens"], a["labels"][:, -1:]], axis=1)
    np.testing.assert_array_equal(full_a[:, 1:-1], a["labels"][:, :-1])
    # different steps differ
    c = SyntheticDataset(cfg).batch(4)
    assert not np.array_equal(a["tokens"], c["tokens"])


# ------------------------------------------------------- against the reference


@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 503, 64, 8), (7, 101, 32, 4),
                                                  (12345, 151936, 17, 3)])
def test_data_is_the_references_bit_for_bit(seed, vocab, seq, batch):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    ref = r_synthetic.SyntheticDataset(r_synthetic.SyntheticConfig(**kw))
    got = SyntheticDataset(SyntheticConfig(**kw))
    np.testing.assert_array_equal(ref.succ, got.succ)
    for step in (0, 1, 19, 20, 1000):
        rb, gb = ref.batch(step), got.batch(step)
        assert sorted(rb) == sorted(gb)
        for k in rb:
            assert rb[k].dtype == gb[k].dtype
            np.testing.assert_array_equal(rb[k], gb[k])
    for (rs, rb), gb in zip(zip(range(3), ref), got):
        np.testing.assert_array_equal(rb["tokens"], gb["tokens"])


@functools.lru_cache(maxsize=None)
def _reference_state(name, moment_dtype):
    """A reduced model's reference weights and an AdamW state after one
    update (moments nonzero, bf16 or fp32), as numpy (read, never written)."""
    ref_cfg, cfg = configs(name, "float32")
    params = ref_params(ref_cfg)
    opt_cfg = r_adamw.AdamWConfig(moment_dtype=moment_dtype, warmup_steps=0)
    grads = jax.tree.map(lambda p: jnp.asarray(np.random.default_rng(p.size).normal(
        size=p.shape), jnp.float32), params)
    update = jax.jit(r_adamw.update, static_argnums=0)
    p1, s1, _ = update(opt_cfg, grads, r_adamw.init(opt_cfg, params), params)
    return cfg, jax.tree.map(np.asarray, p1), jax.tree.map(np.asarray, s1)


def _port_state(cfg, params, state):
    model = port_model(cfg, params)
    return model, {"params": dict(model.named_parameters()),
                   "opt": adamw_state_from_reference(model, state)}


def _assert_same_arrays(ref_flat: dict, port_flat: dict):
    assert sorted(ref_flat) == sorted(port_flat)
    for k in ref_flat:
        r, p = np.asarray(ref_flat[k]), port_flat[k]
        assert str(r.dtype) == str(p.dtype).removeprefix("torch."), k
        np.testing.assert_array_equal(r.astype(np.float32) if r.dtype != np.int32 else r,
                                      p.detach().to(torch.float32).numpy()
                                      if p.is_floating_point() else p.numpy(), err_msg=k)


def _port_flat(state):
    out = {f"params.{k}": v for k, v in state["params"].items()}
    out["opt..step"] = state["opt"].step
    for part in ("m", "v"):
        out.update({f"opt..{part}.{k}": v for k, v in getattr(state["opt"], part).items()})
    return out


def _ref_flat(state):
    out = {f"params.{k}": v for k, v in flat(state["params"]).items()}
    out["opt..step"] = state["opt"].step
    for part in ("m", "v"):
        out.update({f"opt..{part}.{k}": v for k, v in flat(getattr(state["opt"], part)).items()})
    return out


@pytest.mark.parametrize("name,moment_dtype", [("qwen2-1.5b", "bfloat16"),
                                               ("deepseek-v2-lite-16b", "float32")])
def test_reference_checkpoint_restores_in_the_port(tmp_path, name, moment_dtype):
    cfg, params, state = _reference_state(name, moment_dtype)
    r_checkpoint.CheckpointManager(str(tmp_path), keep=2).save(
        7, {"params": params, "opt": state}, blocking=True)
    _, like = _port_state(cfg, params, state)
    step, got = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 7 and got["opt"].m[next(iter(got["opt"].m))].dtype == (
        torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32)
    _assert_same_arrays(_ref_flat({"params": params, "opt": state}), _port_flat(got))


@pytest.mark.parametrize("name,moment_dtype", [("qwen2-1.5b", "bfloat16"),
                                               ("deepseek-v2-lite-16b", "float32")])
def test_port_checkpoint_restores_in_the_reference(tmp_path, name, moment_dtype):
    cfg, params, state = _reference_state(name, moment_dtype)
    _, saved = _port_state(cfg, params, state)
    CheckpointManager(str(tmp_path), keep=2).save(7, saved, blocking=True)
    with np.load(tmp_path / "step_00000007" / "state.npz") as z:
        keys = set(z.files)
    ref_keys = set(r_checkpoint._flatten({"params": params, "opt": state}))
    assert keys == ref_keys  # the reference's file, key for key
    like = {"params": jax.tree.map(np.zeros_like, params), "opt": state}
    step, got = r_checkpoint.CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 7
    _assert_same_arrays(_ref_flat(got), _port_flat(saved))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_named_form_matches_the_references_update(moment_dtype):
    """Three updates of a reduced model's tree with random gradients (clip
    active, decay on matrices only) in both packages. float32 moments: the
    parameters within 1e-6. bf16 moments: the two packages' float32 moments
    may round to neighbouring bf16 values, which moves an element's update
    by up to ~2^-7 of lr, so the parameters are held within lr * 2^-6 a
    step, and the moments within a bf16 ulp of the leaf's largest moment
    (float32: 1e-6 of it)."""
    cfg, params, _ = _reference_state("qwen2-1.5b", moment_dtype)
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=0.5, moment_dtype=moment_dtype)
    r_cfg, p_cfg = r_adamw.AdamWConfig(**opt), adamw.AdamWConfig(**opt)
    rp = jax.tree.map(jnp.asarray, params)
    rs = r_adamw.init(r_cfg, rp)
    model = port_model(cfg, params)
    pp = dict(model.named_parameters())
    ps = adamw.init(p_cfg, pp)
    rng = np.random.default_rng(0)
    r_update = jax.jit(r_adamw.update, static_argnums=0)
    for step in range(1, 4):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in flat(params).items()}
        rtree = unflat(params, {k: jnp.asarray(g) for k, g in grads.items()})
        rp, rs, rm = r_update(r_cfg, rtree, rs, rp)
        pp, ps, pm = adamw.update(p_cfg, {k: torch.from_numpy(g) for k, g in grads.items()},
                                  ps, pp)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), rtol=1e-7)
        atol = 1e-6 if moment_dtype == "float32" else step * p_cfg.lr * 2**-6
        for k, v in flat(rp).items():
            np.testing.assert_allclose(pp[k].detach().numpy(), np.asarray(v), rtol=0,
                                       atol=atol, err_msg=k)
        for k, v in flat(rs.m).items():
            v = np.asarray(v, np.float32)
            ulp = 2**-7 if moment_dtype == "bfloat16" else 1e-6
            np.testing.assert_allclose(ps.m[k].float().numpy(), v, rtol=0,
                                       atol=ulp * float(np.abs(v).max()), err_msg=k)


def test_adamw_chunked_update_is_the_whole_leafs(monkeypatch):
    """A leaf updated a chunk at a time gives the bits of one update of the
    whole leaf, decay following the leaf's rank and not the chunk's."""
    rng = np.random.default_rng(1)
    shapes = {"w": (3, 7, 5), "b": (11,)}
    p0 = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    g = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.3)
    out = []
    for chunk in (adamw.CHUNK, 4):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        p = {k: v.clone() for k, v in p0.items()}
        s = adamw.init(cfg, p)
        for _ in range(2):
            p, s, _ = adamw.update(cfg, g, s, p)
        out.append((p, s))
    for k in shapes:
        for a, b in ((out[0][0][k], out[1][0][k]), (out[0][1].m[k], out[1][1].m[k]),
                     (out[0][1].v[k], out[1][1].v[k])):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the list form (the VQE's) on the same inputs: the same numbers
    pl = [p0["w"].clone(), p0["b"].clone()]
    sl = adamw.init(cfg, pl)
    for _ in range(2):
        pl, sl, _ = adamw.update(cfg, [g["w"], g["b"]], sl, pl)
    torch.testing.assert_close(pl[0], out[0][0]["w"], rtol=0, atol=0)
    torch.testing.assert_close(pl[1], out[0][0]["b"], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "jamba-1.5-large-398b"])
def test_remat_gives_the_gradients_of_no_remat(name):
    _, cfg = configs(name, "float32")
    a = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    b = Model(cfg, device="cpu", remat=False)
    b.load_state_dict(a.state_dict())
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    grads = []
    for model in (a, b):
        loss, _ = model.loss(batch)
        names = [k for k, _ in model.named_parameters()]
        grads.append((loss.detach().item(), dict(zip(names, torch.autograd.grad(
            loss, list(model.parameters()), allow_unused=True, materialize_grads=True)))))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    for k, g in grads[0][1].items():
        torch.testing.assert_close(g, grads[1][1][k], rtol=1e-6, atol=1e-6 * float(
            g.abs().max()), msg=k)


def test_build_model_and_train_step_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = configs("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steps.build_model(cfg, remat=True)
