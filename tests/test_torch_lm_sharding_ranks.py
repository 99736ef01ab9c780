"""The port's LM on a mesh of gloo CPU ranks against the reference, on the
reference's weights (carried by ``repro_torch.convert``), reduced, float32.
Ranks are spawned twice for the module (``repro_torch.sim.ranks.run_ranks``,
one thread each, under ``nice``; the rank side is
``tests/_torch_lm_sharding_ranks.py``): 4 ranks as data 2 x model 2, then 8.

* **Forward, prefill and decode on 2x2** for every arch of the registry
  (dense GQA, MLA, MoE with shared experts, Mamba-2, the hybrid, the
  audio encoder-decoder and cross-attention on vision patches, MTP):
  logits within 1e-4 of the largest logit, caches within 1e-4 of their
  largest entry (``tests/test_torch_lm_models.py``'s bounds).
* **Three train steps on 2x2** for every arch in float32 (and qwen2 with
  bf16 moments and 2 microbatches), against the reference's meshless
  jitted step, with ``tests/test_torch_train_steps.py``'s bounds or twice
  the reference's own rounding floor where that is larger (jamba's MoE
  moves a parameter by lr when the reference's embedding moves by one
  ulp).
* **Elastic restore**: the 2x2 qwen2 run's checkpoint after 3 steps is read
  by the reference's ``CheckpointManager``, restored on 8 ranks as 4x2, and
  2 more steps there match 5 uninterrupted reference steps.
* **MoE's exchange on 2x4** (the twin of the reference's
  ``test_moe_ep_sharded_matches_single``, 8 ranks), its gradient, and
  capacity per data shard.

The reference's sharded paths are red under jax 0.9 (``ROADMAP.md`` C), so
the oracle for a data-sharded MoE is the reference's meshless function on
each data shard's rows: the reference computes capacity and the aux loss per
data shard (``repro/models/moe.py``: ``cap`` from the local token count,
``pmean`` of the aux), so on a mesh its loss is the mean of the shards'
losses, which its meshless step with one microbatch per data shard
computes."""

import dataclasses
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_lm_sharding_ranks as rank_side
from _torch_lm import configs, extras_for, flat, one_ulp, ref_params
from repro.configs import registry as r_registry
from repro.launch import steps as r_steps
from repro.models.moe import moe_apply as r_moe_apply
from repro.models.moe import moe_params as r_moe_params
from repro.models.transformer import Model as RefModel
from repro.optim import adamw as r_adamw
from repro.train.checkpoint import CheckpointManager as RefCheckpoints
from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from repro_torch.sim.ranks import run_ranks

LR = 2e-3
ARCHS = tuple(sorted(r_registry.ARCHS))
# a MoE's capacity and aux are per data shard (the module's docstring)
MOE = tuple(n for n in ARCHS if r_registry.get_arch(n).is_moe)
TRAINS = {"qwen2-f32": ("qwen2-1.5b", "float32", 1),
          "qwen2-bf16-mb2": ("qwen2-1.5b", "bfloat16", 2),
          **{f"{n}-f32": (n, "float32", 1) for n in ARCHS if n != "qwen2-1.5b"}}
# the 4-rank spawn's jobs, in order
KEYS4 = [("serve", n) for n in ARCHS] + [("train", k) for k in TRAINS] + [("policy",)]
EXCHANGES = {"drop-free": (4, {"moe_capacity_factor": 8.0}), "default": (4, {}),
             "replicated": (3, {})}
B, S, PROMPT, DECODE = 4, 16, 8, 3


def _tokens():
    return np.random.default_rng(11).integers(0, 503, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _extras(name):
    """The arch's audio/vision stub input for the batch (bf16): the
    reference's dict and the ranks' (float32 numpy of the same values), or
    (None, None)."""
    ref, _ = extras_for(configs(name, "float32")[0], np.random.default_rng(12), B)
    if ref is None:
        return None, None
    return ref, {k: np.asarray(v, np.float32) for k, v in ref.items()}


def _moe_inputs(over, b):
    cfg = dataclasses.replace(configs("deepseek-v2-lite-16b", "float32")[0], **over)
    key = jax.random.PRNGKey(0)
    p = r_moe_params(key, cfg)
    x = jax.random.normal(key, (b, 16, cfg.d_model), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(1), (b, 16, cfg.d_model), jnp.float32)
    return cfg, jax.tree.map(np.asarray, p), np.asarray(x), np.asarray(w)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two spawns' results (4 ranks, then 8), run in a thread while the
    tests compute the reference's side."""
    tmp = tmp_path_factory.mktemp("lm_sharding")
    ckpt = str(tmp / "ckpt")
    params = {name: ref_params(configs(name, "float32")[0]) for name in ARCHS}
    jobs4 = [("serve", (2, 2), dict(name=n, params=params[n], tokens=_tokens(), prompt=PROMPT,
                                    steps=DECODE, over={}, extras=_extras(n)[1]))
             for n in ARCHS]
    jobs4 += [("train", (2, 2), dict(name=n, params=params[n], moment_dtype=md,
                                     microbatches=mb, steps=3, lr=LR, extras=_extras(n)[1],
                                     save=ckpt if key == "qwen2-f32" else ""))
              for key, (n, md, mb) in TRAINS.items()]
    jobs4.append(("policy", (2, 2), {}))
    jobs8 = []
    for b, over in EXCHANGES.values():
        _, p, x, w = _moe_inputs(over, b)
        jobs8.append(("exchange", (2, 4), dict(p=p, x=x, w=w, over=over)))
    jobs8.append(("train", (4, 2), dict(name="qwen2-1.5b", params=params["qwen2-1.5b"],
                                        moment_dtype="float32", microbatches=1, steps=2, lr=LR,
                                        start=3, restore=ckpt)))
    out, done = {}, {4: threading.Event(), 8: threading.Event()}

    def go():
        try:
            for world, jobs in ((4, jobs4), (8, jobs8)):
                out[world] = run_ranks(rank_side.main, world, str(tmp / "rdv"), args=(jobs,),
                                       timeout=400, threads=1)
                done[world].set()
        except Exception as e:  # raised again in the tests
            out["error"] = e
        finally:
            for ev in done.values():
                ev.set()

    t = threading.Thread(target=go, daemon=True)
    t.start()
    yield {"done": done, "out": out, "ckpt": ckpt}
    t.join(timeout=900)


def _results(runs, world):
    """Rank 0's results of the ``world``-rank spawn, after checking that
    every rank's scalars are rank 0's."""
    assert runs["done"][world].wait(timeout=900), "the rank runs overran"
    if "error" in runs["out"]:
        raise runs["out"]["error"]
    per_rank = runs["out"][world]
    first = rank_side._scalars(per_rank[0])
    for r, other in enumerate(per_rank[1:], 1):
        assert other == first, f"rank {r} differs from rank 0"
    return per_rank[0]


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale, err_msg=what)


# ------------------------------------------------------------ the reference


@functools.lru_cache(maxsize=None)
def _ref_fns(name):
    """The reference's model, weights and jitted serving functions."""
    ref_cfg = configs(name, "float32")[0]
    model = RefModel(ref_cfg, remat=False)
    fwd = jax.jit(lambda p, t, ex: (
        model.forward(p, t, extras=ex)[0],
        model.loss(p, {"tokens": t, "labels": jnp.roll(t, -1, 1), **(ex or {})})[1]))
    prefill = jax.jit(lambda p, t, ex: model.prefill(p, t, extras=ex, cache_len=S))
    decode = jax.jit(lambda p, t, c, ex: model.decode_step(p, t, c, extras=ex))
    return ref_params(ref_cfg), fwd, prefill, decode


def _ref_serve(name, rows):
    """The reference's meshless forward logits, loss metrics, prefill and
    decode (logits, caches) on ``rows`` of the batch."""
    params, fwd, prefill, decode = _ref_fns(name)
    toks = jnp.asarray(_tokens()[rows])
    ex = _extras(name)[0]
    ex = None if ex is None else {k: v[rows] for k, v in ex.items()}
    out = dict(zip(("logits", "metrics"), fwd(params, toks, ex)))
    logits, cache = prefill(params, toks[:, :PROMPT], ex)
    out["prefill"], out["prefill_cache"] = logits, flat(cache)
    for i in range(DECODE):
        logits, cache = decode(params, toks[:, PROMPT + i: PROMPT + i + 1], cache, ex)
        out[f"decode{i}"] = logits
    out["decode_cache"] = flat(cache)
    return jax.tree.map(np.asarray, out)


def _ref_serve_sharded(name):
    """The reference on each data shard's rows (a MoE's capacity and aux are
    per data shard), joined: logits and caches row-wise, metrics as means."""
    halves = [_ref_serve(name, slice(0, B // 2)), _ref_serve(name, slice(B // 2, B))]
    out = {}
    for k, v in halves[0].items():
        if k == "metrics":
            out[k] = {m: np.mean([h[k][m] for h in halves]) for m in v}
        elif k.endswith("cache"):
            out[k] = {c: (v[c] if np.ndim(v[c]) == 0 else np.concatenate(
                [h[k][c] for h in halves], axis=1 if c.startswith("body.") else 0))
                for c in v}
        else:
            out[k] = np.concatenate([h[k] for h in halves], axis=0)
    return out


@functools.lru_cache(maxsize=None)
def _ref_step(name, moment_dtype, microbatches):
    ref_cfg = configs(name, "float32")[0]
    opt = r_adamw.AdamWConfig(lr=LR, warmup_steps=2, total_steps=10, moment_dtype=moment_dtype)
    return opt, jax.jit(r_steps.make_train_step(RefModel(ref_cfg), opt, microbatches))


def _ref_run(name, moment_dtype, microbatches, steps, params):
    """``steps`` of the reference's meshless jitted step from ``params``:
    each step's metrics, parameters and optimizer state. Inputs are put on
    the device first, so the second step reuses the first's compilation."""
    opt, step = _ref_step(name, moment_dtype, microbatches)
    ref_cfg = configs(name, "float32")[0]
    data = SyntheticDataset(SyntheticConfig(vocab_size=ref_cfg.vocab_size, seq_len=16,
                                            global_batch=4, seed=3))
    dev = jax.devices()[0]
    rp = jax.device_put(jax.tree.map(jnp.asarray, params), dev)
    rs = jax.device_put(r_adamw.init(opt, rp), dev)
    ex = _extras(name)[0] or {}
    out = []
    for i in range(steps):
        batch = {**{k: jnp.asarray(v) for k, v in data.batch(i).items()}, **ex}
        rp, rs, m = step(rp, rs, jax.device_put(batch, dev))
        out.append(({k: float(v) for k, v in m.items()}, jax.tree.map(np.asarray, rp), rs))
    return out


@functools.lru_cache(maxsize=None)
def _ref_train(name, moment_dtype, microbatches, steps):
    return _ref_run(name, moment_dtype, microbatches, steps,
                    ref_params(configs(name, "float32")[0]))


@functools.lru_cache(maxsize=None)
def _ref_floors(name, moment_dtype, microbatches, steps):
    """Per step, the reference's own rounding floor: how far its loss (and
    grad norm, relative) and its parameters (the largest move of any entry
    but the embedding's) move, at that step or before, when its run starts
    from weights whose embedding moved by one float32 ulp
    (``tests/test_torch_train_steps.py``'s floor; a MoE whose routing or
    capacity drops flip on rounding moves its parameters by up to lr)."""
    base = _ref_train(name, moment_dtype, microbatches, steps)
    moved = _ref_run(name, moment_dtype, microbatches, steps,
                     one_ulp(ref_params(configs(name, "float32")[0])))
    floors = []
    for (bm, bp, _), (mm, mp, _) in zip(base, moved):
        bp, mp = flat(bp), flat(mp)
        floors.append((abs(mm["loss"] - bm["loss"]) / abs(bm["loss"]),
                       abs(mm["grad_norm"] - bm["grad_norm"]) / bm["grad_norm"],
                       max(float(np.abs(mp[k] - v).max()) for k, v in bp.items()
                           if k != "embed")))
    return np.maximum.accumulate(np.array(floors), axis=0).tolist()


def _hold_steps(ref_steps, got_steps, keys, floors):
    """Each step's loss and grad norm within a relative 1e-5 and its
    parameters within 0.5 lr (``tests/test_torch_train_steps.py``), or
    within twice the reference's own floor (:func:`_ref_floors`) where that
    is larger; ``keys``' metrics within a relative 1e-5."""
    for i, ((rm, rp, _), (gm, gp), (f_loss, f_norm, f_param)) in enumerate(
            zip(ref_steps, got_steps, floors)):
        np.testing.assert_allclose(gm["loss"], rm["loss"], rtol=max(1e-5, 2 * f_loss),
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(gm["grad_norm"], rm["grad_norm"],
                                   rtol=max(1e-5, 2 * f_norm), err_msg=f"step {i}")
        for k in keys:
            np.testing.assert_allclose(gm[k], rm[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        ref_flat = flat(rp)
        assert sorted(gp) == sorted(ref_flat)
        for k, v in ref_flat.items():
            np.testing.assert_allclose(gp[k], v, rtol=0, atol=max(0.5 * LR, 2 * f_param),
                                       err_msg=f"step {i} {k}")


# ---------------------------------------------------------------- the tests


@pytest.mark.parametrize("name", ARCHS)
def test_forward_prefill_and_decode_on_2x2_match_the_reference(runs, name):
    ref = _ref_serve_sharded(name) if name in MOE else _ref_serve(name, slice(None))
    got = _results(runs, 4)[KEYS4.index(("serve", name))]
    _close(got["logits"], ref["logits"], "forward")
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    for k in ["prefill"] + [f"decode{i}" for i in range(DECODE)]:
        _close(got[k], ref[k], k)
    for tag in ("prefill_cache", "decode_cache"):
        assert sorted(got[tag]) == sorted(ref[tag])
        for k, v in ref[tag].items():
            if k == "len":
                assert got[tag][k] == int(v)
            else:
                _close(got[tag][k], v, f"{tag}.{k}")


def test_parameters_are_placed_by_the_rules(runs):
    """qwen2 on 2x2: FSDP over data on d_model, TP over model where the
    rules shard (the fused QKV's heads, d_ff, the vocabulary), the stacked
    reps dim never; AdamW's moments on the parameters' placements; the
    experts of deepseek over the model axis."""
    got = _results(runs, 4)
    pl = got[KEYS4.index(("serve", "qwen2-1.5b"))]["placements"]
    assert pl["embed"] == "(Shard(dim=1), Shard(dim=0))"
    assert pl["body.l0.mixer.wqkv"] == "(Shard(dim=1), Shard(dim=2))"
    assert pl["body.l0.ffn.wi"] == "(Shard(dim=1), Shard(dim=2))"
    assert pl["body.l0.ffn.wo"] == "(Shard(dim=2), Shard(dim=1))"
    assert pl["final_norm.w"] == "(Replicate(), Replicate())"
    train = got[KEYS4.index(("train", "qwen2-f32"))]
    assert train["moment_placements"] == train["placements"] == pl
    ds = got[KEYS4.index(("serve", "deepseek-v2-lite-16b"))]["placements"]
    assert ds["body.l0.ffn.wi"] == "(Shard(dim=2), Shard(dim=1))"
    assert ds["body.l0.ffn.router"] == "(Replicate(), Replicate())"


@pytest.mark.parametrize("key", list(TRAINS))
def test_three_train_steps_on_2x2_match_the_references_step(runs, key):
    name, moment_dtype, microbatches = TRAINS[key]
    got = _results(runs, 4)[KEYS4.index(("train", key))]["steps"]
    if name in MOE:
        microbatches = 2  # per data shard: the reference's step, a microbatch a shard
    steps = 5 if key == "qwen2-f32" else 3
    ref = _ref_train(name, moment_dtype, microbatches, steps)[:3]
    keys = ["lr"] if name in MOE else [k for k in ref[0][0] if k not in ("loss", "grad_norm")]
    assert len(got) == 3
    _hold_steps(ref, got, keys, _ref_floors(name, moment_dtype, microbatches, steps)[:3])


def test_a_2x2_checkpoint_restores_at_4x2_and_continues_as_one_device(runs):
    ref = _ref_train("qwen2-1.5b", "float32", 1, 5)
    saved = _results(runs, 4)[KEYS4.index(("train", "qwen2-f32"))]["steps"][-1][1]
    # the reference's CheckpointManager reads the sharded run's checkpoint
    like = {"params": ref[2][1], "opt": jax.tree.map(np.asarray, ref[2][2])}
    restored = RefCheckpoints(runs["ckpt"]).restore(3, like)
    assert int(restored["opt"].step) == 3
    for k, v in flat(restored["params"]).items():
        np.testing.assert_array_equal(np.asarray(v), saved[k], err_msg=k)
    resumed = _results(runs, 8)[-1]["steps"]
    assert len(resumed) == 2
    _hold_steps(ref[3:], resumed, ["ce_loss", "aux_loss", "lr"],
                _ref_floors("qwen2-1.5b", "float32", 1, 5)[3:])
    assert os.path.isdir(os.path.join(runs["ckpt"], "step_00000003"))


def _ref_moe(over, b, halves):
    """The reference's meshless ``moe_apply`` on each half of the rows alone
    (``halves``), or on all of them: ``sum(y * w) + mean aux`` and its
    gradients, y (rows joined), the mean aux."""
    cfg, p, x, w = _moe_inputs(over, b)
    rows_list = [slice(0, b // 2), slice(b // 2, b)] if halves else [slice(None)]

    def total(p, x):
        ys, auxes = zip(*(r_moe_apply(p, x[r], cfg, mesh=None) for r in rows_list))
        y, aux = jnp.concatenate(ys, 0), jnp.mean(jnp.stack(auxes))
        return jnp.sum(y * w) + aux, (y, aux)

    grad = jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True))
    (val, (y, aux)), (gp, gx) = grad(p, x)
    return float(val), np.asarray(y), float(aux), jax.tree.map(np.asarray, gp), np.asarray(gx)


@pytest.mark.parametrize("case", list(EXCHANGES))
def test_moe_exchange_on_2x4_matches_the_reference(runs, case):
    """y and aux within 2e-5 of the reference's meshless ``moe_apply`` on
    each data shard's tokens alone (the whole batch where the batch does not
    divide the data axis and the tokens are replicated), and the gradient
    of ``sum(y * w) + aux`` through the all-reduce against ``jax.grad``."""
    b, over = EXCHANGES[case]
    got = _results(runs, 8)[list(EXCHANGES).index(case)]
    assert got["shared_tp"]
    assert got["batch_sharded"] == (b % 2 == 0)
    val, y, aux, gp, gx = _ref_moe(over, b, got["batch_sharded"])
    tol = dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got["y"], y, **tol)
    np.testing.assert_allclose(got["aux"], aux, **tol)
    np.testing.assert_allclose(got["total"], val, rtol=2e-5)
    np.testing.assert_allclose(got["grad_x"], gx, **tol)
    np.testing.assert_allclose(got["grad_router"], gp["router"], **tol)
    for k in ("wi", "wg", "wo"):
        np.testing.assert_allclose(got[f"grad_{k}"], gp[k], **tol, err_msg=k)
        np.testing.assert_allclose(got[f"grad_shared_{k}"], gp["shared"][k], **tol, err_msg=k)
    whole = _ref_moe(over, b, False)[1]
    if case == "default":
        # capacity per data shard: the 2-way split drops other assignments
        # than one device does, so some rows differ from the whole batch's
        assert np.abs(got["y"] - whole).max() > 1e-3
    else:
        # drop-free, or every shard holding every token: one device's y
        np.testing.assert_allclose(got["y"], whole, **tol)


def test_build_model_follows_the_references_head_policy(runs):
    """On a model axis of 2: the query heads padded to a multiple of it (3
    -> 4, head_dim kept) and QKV fused only where the fused heads split;
    with ``pad_heads=False`` (the decode policy) no padding and no fusion;
    MLA untouched (``repro.launch.steps.build_model``'s policy)."""
    got = _results(runs, 4)[-1]
    ref_policy = {}
    for name, over in (("qwen2-1.5b", {}), ("qwen2-1.5b", {"n_heads": 3}),
                       ("deepseek-v2-lite-16b", {})):
        cfg = configs(name, "float32", **over)[0]
        for pad in (True, False):
            r = r_steps.pad_heads_for_tp(cfg, 2) if pad else (
                cfg if cfg.mla else dataclasses.replace(cfg, qkv_fused=False))
            ref_policy[f"{name}{over}-{pad}"] = (r.n_heads, r.hd, r.qkv_fused)
    assert got == ref_policy
    assert got["qwen2-1.5b{'n_heads': 3}-True"] == (4, 16, True)
