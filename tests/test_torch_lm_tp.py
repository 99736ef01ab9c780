"""Tensor parallelism over the model axis (``repro_torch.models.parallel``):
attention heads (GQA, cross-attention, the whisper encoder), MLA's heads,
Mamba-2's heads and the vocabulary computed a share a rank, against the
reference's meshless model, reduced, float32, on the reference's weights.

Ranks are spawned twice for the module (``repro_torch.sim.ranks.run_ranks``,
one thread each, under ``nice``; the rank side is
``tests/_torch_lm_tp_ranks.py``): 2 ranks as data 1 x model 2, then 4 as
2 x 2 and 1 x 4.

* **Which leaves stay local** on 1x2 and 2x2 for every arch of the
  registry, and on 1x4 for qwen2: the rule restated here from the names
  (``wq``/``wo``, MLA's ``wuq``/``wuk``/``wuv``/``wo``, Mamba-2's
  ``wz``/``wx``/``conv_x``/``w_out``, ``embed``/``lm_head``, the MLPs' and
  experts' as before) against ``MeshPlan``; on 1xN (no data axes) the
  weights' cast all-gathers exactly the other model-axis shards, once each,
  and holds 1/tp of the local ones.
* **Forward, prefill and decode on 1x2** for every arch: logits within
  1e-4 of the largest logit, caches within 1e-4 of their largest entry,
  the loss's metrics within a relative 1e-5
  (``tests/test_torch_lm_sharding_ranks.py``'s bounds; that file holds the
  same on 2x2, and three train steps there).
* **Three train steps on 1x2** for every arch against the reference's
  meshless jitted step (``tests/test_torch_lm_sharding_ranks.py``'s
  bounds, which hold every arch's on 2x2); for jamba the floor also counts
  how far the port with no mesh parts from the reference (``PORT_FLOOR``).
* **Loss and one train step's gradients on 1x2 and 2x2** for every arch
  against ``jax.value_and_grad`` of the reference's loss (on 2x2 the mean
  of each data shard's loss, as the reference computes a MoE's capacity
  and aux per data shard): the loss within a relative 1e-5, every gradient
  leaf within 1e-4 of its largest entry
  (``tests/test_torch_train_grads.py``'s bounds).
* **1x4 for qwen2**, whose 2 kv heads the 4 ranks do not divide: a fused
  ``wqkv`` gathered and sliced (two ranks share each kv head), its serving,
  gradients and three train steps (``tests/test_torch_lm_sharding_ranks.py``'s
  bounds); the same with ``wq`` and ``wkv`` apart (the decode policy: a
  replicated ``wkv`` sliced); and 6 query heads, which 4 ranks do not
  divide, so attention falls back to the gathered weights, repeated on
  every rank.

Bounds. Each all-reduce of partial sums (``wo``'s, the head's, the
cross-entropy's sums, Mamba-2's) adds float32 rounding in another order
than one device's: a few ulps of each sum. Mamba-2's gated norm divides by
the square root of its sum of squares over all of ``d_in``, all-reduced
from the ranks' channels: a relative error of ~1e-7 in that scale, which
the reduced Mamba-2 (rows of small norm; ``tests/test_torch_lm_bf16.py``)
grows to a few 1e-6 of its largest logit on two ranks: 1e-4 holds it with
room.

Single-process cases: the vocabulary-parallel cross-entropy and
``_GatherTake``'s backward, their ranks threads of this process over a
stand-in for ``torch.distributed``'s three collectives."""

import functools
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_lm_tp_ranks as rank_side
from _torch_lm import configs, extras_for, flat, one_ulp, ref_params
from repro.configs import registry as r_registry
from repro.launch import steps as r_steps
from repro.models.transformer import Model as RefModel
from repro.optim import adamw as r_adamw
from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from repro_torch.models import layers, parallel
from repro_torch.sim.ranks import run_ranks

LR = 2e-3
ARCHS = tuple(sorted(r_registry.ARCHS))
MOE = tuple(n for n in ARCHS if r_registry.get_arch(n).is_moe)
B, S, PROMPT, DECODE = 4, 16, 8, 3
QWEN = "qwen2-1.5b"
# the 1x4 variants of qwen2: fused QKV, split (the decode policy), 6 heads
VARIANTS = {"fused": {}, "split": {"qkv_fused": False}, "six_heads": {"n_heads": 6,
                                                                      "head_dim": 16}}


def _batch():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 503, (B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, 1)


@functools.lru_cache(maxsize=None)
def _extras(name):
    ref, _ = extras_for(configs(name, "float32")[0], np.random.default_rng(12), B)
    if ref is None:
        return None, None
    return ref, {k: np.asarray(v, np.float32) for k, v in ref.items()}


def _over(variant):
    return dict(VARIANTS[variant])


@functools.lru_cache(maxsize=None)
def _params(name, variant="fused"):
    return ref_params(configs(name, "float32", **_over(variant))[0])


# archs whose three steps' floor also counts the meshless port's own
# distance from the reference. Jamba's Mamba-2 layers and MoE routing
# amplify rounding (ROADMAP C, "Mamba-2's trajectory under AdamW"): the
# port with no mesh parts from the reference's grad norm at step 2 by
# 1.48e-4, where the reference moved by one ulp of its embedding parts by
# at most 1.69e-5 (three signs); the port on 1x2 parts by 1.77e-4
# (measured on the CPU with this file's weights and batches)
PORT_FLOOR = ("jamba-1.5-large-398b",)
# the spawns' jobs, in order
JOBS2 = [("leaves", n) for n in ARCHS] + [("serve", n) for n in ARCHS] + \
    [("grads", n) for n in ARCHS] + [("train", n) for n in ARCHS]
JOBS4 = [("leaves22", n) for n in ARCHS] + [("grads22", n) for n in ARCHS] + \
    [(kind, v) for v in VARIANTS for kind in ("leaves14", "serve14", "grads14")] + \
    [("train14", QWEN)]


def _job(key):
    kind, what = key
    toks, labels = _batch()
    name, over = (QWEN, _over(what)) if kind.endswith("14") and kind != "train14" else (what, {})
    params = _params(QWEN, what) if name == QWEN and over else _params(name)
    shape = {"14": (1, 4), "22": (2, 2)}.get(kind[-2:], (1, 2))
    base = kind.rstrip("0123456789")
    if base == "leaves":
        return ("leaves", shape, dict(name=name, params=params, over=over))
    if base == "serve":
        return ("serve", shape, dict(name=name, params=params, tokens=toks, prompt=PROMPT,
                                     steps=DECODE, over=over, extras=_extras(name)[1]))
    if base == "grads":
        return ("grads", shape, dict(name=name, params=params, tokens=toks, labels=labels,
                                     over=over, extras=_extras(name)[1]))
    return ("train", shape, dict(name=name, params=params, moment_dtype="float32",
                                 microbatches=1, steps=3, lr=LR, extras=_extras(name)[1]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two spawns' results (2 ranks, then 4), run in a thread while the
    tests compute the reference's side."""
    tmp = tmp_path_factory.mktemp("lm_tp")
    jobs = {2: [_job(k) for k in JOBS2], 4: [_job(k) for k in JOBS4]}
    out, done = {}, {2: threading.Event(), 4: threading.Event()}

    def go():
        try:
            for world in (2, 4):
                out[world] = run_ranks(rank_side.main, world, str(tmp / "rdv"),
                                       args=(jobs[world],), timeout=400, threads=1)
                done[world].set()
        except Exception as e:  # raised again in the tests
            out["error"] = e
        finally:
            for ev in done.values():
                ev.set()

    t = threading.Thread(target=go, daemon=True)
    t.start()
    yield {"done": done, "out": out}
    t.join(timeout=900)


def _result(runs, world, key):
    """Rank 0's result of job ``key``, after checking that every rank's
    scalars are rank 0's."""
    assert runs["done"][world].wait(timeout=900), "the rank runs overran"
    if "error" in runs["out"]:
        raise runs["out"]["error"]
    i = (JOBS2 if world == 2 else JOBS4).index(key)
    per_rank = [r[i] for r in runs["out"][world]]
    first = rank_side.base._scalars(per_rank[0])
    for r, other in enumerate(per_rank[1:], 1):
        assert other == first, f"rank {r} differs from rank 0"
    return per_rank[0]


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale, err_msg=what)


# ------------------------------------------------------------ the reference


@functools.lru_cache(maxsize=None)
def _ref_fns(name, variant="fused"):
    """The reference's jitted prefill, decode step, and loss with its
    gradients and the forward's logits (one compilation for both)."""
    cfg = configs(name, "float32", **_over(variant))[0]
    model = RefModel(cfg, remat=False)

    def loss(p, batch):
        total, metrics = model.loss(p, batch)
        ex = {k: v for k, v in batch.items() if k in ("frames", "patches")} or None
        return total, (metrics, model.forward(p, batch["tokens"], extras=ex)[0])

    prefill = jax.jit(lambda p, t, ex: model.prefill(p, t, extras=ex, cache_len=S))
    decode = jax.jit(lambda p, t, c, ex: model.decode_step(p, t, c, extras=ex))
    return prefill, decode, jax.jit(jax.value_and_grad(loss, has_aux=True))


@functools.lru_cache(maxsize=None)
def _ref_grads(name, variant="fused", halves=False):
    """The reference's loss, metrics, gradients and forward logits on the
    batch (labels the tokens shifted by one); ``halves``: the loss, metrics
    and gradients as means over the batch's two halves, a data shard's rows
    each (the whole batch's, but for a MoE, whose capacity and aux are per
    shard)."""
    if halves and name not in MOE:
        return _ref_grads(name, variant)
    toks, labels = _batch()
    batch = {"tokens": toks, "labels": labels, **(_extras(name)[0] or {})}
    rows = [slice(0, B // 2), slice(B // 2, B)] if halves else [slice(None)]
    parts = [_ref_fns(name, variant)[2](_params(name, variant),
                                        {k: jnp.asarray(v[r]) for k, v in batch.items()})
             for r in rows]
    mean = lambda xs: sum(np.asarray(x, np.float32) for x in xs) / len(rows)  # noqa: E731
    metrics = {k: float(mean([m[k] for (_, (m, _)), _ in parts])) for k in parts[0][0][1][0]}
    grads = {k: mean([flat(g)[k] for _, g in parts]) for k in flat(parts[0][1])}
    logits = np.concatenate([np.asarray(lg, np.float32) for (_, (_, lg)), _ in parts])
    return float(mean([loss for (loss, _), _ in parts])), metrics, grads, logits


def _ref_serve(name, variant="fused"):
    prefill, decode, _ = _ref_fns(name, variant)
    params = _params(name, variant)
    toks = jnp.asarray(_batch()[0])
    ex = _extras(name)[0]
    _, metrics, _, logits = _ref_grads(name, variant)
    out = {"logits": logits, "metrics": metrics}
    logits, cache = prefill(params, toks[:, :PROMPT], ex)
    out["prefill"], out["prefill_cache"] = logits, flat(cache)
    for i in range(DECODE):
        logits, cache = decode(params, toks[:, PROMPT + i: PROMPT + i + 1], cache, ex)
        out[f"decode{i}"] = logits
    out["decode_cache"] = flat(cache)
    return jax.tree.map(np.asarray, out)


def _hold_serve(got, ref):
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


def _hold_grads(got, ref):
    loss, metrics, grads, _ = ref
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert sorted(got["metrics"]) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert sorted(got["grads"]) == sorted(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=0,
                                   atol=1e-4 * float(np.abs(g).max()), err_msg=k)


# ---------------------------------------------------- the rule, restated


def _expected_local(name, ndim, cfg, tp):
    """Whether parameter ``name`` (of ``ndim`` dims) of ``cfg`` computes with
    its own model-axis chunk on a model axis of ``tp``: the rule, restated
    from the names."""
    parts = name.split(".")
    leaf = parts[-1]
    nd = ndim - any(n in ("body", "encoder") for n in parts)
    attn_wo = leaf == "wo" and ("mixer" in parts or "cross" in parts)
    heads = cfg.n_heads > 0 and cfg.n_heads % tp == 0
    if "ffn" in parts and leaf in ("wi", "wg", "wo"):
        if nd == 3:
            return True  # the experts, expert parallel
        if "shared" in parts:
            return (cfg.d_ff_expert * cfg.n_shared_experts) % tp == 0
        return "encoder" not in parts and cfg.d_ff % tp == 0 and not cfg.mlp_bias
    if leaf in ("embed", "lm_head"):
        return cfg.padded_vocab % tp == 0
    if leaf in ("wz", "wx", "conv_x", "w_out"):
        return (cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim) % tp == 0
    if cfg.mla and "mixer" in parts:
        return heads and (leaf in ("wuq", "wuk", "wuv") or attn_wo)
    kv = cfg.n_kv_heads % tp == 0 or tp % cfg.n_kv_heads == 0
    return heads and kv and (leaf == "wq" or attn_wo)


def _hold_leaves(got, name, tp, over=None):
    cfg = configs(name, "float32", **(over or {}))[1]
    named = got["model_placement"]
    want = sorted(k for k in named if _expected_local(k, len(got["shapes"][k][1]), cfg, tp))
    assert got["local"] == want
    for k in got["local"]:  # gathered over the data axes, the rank's share of the model axis
        cast, whole, _ = got["shapes"][k]
        assert int(np.prod(whole)) == tp * int(np.prod(cast)), k
    return cfg


# ---------------------------------------------------------------- the tests


@pytest.mark.parametrize("name", ARCHS)
def test_local_leaves_on_1x2(runs, name):
    """The rule, and on a mesh without data axes the cast's all-gathers:
    one for each model-axis shard that does not stay local, of its bytes,
    and none of a local leaf."""
    got = _result(runs, 2, ("leaves", name))
    cfg = _hold_leaves(got, name, 2)
    gathered = [k for k, p in got["model_placement"].items()
                if p.startswith("Shard") and k not in got["local"]]
    # float32 leaves, one other rank: each gather moves its local bytes
    assert got["cast_collectives"]["all_gather"][1] == sum(
        int(np.prod(got["shapes"][k][2])) * 4 for k in gathered)
    assert got["cast_collectives"]["reduce_scatter"] == [0, 0]
    flags = got["flags"]
    assert flags["vocab_tp"] and flags["mlp_tp"] == (not cfg.mlp_bias)
    assert flags["mla_tp"] == cfg.mla and flags["attn_tp"] == (not cfg.mla)
    assert flags["ssm_tp"] == any(k.startswith("ssm") for k in cfg.layer_kinds())


@pytest.mark.parametrize("name", ARCHS)
def test_local_leaves_on_2x2(runs, name):
    got = _result(runs, 4, ("leaves22", name))
    _hold_leaves(got, name, 2)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_prefill_and_decode_on_1x2_match_the_reference(runs, name):
    _hold_serve(_result(runs, 2, ("serve", name)), _ref_serve(name))


@pytest.mark.parametrize("name", ARCHS)
def test_gradients_on_1x2_match_the_reference(runs, name):
    _hold_grads(_result(runs, 2, ("grads", name)), _ref_grads(name))


@pytest.mark.parametrize("name", ARCHS)
def test_gradients_on_2x2_match_the_references_per_shard_mean(runs, name):
    _hold_grads(_result(runs, 4, ("grads22", name)), _ref_grads(name, halves=True))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_qwen2_on_1x4(runs, variant):
    """4 ranks, 4 query heads and 2 kv heads: each rank one query head and
    the kv head it reads (a fused ``wqkv`` gathered and sliced, or ``wq``
    local and a replicated ``wkv`` sliced); 6 heads do not divide 4, so
    attention runs gathered and repeated, while the MLP and the vocabulary
    stay tensor parallel."""
    over = _over(variant)
    got = _result(runs, 4, ("leaves14", variant))
    _hold_leaves(got, QWEN, 4, over)
    flags = got["flags"]
    assert flags["attn_tp"] == (variant != "six_heads")
    assert flags["vocab_tp"] and flags["mlp_tp"]
    # the rank's heads of the fused or the kv projection: one query head
    # and one kv head (of k and of v), or the whole leaf
    leaf, heads = {"fused": ("wqkv", (3, 8)), "split": ("wkv", (2, 4)),
                   "six_heads": ("wqkv", (10, 10))}[variant]
    cast, whole, _ = got["shapes"][f"body.l0.mixer.{leaf}"]
    assert (cast[2], whole[2]) == heads
    _hold_serve(_result(runs, 4, ("serve14", variant)), _ref_serve(QWEN, variant))
    _hold_grads(_result(runs, 4, ("grads14", variant)), _ref_grads(QWEN, variant))


# ------------------------------------------- three train steps on 1x2 and 1x4


@functools.lru_cache(maxsize=None)
def _ref_step(name):
    opt = r_adamw.AdamWConfig(lr=LR, warmup_steps=2, total_steps=10, moment_dtype="float32")
    return jax.jit(r_steps.make_train_step(RefModel(configs(name, "float32")[0]), opt)), opt


def _ref_run(name, params, steps=3):
    """``steps`` of the reference's meshless jitted step from ``params`` on
    the ranks' synthetic batches: each step's metrics and parameters."""
    step, opt = _ref_step(name)
    data = SyntheticDataset(SyntheticConfig(vocab_size=503, seq_len=16, global_batch=4, seed=3))
    ex = _extras(name)[0] or {}
    rp = jax.tree.map(jnp.asarray, params)
    rs = r_adamw.init(opt, rp)
    out = []
    for i in range(steps):
        batch = {**{k: jnp.asarray(v) for k, v in data.batch(i).items()}, **ex}
        rp, rs, m = step(rp, rs, batch)
        out.append(({k: float(v) for k, v in m.items()}, flat(jax.tree.map(np.asarray, rp))))
    return out


def _port_run(name, params, steps=3):
    """:func:`_ref_run` of the port's step with no mesh (one process)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    model = rank_side.base._model(rank_side.base._cfg(name), params, None)
    opt = adamw.AdamWConfig(lr=LR, warmup_steps=2, total_steps=10, moment_dtype="float32")
    pp = dict(model.named_parameters())
    ps = adamw.init(opt, pp)
    step = make_train_step(model, opt, 1)
    data = SyntheticDataset(SyntheticConfig(vocab_size=503, seq_len=16, global_batch=4, seed=3))
    ex = rank_side.base._extras(_extras(name)[1]) or {}
    out = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        pp, ps, m = step(pp, ps, {**batch, **ex})
        out.append(({k: float(v) for k, v in m.items()},
                    {k: rank_side.base._np(v) for k, v in pp.items()}))
    return out


@pytest.mark.parametrize("key", [("train", n) for n in ARCHS] + [("train14", QWEN)],
                         ids=[f"1x2-{n}" for n in ARCHS] + [f"1x4-{QWEN}"])
def test_three_train_steps_match_the_references_step(runs, key):
    """Loss and grad norm within a relative 1e-5, every parameter within
    0.5 lr, or within twice the reference's own floor where that is larger
    (how far it moves when its embedding moves by one ulp: jamba's MoE)
    (``tests/test_torch_lm_sharding_ranks.py``'s bounds); for the archs of
    ``PORT_FLOOR``, the floor is also how far the port with no mesh parts
    from the reference (so the mesh parts no further than twice that)."""
    name = key[1]
    got = _result(runs, 4 if key[0] == "train14" else 2, key)["steps"]
    ref = _ref_run(name, _params(name))
    floors = [_ref_run(name, one_ulp(_params(name)))]
    if name in PORT_FLOOR:
        floors.append(_port_run(name, _params(name)))
    assert len(got) == 3
    f_loss = f_norm = f_param = 0.0
    for i, ((rm, rp), (gm, gp)) in enumerate(zip(ref, got)):
        for mm, mp in (run[i] for run in floors):
            f_loss = max(f_loss, abs(mm["loss"] - rm["loss"]) / abs(rm["loss"]))
            f_norm = max(f_norm, abs(mm["grad_norm"] - rm["grad_norm"]) / rm["grad_norm"])
            f_param = max([f_param] + [float(np.abs(mp[k] - v).max()) for k, v in rp.items()
                                       if k != "embed"])
        np.testing.assert_allclose(gm["loss"], rm["loss"], rtol=max(1e-5, 2 * f_loss))
        np.testing.assert_allclose(gm["grad_norm"], rm["grad_norm"], rtol=max(1e-5, 2 * f_norm))
        assert sorted(gp) == sorted(rp)
        for k, v in rp.items():
            np.testing.assert_allclose(gp[k], v, rtol=0, atol=max(0.5 * LR, 2 * f_param),
                                       err_msg=f"step {i} {k}")


# ------------------------------------------------------- single-process cases


class _Threads:
    """The collectives ``models/parallel.py`` calls (``all_gather``,
    ``all_reduce`` with SUM or MAX, ``reduce_scatter_tensor``), over ``n``
    threads of this process, each a rank (``rank`` set by the thread)."""

    ReduceOp = dist.ReduceOp

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n
        self.me = threading.local()

    def _exchange(self, x):
        self.slots[self.me.rank] = x.detach().clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def all_gather(self, parts, x, group=None):
        for p, g in zip(parts, self._exchange(x)):
            p.copy_(g)

    def all_reduce(self, x, op=dist.ReduceOp.SUM, group=None):
        got = self._exchange(x)
        x.copy_(torch.stack(got).amax(0) if op == dist.ReduceOp.MAX else sum(got))

    def reduce_scatter_tensor(self, out, x, group=None):
        out.copy_(sum(self._exchange(x)).chunk(self.n)[self.me.rank])

    def run(self, fn):
        """``[fn(0), ..., fn(n - 1)]``, each in its own thread."""
        res, errors = [None] * self.n, []

        def go(r):
            self.me.rank = r
            try:
                res[r] = fn(r)
            except BaseException as e:  # raised below
                errors.append(e)
                self.barrier.abort()

        ts = [threading.Thread(target=go, args=(r,)) for r in range(self.n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        if errors:
            raise errors[0]
        return res


def _plan(n, r):
    """The model-axis part of a ``MeshPlan`` for rank ``r`` of ``n``."""
    plan = types.SimpleNamespace(tp=n, tp_index=r, groups={"model": None}, model_axis="model")
    for m in ("enter_tp", "exit_tp", "max_tp"):
        setattr(plan, m, types.MethodType(getattr(parallel.MeshPlan, m), plan))
    return plan


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_vocab_parallel_cross_entropy_is_softmax_cross_entropys(monkeypatch, tp, masked):
    """Logits over a padded vocabulary of 512 (labels below 503), z-loss on:
    the loss within a relative 1e-5 of ``softmax_cross_entropy``'s on the
    whole logits, every rank the same, and each rank's gradient its
    columns of the whole logits' gradient within 1e-4 of its largest entry
    (``tests/test_torch_train_grads.py``'s bound). The sums of exponentials
    run in another order (split over the ranks, and by torch's reduction,
    whose order depends on its thread count): float32 sums of 512 terms
    differ by up to ~512 * 2^-24 = 3e-5 relative, and every column's
    softmax with them."""
    threads = _Threads(tp)
    monkeypatch.setattr(parallel, "dist", threads)
    rng = np.random.default_rng(5)
    logits = torch.tensor(rng.normal(size=(3, 7, 512)) * 4, dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 503, (3, 7)))
    mask = torch.tensor((rng.random((3, 7)) < 0.6).astype(np.float32)) if masked else None
    whole = logits.clone().requires_grad_(True)
    want = layers.softmax_cross_entropy(whole, labels, mask)
    (want_g,) = torch.autograd.grad(want, whole)
    vl = 512 // tp

    def rank(r):
        mine = logits[..., r * vl:(r + 1) * vl].clone().requires_grad_(True)
        loss = layers.vocab_parallel_cross_entropy(mine, labels, r * vl, _plan(tp, r), mask)
        (g,) = torch.autograd.grad(loss, mine)
        return float(loss), g

    got = threads.run(rank)
    for loss, _ in got:
        assert loss == got[0][0]
        np.testing.assert_allclose(loss, float(want), rtol=1e-5)
    np.testing.assert_allclose(torch.cat([g for _, g in got], -1).numpy(), want_g.numpy(),
                               rtol=0, atol=1e-4 * float(want_g.abs().max()))


@pytest.mark.parametrize("case", ["stored_split", "replicated"])
def test_gather_take_backward_is_the_whole_weights_gradient(monkeypatch, case):
    """Each of 4 ranks takes a different slice of a ``[6, 12, 5]`` leaf
    (query, k and v heads of a fused projection: ranges of dim 1 that are
    not its stored chunk) and weighs it by its own random tensor; the sum
    over the ranks' objectives, through ``_GatherTake``, gives each rank
    its stored chunk of the whole leaf's gradient (one reduce-scatter), or
    the whole gradient where every rank stores the whole leaf (one
    all-reduce), as autograd of the whole leaf gives it."""
    n = 4
    threads = _Threads(n)
    monkeypatch.setattr(parallel, "dist", threads)
    rng = np.random.default_rng(6)
    w = torch.tensor(rng.normal(size=(6, 12, 5)), dtype=torch.float32)
    takes = [(1, ((r, r + 1), (4 + r // 2, 5 + r // 2), (8 + r // 2, 9 + r // 2)))
             for r in range(n)]
    weights = [torch.tensor(rng.normal(size=(6, 3, 5)), dtype=torch.float32) for _ in range(n)]
    whole = w.clone().requires_grad_(True)
    total = sum((parallel._narrowed(whole, *takes[r]) * weights[r]).sum() for r in range(n))
    (want,) = torch.autograd.grad(total, whole)
    gdim = 1 if case == "stored_split" else None

    def rank(r):
        local = (w.chunk(n, 1)[r] if gdim is not None else w).clone().requires_grad_(True)
        x = parallel._GatherTake.apply(local, None, n, gdim, takes[r])
        assert torch.equal(x, parallel._narrowed(w, *takes[r]))
        (g,) = torch.autograd.grad((x * weights[r]).sum(), local)
        return g

    got = threads.run(rank)
    for r, g in enumerate(got):
        ref = want.chunk(n, 1)[r] if gdim is not None else want
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=0, atol=1e-6)
