"""Helpers shared by the LM tests of the port (``tests/test_torch_lm_*.py``,
``tests/test_torch_serve_llm.py``): carry trees of arrays between JAX and
torch through numpy, and build a reference model and its port twin on the
same weights."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models.transformer import Model as RefModel
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.models.transformer import Model


def to_torch(tree):
    """A tree of JAX/numpy arrays as torch tensors of the same dtype; bf16
    goes through float32, which ``torch.from_numpy`` needs."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v) for v in tree]
    if np.ndim(tree) == 0 and np.issubdtype(np.asarray(tree).dtype, np.integer):
        return int(tree)  # a cache's "len"
    bf16 = np.asarray(tree).dtype == jnp.bfloat16
    t = torch.from_numpy(np.array(tree, np.float32 if bf16 else None))
    return t.to(torch.bfloat16) if bf16 else t


def np32(x) -> np.ndarray:
    """A JAX array or torch tensor as a float32 numpy array."""
    if torch.is_tensor(x):  # a copy: the port writes its caches in place
        return x.detach().to(torch.float32).numpy().copy()
    return np.asarray(x, np.float32)


def flat(tree, prefix=""):
    """``{path: leaf}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflat(tree, values: dict, prefix=""):
    """``tree``'s structure with ``values[path]`` (paths as :func:`flat`
    writes them) at its leaves."""
    if isinstance(tree, dict):
        return {k: unflat(v, values, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [unflat(v, values, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return values[prefix]


def configs(name: str, dtype: str = "bfloat16", reduced: bool = True, **over):
    """The reference's config and the port's copy, reduced, in ``dtype``."""
    ref, port = ref_get_arch(name), get_arch(name)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    return (dataclasses.replace(ref, dtype=dtype, **over),
            dataclasses.replace(port, dtype=dtype, **over))


def ref_params(ref_cfg, seed: int = 0):
    """The reference's weights for ``ref_cfg`` as numpy arrays."""
    return jax.tree.map(np.asarray, RefModel(ref_cfg, remat=False).init(jax.random.PRNGKey(seed)))


def one_ulp(params, seed=0):
    """``params`` with every embedding entry moved by one float32 ulp (a
    random sign): how far a run moves from this start is its own rounding
    floor."""
    e = params["embed"]
    sign = np.where(np.random.default_rng(seed).random(e.shape) < 0.5, -1.0, 1.0)
    return dict(params, embed=(e * (1 + sign * 2.0**-24)).astype(np.float32))


def port_model(port_cfg, params) -> Model:
    """The port's model on the CPU holding the reference's ``params``."""
    return lm_params_from_reference(Model(port_cfg, device="cpu"), params)


def extras_for(cfg, rng, batch: int):
    """The audio/vision stub input, bf16 as the reference draws it: (the
    reference's dict, the port's), or (None, None)."""
    key = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if key is None:
        return None, None
    x = jnp.asarray(rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)), jnp.bfloat16)
    return {key: x}, {key: to_torch(x)}


def run_both(name: str, dtype: str, *, batch: int = 2, seq: int = 16, prompt: int = 8,
             steps: int = 3, seed: int = 0, twin: bool = False, **over):
    """One reduced arch (or ``reduced=False`` with ``over`` widths) through
    both packages on the reference's weights: forward logits, the loss and
    its metrics, prefill's last logits and cache (``prompt`` tokens into a
    cache of ``seq``), then ``steps`` teacher-forced decode steps with their
    logits and cache. Returns ``{what: (reference, port)}`` as float32
    numpy arrays (ints for a cache's "len"); the reference's calls are
    jitted, as its serving loop jits them. ``twin``: also
    ``out["twin_logits"]``, the reference's forward logits of its float32
    twin on the same weights and inputs."""
    reduced = over.pop("reduced", True)
    ref_cfg, cfg = configs(name, dtype, reduced, **over)
    params = ref_params(ref_cfg, seed)
    ref, port = RefModel(ref_cfg, remat=False), port_model(cfg, params)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    ex_ref, ex_port = extras_for(cfg, rng, batch)
    out = {}

    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), **(ex_ref or {})}
    pb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels), **(ex_port or {})}
    fwd_loss = jax.jit(lambda p, b: (ref.forward(p, b["tokens"], extras=ex_ref)[0],
                                     ref.loss(p, b)[1]))
    logits, metrics = fwd_loss(params, rb)
    with torch.no_grad():
        got = port.forward(pb["tokens"], extras=ex_port)[0]
        _, got_metrics = port.loss(pb)
    out["logits"] = (np32(logits), np32(got))
    if twin:
        ref32 = RefModel(dataclasses.replace(ref_cfg, dtype="float32"), remat=False)
        out["twin_logits"] = np32(jax.jit(lambda p, t: ref32.forward(p, t, extras=ex_ref)[0])(
            params, rb["tokens"]))
    assert sorted(metrics) == sorted(got_metrics)
    for k in metrics:
        out[f"loss.{k}"] = (np32(metrics[k]), np32(got_metrics[k]))

    def caches(tag, rc, pc):
        rf, pf = flat(rc), flat(pc)
        assert sorted(rf) == sorted(pf), (sorted(rf), sorted(pf))
        for k in rf:
            if k == "len":
                out[f"{tag}.len"] = (int(rf[k]), int(pf[k]))
            else:
                out[f"{tag}.{k}"] = (np32(rf[k]), np32(pf[k]))

    prefill = jax.jit(lambda p, t: ref.prefill(p, t, extras=ex_ref, cache_len=seq))
    decode = jax.jit(lambda p, t, c: ref.decode_step(p, t, c, extras=ex_ref))
    rl, rc = prefill(params, jnp.asarray(toks[:, :prompt]))
    pl, pc = port.prefill(torch.from_numpy(toks[:, :prompt]), extras=ex_port, cache_len=seq)
    out["prefill"] = (np32(rl), np32(pl))
    caches("prefill_cache", rc, pc)
    for i in range(steps):
        t = toks[:, prompt + i: prompt + i + 1]
        rl, rc = decode(params, jnp.asarray(t), rc)
        pl, pc = port.decode_step(torch.from_numpy(t), pc, extras=ex_port)
        out[f"decode{i}"] = (np32(rl), np32(pl))
    caches("decode_cache", rc, pc)
    return out
