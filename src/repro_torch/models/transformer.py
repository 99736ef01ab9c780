"""Model assembly: heterogeneous decoder stacks; the port of
``repro.models.transformer``.

Layer sequence = unrolled prefix (e.g. DeepSeek's leading dense layers) + a
periodic body (a unit of ``u`` layers repeated ``reps`` times: jamba's
8-layer mamba/attn block, llama-vision's 5-layer cross-attn period, plain
1-layer units for dense models). Body and encoder parameters are stacked
over ``reps`` as in the reference, whose ``lax.scan`` over them is a loop
here.

:class:`Model` is an ``nn.Module`` whose parameter names are the
reference's tree paths joined by ``.`` (``body.l0.mixer.wqkv``,
``prefix.0.ffn.wi``), so ``repro_torch.convert.lm_params_from_reference``
loads the reference's tree one leaf to one parameter.

Modes: 'train' (chunked causal attention), 'prefill' (chunked + cache write
at 0), 'decode' (single-token step against the cache). With ``remat`` (the
default, as the reference's) each body unit of a 'train' forward runs under
``torch.utils.checkpoint``: its activations are recomputed in the backward
pass, as the reference's ``jax.checkpoint`` recomputes them.

On a mesh (:meth:`Model.shard`, ``build_model(..., mesh=...)``) each
parameter is a DTensor with the reference's placements, and a forward makes
each layer's weights ready at its use (``models/parallel.py``): the data
shards take their rows of the batch and gather FSDP shards; over the model
axis MLPs, attention heads, Mamba-2's heads and the vocabulary run tensor
parallel and MoE experts expert parallel, where the axis divides them. The
logits stay split over the vocabulary inside (the loss is a
vocabulary-parallel cross-entropy); :meth:`Model.forward`,
:meth:`Model.prefill` and :meth:`Model.decode_step` gather what they return.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from .attention import gqa_apply, gqa_params, mla_apply, mla_params
from .layers import (
    apply_norm,
    dense_init,
    einsum_as,
    mlp_apply,
    mlp_params,
    norm_params,
    softmax_cross_entropy,
    vocab_parallel_cross_entropy,
)
from .moe import moe_apply, moe_params
from .parallel import MeshPlan, Sharded, full
from .ssm import mamba2_apply, mamba2_cache_shape, mamba2_params

KEEP_F32 = ("A_log", "dt_bias", "D", "router", "q_norm", "kv_norm")


def _cast_params(params, dtype, name: Optional[str] = None):
    """The reference's cast rule: a float32 leaf is cast to the compute dtype
    when it has two or more dims and its name is not in ``KEEP_F32``. It
    sees *stacked* leaves, so a body layer's 1-D bias or norm ([reps, f])
    is cast while the same leaf of an unstacked prefix or MTP layer stays
    fp32 (and a bf16 activation meeting it computes in fp32, as in jnp)."""
    if isinstance(params, dict):
        return {k: _cast_params(v, dtype, k) for k, v in params.items()}
    if isinstance(params, list):
        return [_cast_params(v, dtype, name) for v in params]
    if params.dtype == torch.float32 and name not in KEEP_F32 and params.dim() >= 2:
        return params.to(dtype)
    return params


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _unstacked(tree, n: int) -> List:
    """``n`` trees, the stacked ``tree``'s slices along axis 0 (views): one
    ``unbind`` a leaf, whose backward is one ``stack``, where indexing each
    slice alone would add ``n`` leaf-sized zero tensors to the backward. A
    sharded leaf unbinds its local shard (the rules never shard the reps
    dim)."""
    if isinstance(tree, dict):
        parts = {k: _unstacked(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    if isinstance(tree, Sharded):
        return tree.unbind()
    return list(torch.unbind(tree))


def _stacked(n: int, make: Callable[[], Dict]) -> Dict:
    """``n`` trees made by ``make()`` stacked leaf by leaf on a new axis 0,
    made one at a time into the result (a full-width model's drawn layers
    are never all held twice)."""
    first = make()
    out = _tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    for r in range(n):
        tree = first if r == 0 else make()
        for dst, src in zip(flatten_tree(out).values(), flatten_tree(tree).values()):
            dst[r].copy_(src)
    return out


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"body.l0.mixer.wqkv": leaf, ...}``: a nested tree (dicts, lists)
    flattened to its paths joined by ``.``, the names of a
    :class:`Model`'s parameters."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _module_of(tree) -> nn.Module:
    if isinstance(tree, list):
        return nn.ModuleList([_module_of(t) for t in tree])
    m = nn.Module()
    _register(m, tree)
    return m


def _register(module: nn.Module, tree: Dict) -> None:
    for k, v in tree.items():
        if torch.is_tensor(v):
            module.register_parameter(k, nn.Parameter(v))
        else:
            module.add_module(k, _module_of(v))


def _tree_of(module: nn.Module, named: Optional[Mapping[str, torch.Tensor]] = None,
             prefix: str = ""):
    """``module``'s parameters as a nested tree; with ``named``, the tensors
    of that mapping in their place, by name."""
    if isinstance(module, nn.ModuleList):
        return [_tree_of(m, named, f"{prefix}{i}.") for i, m in enumerate(module)]
    out: Dict[str, Any] = {k: (p if named is None else named[prefix + k])
                           for k, p in module.named_parameters(recurse=False)}
    for k, m in module.named_children():
        out[k] = _tree_of(m, named, f"{prefix}{k}.")
    return out


# ---------------------------------------------------------------- structure


def body_structure(cfg: ArchConfig) -> Tuple[Tuple[str, ...], Tuple[str, ...], int]:
    """Returns (prefix_kinds, unit_kinds, reps)."""
    kinds = cfg.layer_kinds()
    prefix = kinds[: cfg.first_k_dense]
    rest = kinds[cfg.first_k_dense:]
    n = len(rest)
    unit = n
    for u in range(1, n + 1):
        if n % u == 0 and all(rest[i] == rest[i % u] for i in range(n)):
            unit = u
            break
    return tuple(prefix), tuple(rest[:unit]), n // unit


def layer_param_init(generator, cfg: ArchConfig, kind: str, dtype=torch.float32,
                     device=None) -> Dict:
    p: Dict[str, Any] = {"norm1": norm_params(cfg.norm, cfg.d_model, dtype, device)}
    if kind.startswith("ssm"):
        p["mixer"] = mamba2_params(generator, cfg, dtype, device)
    elif cfg.mla:
        p["mixer"] = mla_params(generator, cfg, dtype, device)
    else:
        p["mixer"] = gqa_params(generator, cfg, dtype, device)
    if "+cross" in kind:
        p["norm_c"] = norm_params(cfg.norm, cfg.d_model, dtype, device)
        p["cross"] = gqa_params(generator, cfg, dtype, device)
    if "+moe" in kind:
        p["norm2"] = norm_params(cfg.norm, cfg.d_model, dtype, device)
        p["ffn"] = moe_params(generator, cfg, dtype, device)
    elif cfg.d_ff > 0:
        p["norm2"] = norm_params(cfg.norm, cfg.d_model, dtype, device)
        p["ffn"] = mlp_params(generator, cfg.d_model, cfg.d_ff, cfg.act, cfg.mlp_bias, dtype,
                              device)
    # d_ff == 0 (pure mamba2): the mixer is the whole layer
    return p


def layer_cache_init(cfg: ArchConfig, kind: str, batch: int, cache_len: int, dtype,
                     device=None) -> Dict:
    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if kind.startswith("ssm"):
        shapes = mamba2_cache_shape(cfg, batch)
        return {k: zeros(v, torch.float32 if k == "ssm" else dtype) for k, v in shapes.items()}
    if cfg.mla:
        return {
            "ckv": zeros((batch, cache_len, cfg.kv_lora_rank)),
            "kr": zeros((batch, cache_len, cfg.qk_rope_head_dim)),
        }
    return {
        "k": zeros((batch, cache_len, cfg.n_kv_heads, cfg.hd)),
        "v": zeros((batch, cache_len, cfg.n_kv_heads, cfg.hd)),
    }


# ---------------------------------------------------------------- blocks


def block_apply(
    kind: str,
    lp: Dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    mode: str,
    cache: Optional[Dict],
    cache_len_now: Optional[int],  # tokens already in the cache, or None
    cross_kv: Optional[torch.Tensor],
    par: Optional[MeshPlan] = None,
):
    """One layer. ``par``: the mesh plan of a sharded model (``lp``'s
    weights made ready for compute: whole, or this rank's slice where the
    layer runs tensor parallel)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = None
    h = apply_norm(cfg.norm, x, lp["norm1"])
    if kind.startswith("ssm"):
        h, new_cache = mamba2_apply(lp["mixer"], h, cfg, cache, par)
    else:
        attn_cache = None
        if cache is not None:
            attn_cache = dict(cache)
            attn_cache["len"] = cache_len_now
        if cfg.mla:
            h, nc = mla_apply(lp["mixer"], h, cfg, positions, attn_cache, mode=mode, par=par)
        else:
            h, nc = gqa_apply(lp["mixer"], h, cfg, positions, attn_cache, mode=mode, par=par)
        if nc is not None:
            nc.pop("len", None)
            new_cache = nc
    x = x + h
    if "+cross" in kind:
        h = apply_norm(cfg.norm, x, lp["norm_c"])
        h, _ = gqa_apply(lp["cross"], h, cfg, positions, None, kv_input=cross_kv, par=par)
        x = x + h
    if "ffn" in lp:
        h = apply_norm(cfg.norm, x, lp["norm2"])
        if "+moe" in kind:
            h, aux = moe_apply(lp["ffn"], h, cfg, par)
        elif par is not None and par.mlp_tp:
            h = par.exit_tp(mlp_apply(lp["ffn"], par.enter_tp(h), cfg.act))
        else:
            h = mlp_apply(lp["ffn"], h, cfg.act)
        x = x + h
    return x, aux, new_cache


# ---------------------------------------------------------------- model


class Model(nn.Module):
    """The decoder stack of ``cfg`` on ``device`` (the card unless the caller
    asks for the CPU). Parameters are fp32 masters, cast to the compute
    dtype at each forward (or once, by :meth:`cast_params`, for serving).
    ``generator`` draws them as :meth:`init` does; without one they are
    allocated and left unset, for a load. ``mesh``: a ``DeviceMesh`` over
    the job's ranks to shard the model on (:meth:`shard`); every rank draws
    the whole weights from the same generator and keeps its slices, so a
    sharded model holds exactly the one-device model's weights."""

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, remat: bool = True,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.prefix_kinds, self.unit_kinds, self.reps = body_structure(cfg)
        self.compute_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.par: Optional[MeshPlan] = None
        _register(self, self._param_tree(generator, resolve_device(device)))
        if mesh is not None:
            self.shard(mesh)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def mesh(self):
        return None if self.par is None else self.par.mesh

    # ------------------------------------------------------------- mesh
    @torch.no_grad()
    def shard(self, mesh) -> "Model":
        """Put the model on ``mesh`` (every rank calls it, with the same
        weights): each parameter becomes a DTensor with the reference's
        placements (``models/sharding.py``), each rank keeping its slices.
        Returns the model."""
        if self.par is not None:
            raise ValueError("the model is already on a mesh")
        plan = MeshPlan(mesh, self.cfg)
        for name, p in list(self.named_parameters()):
            plan.add(name, p.shape)
            owner, _, leaf = name.rpartition(".")
            module = self.get_submodule(owner) if owner else self
            module._parameters[leaf] = nn.Parameter(plan.distribute(name, p.detach()),
                                                    requires_grad=p.requires_grad)
        self.par = plan
        return self

    @torch.no_grad()
    def load_full(self, named: Mapping[str, torch.Tensor]) -> None:
        """Set every parameter from a whole tensor of its name (the same on
        every rank of a mesh: each keeps its slices)."""
        own = dict(self.named_parameters())
        if sorted(own) != sorted(named):
            raise ValueError(f"parameters {sorted(set(own) ^ set(named))} are missing or extra")
        for name, p in own.items():
            src = named[name].to(device=self.device, dtype=p.dtype)
            if self.par is not None:
                p.to_local().copy_(self.par.distribute(name, src).to_local())
            else:
                p.copy_(src)

    def _local(self, tree):
        """A parameter tree for a forward: on a mesh each DTensor becomes its
        :class:`~repro_torch.models.parallel.Sharded` local shard."""
        return tree if self.par is None else self.par.local(tree)

    def _rows(self, x):
        return x if self.par is None else self.par.rows(x)

    def _rows_of(self, extras):
        return None if not extras else {k: self._rows(v) for k, v in extras.items()}

    def _gathered(self, x: torch.Tensor, b: int) -> torch.Tensor:
        return x if self.par is None else self.par.gather_rows(x, b)

    # ------------------------------------------------------ vocabulary
    @property
    def _vocab_tp(self) -> bool:
        return self.par is not None and self.par.vocab_tp

    def _lookup(self, embed: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of ``embed``. Vocabulary parallel, each rank holds
        its rows: an id outside them gives zeros, and one all-reduce over
        the model axis sums the ranks' rows (exact: one is not zero)."""
        ids = ids.to(torch.int64)
        if not self._vocab_tp:
            return embed[ids]
        lo, n = self.par.vocab
        ids = ids - lo
        inside = (ids >= 0) & (ids < n)
        x = embed[ids.clamp(0, n - 1)]
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        return self.par.exit_tp(x)

    def _head(self, x: torch.Tensor, head: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The logits of ``x``; vocabulary parallel, this rank's columns."""
        if self._vocab_tp:
            x = self.par.enter_tp(x)
        return einsum_as("bsd,dv->bsv", x, head, dtype)

    def _cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if not self._vocab_tp:
            return softmax_cross_entropy(logits, labels)
        return vocab_parallel_cross_entropy(logits, labels, self.par.vocab[0], self.par)

    def _whole(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits over the whole vocabulary (gathered over the model axis
        where the head is vocabulary parallel)."""
        return self.par.gather_tp(logits, -1) if self._vocab_tp else logits

    # ------------------------------------------------------------- params
    def _param_tree(self, generator, device) -> Dict:
        cfg = self.cfg
        g = generator
        params: Dict[str, Any] = {
            "embed": dense_init(g, (cfg.padded_vocab, cfg.d_model), 1, device=device),
            "final_norm": norm_params(cfg.norm, cfg.d_model, device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(g, (cfg.d_model, cfg.padded_vocab), 0, device=device)
        if self.prefix_kinds:
            params["prefix"] = [layer_param_init(g, cfg, kind, device=device)
                                for kind in self.prefix_kinds]
        params["body"] = _stacked(self.reps, lambda: {
            f"l{j}": layer_param_init(g, cfg, kind, device=device)
            for j, kind in enumerate(self.unit_kinds)})
        if cfg.encoder_layers:
            params["encoder"] = _stacked(cfg.encoder_layers,
                                         lambda: layer_param_init(g, cfg, "attn", device=device))
            params["enc_norm"] = norm_params(cfg.norm, cfg.d_model, device=device)
        if cfg.mtp:
            params["mtp"] = {
                "proj": dense_init(g, (2 * cfg.d_model, cfg.d_model), 0, device=device),
                "block": layer_param_init(g, cfg, "attn", device=device),
                "norm": norm_params(cfg.norm, cfg.d_model, device=device),
            }
        return params

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Dict:
        """Draw every parameter from ``generator`` (on its own device; the
        values land on the model's), as the constructor draws them; holds a
        second copy of the weights while it loads them. Returns the
        parameter tree."""
        self.load_full(flatten_tree(self._param_tree(generator, self.device)))
        return self.tree()

    def tree(self, named: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
        """The parameters as the reference's nested tree (dicts, lists); with
        ``named`` (a mapping from parameter name to tensor, such as the
        training step's), those tensors in the parameters' places."""
        return _tree_of(self, named)

    @torch.no_grad()
    def cast_params(self, named: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
        """The tree as a forward sees it after the cast rule: computed once
        for serving, the same bits a forward casts to. On a mesh, each
        rank's local shards cast, as :class:`~repro_torch.models.parallel.Sharded`
        leaves, and no collective: the FSDP shards stay at rest, and
        prefill and decode make each layer's weights ready at its use (the
        reference's jitted serve step casts inside the step and XLA gathers
        a layer at a time). ``parallel.full`` of the result is the tree
        made ready whole, once. ``named``: tensors to cast in place of the
        parameters, by name (as :meth:`tree`)."""
        return _cast_params(self._local(self.tree(named)), self.compute_dtype)

    # ------------------------------------------------------------- caches
    def init_cache(self, batch: int, cache_len: int) -> Dict:
        """An empty cache of ``batch`` rows (on a mesh, this data shard's
        rows)."""
        cfg = self.cfg
        dt, dev = self.compute_dtype, self.device
        cache: Dict[str, Any] = {"len": 0}
        if self.prefix_kinds:
            cache["prefix"] = [layer_cache_init(cfg, kind, batch, cache_len, dt, dev)
                               for kind in self.prefix_kinds]
        cache["body"] = {f"l{j}": _tree_map(lambda a: a.new_zeros((self.reps,) + tuple(a.shape)),
                                            layer_cache_init(cfg, kind, batch, cache_len, dt, dev))
                         for j, kind in enumerate(self.unit_kinds)}
        return cache

    # ------------------------------------------------------------ encoder
    def _encode(self, params, frames):
        """The reference's encoder attends causally (``gqa_apply``'s default
        ``causal=True``); the port keeps that."""
        cfg = self.cfg
        x = frames.to(self.compute_dtype)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        for lp in _unstacked(params["encoder"], cfg.encoder_layers):
            lp = full(lp)
            h = apply_norm(cfg.norm, x, lp["norm1"])
            h, _ = gqa_apply(lp["mixer"], h, cfg, pos, par=self.par)
            x = x + h
            h = apply_norm(cfg.norm, x, lp["norm2"])
            x = x + mlp_apply(lp["ffn"], h, cfg.act)
        return apply_norm(cfg.norm, x, full(params["enc_norm"]))

    # ------------------------------------------------------------ forward
    def forward(
        self,
        tokens: torch.Tensor,  # [B, S]
        extras: Optional[Dict] = None,
        cache: Optional[Dict] = None,
        mode: str = "train",
        params: Optional[Dict] = None,
    ):
        """Returns (logits [B, S, V], aux loss, updated cache or None, final
        hidden state). ``params``: a tree to use in place of the module's
        own (e.g. :meth:`cast_params`'s). The cache is updated in place
        (the reference donates it) and returned with its new ``len``; the
        encoder re-encodes ``frames`` at every call, as the reference's
        does. On a mesh ``tokens`` and ``extras`` are the global batch, and
        the logits, hidden state and cache are this data shard's rows
        (``MeshPlan.rows``)."""
        logits, aux, new_cache, h = self._forward(self._rows(tokens), self._rows_of(extras), cache,
                                                  mode, params)
        return self._whole(logits), aux, new_cache, h

    def _forward(self, tokens, extras, cache, mode, params):
        """:meth:`forward` on this data shard's rows, its logits this rank's
        columns where the head is vocabulary parallel."""
        cfg = self.cfg
        par = self.par
        params = _cast_params(self._local(self.tree() if params is None else params),
                              self.compute_dtype)
        s = tokens.shape[1]
        dev = tokens.device
        embed = full(params["embed"])  # once: a tied head reuses it
        x = self._lookup(embed, tokens)  # [B, S, D]
        cache_len_now = cache["len"] if cache is not None else None
        positions = torch.arange(s, device=dev)[None, :]
        if cache is not None:
            positions = cache["len"] + positions

        cross_kv = None
        if extras:
            if "frames" in extras:
                cross_kv = self._encode(params, extras["frames"])
            elif "patches" in extras:
                cross_kv = extras["patches"].to(self.compute_dtype)

        aux_total = torch.zeros((), dtype=torch.float32, device=dev)
        new_cache: Dict[str, Any] = {}
        if cache is not None:
            new_cache = {"len": cache["len"] + s}

        # prefix layers (unrolled)
        if self.prefix_kinds:
            npfx = []
            for i, kind in enumerate(self.prefix_kinds):
                c = cache["prefix"][i] if cache is not None else None
                x, aux, nc = block_apply(kind, full(params["prefix"][i]), x, cfg, positions, mode,
                                         c, cache_len_now, cross_kv, par)
                aux_total = aux_total + aux
                npfx.append(nc)
            if cache is not None:
                new_cache["prefix"] = npfx

        # periodic body: the reference scans the stacked reps, under
        # jax.checkpoint in a 'train' forward with remat (on a mesh each
        # unit's weights are made whole inside it, so remat gathers them
        # again in the backward pass and never keeps them)
        def unit(xc, aux_acc, pu, cu):
            pu = full(pu)
            for j, kind in enumerate(self.unit_kinds):
                cj = cu[f"l{j}"] if cu is not None else None
                xc, aux, ncj = block_apply(kind, pu[f"l{j}"], xc, cfg, positions, mode, cj,
                                           cache_len_now, cross_kv, par)
                aux_acc = aux_acc + aux
                if ncj is not None:
                    for key, new in ncj.items():
                        if new.data_ptr() != cj[key].data_ptr():  # an SSM's new state
                            cj[key].copy_(new)
            return xc, aux_acc

        remat = self.remat and mode == "train" and cache is None
        for r, pu in enumerate(_unstacked(params["body"], self.reps)):
            cu = _tree_map(lambda a: a[r], cache["body"]) if cache is not None else None
            if remat:
                x, aux_total = checkpoint(unit, x, aux_total, pu, cu, use_reentrant=False,
                                          preserve_rng_state=False)
            else:
                x, aux_total = unit(x, aux_total, pu, cu)
        if cache is not None:
            new_cache["body"] = cache["body"]

        x = apply_norm(cfg.norm, x, full(params["final_norm"]))
        head = embed.T if cfg.tie_embeddings else full(params["lm_head"])
        logits = self._head(x, head.to(self.compute_dtype), x.dtype)
        return logits, aux_total, (new_cache if cache is not None else None), x

    # --------------------------------------------------------------- loss
    def loss(self, batch: Dict, params: Optional[Dict] = None):
        """Mean cross-entropy (z-loss 1e-4) + 0.01 aux, + 0.3 MTP where the
        config has it. Returns (total, metrics). On a mesh ``batch`` is the
        global batch; each data shard computes its rows' losses, and what
        returns (on every rank) is their mean, the reference's loss, whose
        backward gives each rank its shard's gradients."""
        cfg = self.cfg
        mean = (lambda v: v) if self.par is None else self.par.data_mean
        batch = {k: self._rows(v) for k, v in batch.items()}
        extras = {k: v for k, v in batch.items() if k in ("frames", "patches")}
        logits, aux, _, h = self._forward(batch["tokens"], extras or None, None, "train", params)
        loss = mean(self._cross_entropy(logits, batch["labels"]))
        metrics = {"ce_loss": loss, "aux_loss": aux}
        total = loss + 0.01 * aux
        if cfg.mtp:
            params_c = _cast_params(self._local(self.tree() if params is None else params),
                                    self.compute_dtype)
            mtp = full(params_c["mtp"])
            embed = full(params_c["embed"])
            labels = batch["labels"].to(torch.int64)
            emb_next = self._lookup(embed, labels)
            hm = einsum_as("bsd,de->bse", torch.cat([h, emb_next], dim=-1), mtp["proj"], h.dtype)
            pos = torch.arange(hm.shape[1], device=hm.device)[None, :]
            hm = block_apply("attn", mtp["block"], hm, cfg, pos, "train", None, None, None,
                             self.par)[0]
            hm = apply_norm(cfg.norm, hm, mtp["norm"])
            head = embed.T if cfg.tie_embeddings else full(params_c["lm_head"])
            mtp_logits = self._head(hm, head, torch.promote_types(hm.dtype, head.dtype))
            labels2 = torch.roll(labels, -1, dims=1)
            mtp_loss = mean(self._cross_entropy(mtp_logits[:, :-1], labels2[:, :-1]))
            metrics["mtp_loss"] = mtp_loss
            total = total + 0.3 * mtp_loss
        metrics["loss"] = total
        return total, metrics

    # -------------------------------------------------------------- serve
    @torch.no_grad()
    def prefill(self, tokens, extras=None, cache_len: Optional[int] = None,
                params: Optional[Dict] = None):
        """Returns (last-token logits [B, V], filled cache). On a mesh the
        logits are the global batch's (gathered over the data shards) and
        the cache holds this shard's rows."""
        b, s = tokens.shape
        tokens = self._rows(tokens)
        cache = self.init_cache(tokens.shape[0], cache_len or s)
        logits, _, new_cache, _ = self._forward(tokens, self._rows_of(extras), cache, "prefill",
                                                params)
        return self._gathered(self._whole(logits[:, -1]), b), new_cache

    @torch.no_grad()
    def decode_step(self, tokens, cache, extras=None, params: Optional[Dict] = None):
        """tokens: [B, 1]. Returns (logits [B, V], updated cache); on a mesh
        as :meth:`prefill`."""
        b = tokens.shape[0]
        logits, _, new_cache, _ = self._forward(self._rows(tokens), self._rows_of(extras), cache,
                                                "decode", params)
        return self._gathered(self._whole(logits[:, -1]), b), new_cache
