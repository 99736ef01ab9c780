"""Mixture-of-Experts on one device; the port of ``repro.models.moe``.

The reference gives each device of its 'model' mesh axis ``E / ep`` experts
(``my``'s slice, ``e_loc`` experts) and sums the slices with one ``psum``.
:func:`moe_slice` is that per-device body: it routes every token in fp32,
places each (token, expert) assignment of its slice into a capacity-bounded
buffer with a *stable* sort, so exactly the reference's assignments are
dropped at capacity, and runs its experts' SwiGLU. :func:`moe_apply` runs
the one slice a single device holds (all experts, no exchange), or on a
mesh (a :class:`~repro_torch.models.parallel.MeshPlan`) each rank's slice
of its data shard's tokens, summed over the model axis by one all-reduce,
the reference's ``psum``; then it adds the shared experts.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .layers import dense_init, einsum_as, pdot, silu
from .parallel import MeshPlan


def moe_params(generator, cfg, dtype=torch.float32, device=None) -> Dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": dense_init(generator, (d, e), 0, torch.float32, device),
        "wi": dense_init(generator, (e, d, f), 1, dtype, device),
        "wg": dense_init(generator, (e, d, f), 1, dtype, device),
        "wo": dense_init(generator, (e, f, d), 1, dtype, device),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "wi": dense_init(generator, (d, fs), 0, dtype, device),
            "wg": dense_init(generator, (d, fs), 0, dtype, device),
            "wo": dense_init(generator, (fs, d), 0, dtype, device),
        }
    return p


def _local_expert_ffn(x_buf, wi, wg, wo):
    # x_buf: [E_loc, C, D]; weights [E_loc, D, F] / [E_loc, F, D]
    dt = x_buf.dtype
    h = silu(einsum_as("ecd,edf->ecf", x_buf, wi, dt)) * einsum_as("ecd,edf->ecf", x_buf, wg,
                                                                       dt)
    return einsum_as("ecf,efd->ecd", h, wo, dt)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, equal values in
    index order (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_slice(p: Dict, x: torch.Tensor, cfg, my: int = 0, ep: int = 1,
              enter: Optional[Callable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slice ``my`` of ``ep`` (experts ``my * e_loc`` to ``(my + 1) * e_loc``,
    ``e_loc = E / ep``): its share of the routed output [B, S, D] and the
    aux load-balancing loss. ``p["wi"]``/``["wg"]``/``["wo"]`` hold all E
    experts (the slice takes its own) or the slice's ``e_loc``. ``enter``
    (on a mesh, ``MeshPlan.enter_tp``) is applied to the tokens and the
    combine weights where they enter the slice's own experts: the routing
    before it is the same on every slice, the share after it is partial."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_top_k
    cf = cfg.moe_capacity_factor
    e_loc = e // ep
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    if wi.shape[0] != e_loc:
        mine = slice(my * e_loc, (my + 1) * e_loc)
        wi, wg, wo = wi[mine], wg[mine], wo[mine]
    dev = x.device

    t = b * s
    xt = x.reshape(t, d)
    logits = (xt.to(torch.float32) @ p["router"]).to(torch.float32)  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, k)  # [T, k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (Switch-style)
    me = torch.mean(probs, dim=0)
    ce = torch.zeros((e,), dtype=torch.float32, device=dev)
    ce = ce.index_add(0, topi.reshape(-1), torch.ones(t * k, device=dev)) / (t * k)
    aux = e * torch.sum(me * ce)

    cap = max(int(np.ceil(t * k / e * cf)), 1)
    if enter is not None:
        xt, topw = enter(xt), enter(topw)

    # position of each assignment within its expert, by a stable sort
    flat_e = topi.reshape(-1)
    flat_w = topw.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # [T*k]
    sorted_e = flat_e[order]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    start = torch.searchsorted(sorted_e, torch.arange(e, device=dev))  # [E]
    slot_pos = inv - start[flat_e]
    local = (flat_e >= my * e_loc) & (flat_e < (my + 1) * e_loc)
    ok = local & (slot_pos < cap)
    e_local_idx = torch.where(ok, flat_e - my * e_loc, 0)
    buf_idx = torch.where(ok, e_local_idx * cap + slot_pos, e_loc * cap)  # dump slot
    tok_idx = torch.arange(t * k, device=dev) // k
    buf = torch.zeros((e_loc * cap + 1, d), dtype=x.dtype, device=dev)
    buf = buf.index_add(0, buf_idx, xt[tok_idx] * ok[:, None].to(x.dtype))
    buf = buf[: e_loc * cap].reshape(e_loc, cap, d)

    out_buf = _local_expert_ffn(buf, wi, wg, wo)  # [E_loc, C, D]
    out_flat = torch.cat([out_buf.reshape(e_loc * cap, d),
                          torch.zeros((1, d), dtype=out_buf.dtype, device=dev)], 0)
    contrib = out_flat[buf_idx] * (flat_w * ok).to(out_buf.dtype)[:, None]
    yt = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add(0, tok_idx, contrib)
    return yt.reshape(b, s, d), aux


def _shared(sh: Dict, x: torch.Tensor) -> torch.Tensor:
    return pdot(silu(pdot(x, sh["wi"])) * pdot(x, sh["wg"]), sh["wo"])


def moe_apply(p: Dict, x: torch.Tensor, cfg, mesh: Optional[MeshPlan] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, D], aux load-balancing loss).

    ``mesh``: None (one device), or the model's :class:`MeshPlan`. On a
    mesh ``x`` is this rank's tokens: its data shard's rows, or every row
    where the batch does not divide the data axes (``MeshPlan.rows``), so
    capacity is per data shard, from the local token count, as in the
    reference. Each rank runs its ``E / ep`` experts (``p``'s expert
    weights: the rank's slice, or all E), and one all-reduce over the model
    axis sums the slices (with the shared experts' partial sums when they
    run tensor parallel); the aux loss is averaged over the data shards."""
    if mesh is None:
        y, aux = moe_slice(p, x, cfg)
        if cfg.n_shared_experts:
            y = y + _shared(p["shared"], x)
        return y, aux
    y, aux = moe_slice(p, x, cfg, my=mesh.tp_index, ep=mesh.tp, enter=mesh.enter_tp)
    tp_shared = cfg.n_shared_experts and mesh.shared_tp
    if tp_shared:
        y = y + _shared(p["shared"], mesh.enter_tp(x))
    y = mesh.exit_tp(y)
    if cfg.n_shared_experts and not tp_shared:
        y = y + _shared(p["shared"], x)
    return y, mesh.data_mean(aux)
