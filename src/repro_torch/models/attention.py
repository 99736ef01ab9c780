"""Attention: GQA with chunked (flash-style) online softmax, decode with a KV
cache, DeepSeek MLA, and cross-attention; the port of
``repro.models.attention``.

The chunked implementation never materializes the [S, S] score matrix: the
query sequence is processed in blocks with a streaming softmax over KV
blocks, which keeps peak memory O(S * block). It computes what the
reference computes, in its precision (fp32 scores and accumulators); no
fused attention library call stands in for it.

Caches are written in place (the reference's serving loop donates them):
prefill writes its k/v at offset 0, a decode step at ``cache["len"]``.

On a mesh (``par``, a :class:`~repro_torch.models.parallel.MeshPlan`)
whose model axis divides the query heads, each rank computes its query
heads and the kv heads they read (MLA: its heads of the up-projections)
with its slice of the weights, and ``wo`` is row-parallel: one all-reduce
sums the ranks' outputs. Caches stay whole over the model axis, as the
reference places them: a step's new k/v heads are all-gathered before they
are written, and each rank attends over its own heads of the cache; MLA's
latent cache holds no heads and is computed alike on every rank.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import apply_rope, dense_init, einsum_as, pdot, rms_norm, rope_freqs

NEG_INF = -1e30


def _repeat_kv(k, n_rep: int):
    """Each KV head repeated ``n_rep`` times consecutively on the head axis."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _pad_seq(x, to: int):
    """Zero-pad axis 1 of [B, S, H, D] to length ``to``."""
    return F.pad(x, (0, 0, 0, 0, 0, to - x.shape[1]))


def chunked_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H, D]   (kv heads pre-repeated to H)
    v: torch.Tensor,  # [B, Sk, H, Dv]
    causal: bool = True,
    q_block: int = 1024,
    kv_block: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash-style attention; returns [B, Sq, H, Dv] in q's dtype."""
    b, sq, h, d = q.shape
    sk, dv = v.shape[1], v.shape[3]
    scale = 1.0 / math.sqrt(d)
    qb = min(q_block, sq)
    kb = min(kv_block, sk)
    sq_p = (sq + qb - 1) // qb * qb
    sk_p = (sk + kb - 1) // kb * kb
    nq, nk = sq_p // qb, sk_p // kb
    qc = _pad_seq(q, sq_p).reshape(b, nq, qb, h, d)
    kc = _pad_seq(k, sk_p).reshape(b, nk, kb, h, d)
    vc = _pad_seq(v, sk_p).reshape(b, nk, kb, h, dv)

    dev = q.device
    q_pos = q_offset + torch.arange(sq_p, device=dev).reshape(nq, qb)
    k_pos = torch.arange(sk_p, device=dev).reshape(nk, kb)
    k_valid = (torch.arange(sk_p, device=dev) < sk).reshape(nk, kb)

    outs = []
    for qi in range(nq):
        q_blk = qc[:, qi].to(torch.float32)  # [B, qb, H, D]
        acc = torch.zeros((b, h, qb, dv), dtype=torch.float32, device=dev)
        m = torch.full((b, h, qb), NEG_INF, dtype=torch.float32, device=dev)
        denom = torch.zeros((b, h, qb), dtype=torch.float32, device=dev)
        for ki in range(nk):
            k_blk = kc[:, ki].to(torch.float32)
            v_blk = vc[:, ki].to(torch.float32)
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk) * scale
            mask = k_valid[ki][None, None, None, :]
            if causal:
                mask = mask & (q_pos[qi][None, None, :, None] >= k_pos[ki][None, None, None, :])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(denom, min=1e-30)[..., None])  # [B, H, qb, Dv]
    # [nq, B, H, qb, Dv] -> [B, Sq, H, Dv]
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, sq_p, h, dv)
    return out[:, :sq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, S, H, D]   (kv heads pre-repeated to H)
    v_cache: torch.Tensor,  # [B, S, H, Dv]
    cache_len,  # int, 0-d tensor or [B] tensor: valid prefix length
) -> torch.Tensor:
    b, _, h, d = q.shape
    s, dv = v_cache.shape[1], v_cache.shape[3]
    scale = 1.0 / math.sqrt(d)
    qh = q.reshape(b, h, d)
    scores = torch.einsum("bhd,bshd->bhs", qh.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    pos = torch.arange(s, device=q.device)
    if not torch.is_tensor(cache_len) or cache_len.dim() == 0:
        mask = (pos < cache_len)[None, None, :]
    else:
        mask = (pos[None, :] < cache_len[:, None])[:, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, dv).to(q.dtype)


def _write(cache: torch.Tensor, new: torch.Tensor, at: int) -> torch.Tensor:
    """Write ``new`` [B, s, ...] into ``cache`` [B, C, ...] at position
    ``at`` of axis 1, in place. Raises where the reference's
    ``dynamic_update_slice`` would clamp the position instead."""
    end = at + new.shape[1]
    if end > cache.shape[1]:
        raise ValueError(f"cache of length {cache.shape[1]} cannot take positions "
                         f"{at}..{end - 1}")
    cache[:, at:end] = new.to(cache.dtype)
    return cache


# --------------------------------------------------------------------- GQA


def gqa_params(generator, cfg, dtype=torch.float32, device=None) -> Dict:
    """Fused QKV (``wqkv``, split at ``[hq, hq + hkv]``) when
    ``cfg.qkv_fused``, else ``wq`` + fused ``wkv``."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p: Dict = {}
    if cfg.qkv_fused:
        p["wqkv"] = dense_init(generator, (d, hq + 2 * hkv, hd), 0, dtype, device)
        if cfg.qkv_bias:
            p["bqkv"] = torch.zeros((hq + 2 * hkv, hd), dtype=dtype, device=device)
    else:
        p["wq"] = dense_init(generator, (d, hq, hd), 0, dtype, device)
        p["wkv"] = dense_init(generator, (d, 2 * hkv, hd), 0, dtype, device)
        if cfg.qkv_bias:
            p["bq"] = torch.zeros((hq, hd), dtype=dtype, device=device)
            p["bkv"] = torch.zeros((2 * hkv, hd), dtype=dtype, device=device)
    p["wo"] = dense_init(generator, (hq, hd, d), None, dtype, device)
    return p


def gqa_apply(
    p: Dict,
    x: torch.Tensor,  # [B, S, D]
    cfg,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,  # {"k": [B, C, Hkv, hd], "v": ..., "len": int}
    kv_input: Optional[torch.Tensor] = None,  # cross-attention source
    mode: str = "train",
    causal: bool = True,
    par=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """``par``: the model's mesh plan; where it runs attention head
    parallel (``par.attn_tp``), ``p`` holds this rank's slices of the
    weights (``MeshPlan``'s takes) and the result is summed over the model
    axis."""
    inv, rot = rope_freqs(cfg.hd, cfg.rope_theta, cfg.partial_rotary, x.device)
    tp = par is not None and par.attn_tp
    if tp:
        hq, hkv = par.q_heads[1], par.kv_heads[1]
        x = par.enter_tp(x)
        if kv_input is not None:
            kv_input = par.enter_tp(kv_input)
    else:
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    proj = "bsd,dhk->bshk"
    src = x if kv_input is None else kv_input
    if "wqkv" in p:
        if kv_input is None:
            qkv = einsum_as(proj, x, p["wqkv"], dt)
            if "bqkv" in p:
                qkv = qkv + p["bqkv"]
            q, k, v = torch.split(qkv, [hq, hkv, qkv.shape[2] - hq - hkv], dim=2)
        else:
            w = p["wqkv"]
            wq, wk, wv = torch.split(w, [hq, hkv, w.shape[1] - hq - hkv], dim=1)
            q = einsum_as(proj, x, wq, dt)
            k = einsum_as(proj, kv_input, wk, dt)
            v = einsum_as(proj, kv_input, wv, dt)
            if "bqkv" in p:
                bias = p["bqkv"]
                bq, bk, bv = torch.split(bias, [hq, hkv, bias.shape[0] - hq - hkv], dim=0)
                q, k, v = q + bq, k + bk, v + bv
    else:
        q = einsum_as(proj, x, p["wq"], dt)
        kv = einsum_as(proj, src, p["wkv"], dt)
        if "bq" in p:
            q = q + p["bq"]
            kv = kv + p["bkv"]
        k, v = torch.split(kv, [hkv, kv.shape[2] - hkv], dim=2)
    is_cross = kv_input is not None
    if not is_cross:
        q = apply_rope(q, positions, inv, rot)
        k = apply_rope(k, positions, inv, rot)
    n_rep = q.shape[2] // k.shape[2]

    def whole(t):  # a step's new heads as the cache holds them
        return par.gather_kv(t) if tp else t

    def own(t):  # this rank's heads of the cache
        return t.narrow(2, par.kv_heads[0], hkv) if tp else t

    if cache is None or is_cross:
        out = chunked_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                                causal=causal and not is_cross)
        new_cache = None
    elif mode == "prefill":
        # write fresh k/v at the start of the cache; attend within the prompt
        kc = _write(cache["k"], whole(k), 0)
        vc = _write(cache["v"], whole(v), 0)
        out = chunked_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), causal=True)
        new_cache = {"k": kc, "v": vc}
    else:
        # decode: insert k/v at position cache["len"]
        idx = cache["len"]
        kc = _write(cache["k"], whole(k), idx)
        vc = _write(cache["v"], whole(v), idx)
        out = decode_attention(q, _repeat_kv(own(kc), n_rep), _repeat_kv(own(vc), n_rep),
                               idx + q.shape[1])
        new_cache = {"k": kc, "v": vc}
    y = einsum_as("bshk,hkd->bsd", out, p["wo"], dt)
    return (par.exit_tp(y) if tp else y), new_cache


# --------------------------------------------------------------------- MLA


def mla_params(generator, cfg, dtype=torch.float32, device=None) -> Dict:
    d = cfg.d_model
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    p: Dict = {}
    if cfg.q_lora_rank:
        p["wdq"] = dense_init(generator, (d, cfg.q_lora_rank), 0, dtype, device)
        p["q_norm"] = torch.ones((cfg.q_lora_rank,), dtype=dtype, device=device)
        p["wuq"] = dense_init(generator, (cfg.q_lora_rank, h, dn + dr), 0, dtype, device)
    else:
        p["wuq"] = dense_init(generator, (d, h, dn + dr), 0, dtype, device)
    p["wdkv"] = dense_init(generator, (d, cfg.kv_lora_rank), 0, dtype, device)
    p["kv_norm"] = torch.ones((cfg.kv_lora_rank,), dtype=dtype, device=device)
    p["wkr"] = dense_init(generator, (d, dr), 0, dtype, device)  # shared rope key
    p["wuk"] = dense_init(generator, (cfg.kv_lora_rank, h, dn), 0, dtype, device)
    p["wuv"] = dense_init(generator, (cfg.kv_lora_rank, h, dv), 0, dtype, device)
    p["wo"] = dense_init(generator, (h, dv, d), None, dtype, device)
    return p


def mla_apply(
    p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor,
    cache: Optional[Dict] = None,  # {"ckv": [B, C, r], "kr": [B, C, dr], "len"}
    mode: str = "train",
    par=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The cache holds the compressed ``ckv`` and the shared rope key ``kr``;
    a decode step expands the whole cache through ``wuk``/``wuv``. Where
    ``par`` runs MLA head parallel (``par.mla_tp``), ``wuq``/``wuk``/``wuv``/
    ``wo`` are this rank's heads: the down-projections and the cache are
    computed alike on every rank, each rank expands its own heads, and the
    result is summed over the model axis."""
    s = x.shape[1]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dt = x.dtype
    inv, rot = rope_freqs(dr, cfg.rope_theta, 1.0, x.device)
    tp = par is not None and par.mla_tp
    enter = par.enter_tp if tp else (lambda t: t)

    if cfg.q_lora_rank:
        cq = rms_norm(pdot(x, p["wdq"]), p["q_norm"])
        q = einsum_as("bsr,rhk->bshk", enter(cq), p["wuq"], dt)
    else:
        q = einsum_as("bsd,dhk->bshk", enter(x), p["wuq"], dt)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, inv, rot)
    qf = torch.cat([q_nope, q_rope], dim=-1)

    ckv = rms_norm(pdot(x, p["wdkv"]), p["kv_norm"])  # [B, S, r]
    kr = apply_rope(pdot(x, p["wkr"])[:, :, None, :], positions, inv, rot)  # [B,S,1,dr]

    def expand(ckv_src, kr_src):
        c = enter(ckv_src.to(dt))
        k_nope = einsum_as("bsr,rhk->bshk", c, p["wuk"], dt)
        v = einsum_as("bsr,rhk->bshk", c, p["wuv"], dt)
        k_full = torch.cat([k_nope, enter(kr_src.to(dt)).expand(*k_nope.shape[:3], dr)], dim=-1)
        return k_full, v

    if cache is None:
        k_full, v = expand(ckv, kr)
        out = chunked_attention(qf, k_full, v, causal=True)
        new_cache = None
    elif mode == "prefill":
        ckv_c = _write(cache["ckv"], ckv, 0)
        kr_c = _write(cache["kr"], kr[:, :, 0, :], 0)
        k_full, v = expand(ckv, kr)
        out = chunked_attention(qf, k_full, v, causal=True)
        new_cache = {"ckv": ckv_c, "kr": kr_c}
    else:
        idx = cache["len"]
        ckv_c = _write(cache["ckv"], ckv, idx)
        kr_c = _write(cache["kr"], kr[:, :, 0, :], idx)
        k_full, v = expand(ckv_c, kr_c[:, :, None, :])
        out = decode_attention(qf, k_full, v, idx + s)
        new_cache = {"ckv": ckv_c, "kr": kr_c}
    y = einsum_as("bshk,hkd->bsd", out, p["wo"], dt)
    return (par.exit_tp(y) if tp else y), new_cache
