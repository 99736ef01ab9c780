"""Mamba-2 SSD (state-space duality) block, chunked; the port of
``repro.models.ssm``.

The sequence is split into chunks; the intra-chunk term is a masked
quadratic form, the inter-chunk term carries the [H, P, N] state from chunk
to chunk (the reference's ``lax.scan``, here a loop that emits the state
*entering* each chunk). Decode keeps an O(1) recurrent state (conv window +
SSM state). ``dt``, ``A_log``, ``D`` and the scan run in fp32.

On a mesh whose model axis divides the heads (``par.ssm_tp``, a
:class:`~repro_torch.models.parallel.MeshPlan`), each rank holds and runs
its heads of ``ssm_headdim`` channels: its columns of ``wz``/``wx``/
``conv_x``, its rows of ``w_out`` (one all-reduce sums the outputs) and its
slices of the per-channel and per-head vectors. ``B``, ``C`` and ``dt`` are
computed whole (their weights are not split over the model axis); the gated
norm's sum of squares over all of ``d_in`` is one all-reduce. The caches
stay whole over the model axis: a step's new ``conv_x`` window and SSM
state are all-gathered before they are kept.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init, pdot, rms_norm, silu


def _segsum(x):
    """x: [..., T] -> [..., T, T] with out[.., i, j] = sum_{j<k<=i} x[..k] for
    j <= i, -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device), 0)
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(
    x: torch.Tensor,  # [B, S, H, P]
    a_log: torch.Tensor,  # [B, S, H]  (= dt * A, negative)
    B_: torch.Tensor,  # [B, S, N]   (single group)
    C_: torch.Tensor,  # [B, S, N]
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    n = B_.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    ac = a_log.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)  # [B, nc, H, T]
    Bc = B_.reshape(b, nc, chunk, n)
    Cc = C_.reshape(b, nc, chunk, n)

    a_cum = torch.cumsum(ac, dim=-1)  # [B, nc, H, T]
    L = torch.exp(_segsum(ac))  # [B, nc, H, T, T]
    # intra-chunk (diagonal blocks)
    y_diag = torch.einsum("bcln,bcsn,bchls,bcshp->bclhp", Cc, Bc, L, xc)
    # per-chunk end states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # [B, nc, H, T]
    states = torch.einsum("bcln,bchl,bclhp->bchpn", Bc, decay_states, xc)

    # inter-chunk recurrence over chunks
    chunk_decay = torch.exp(a_cum[..., -1])  # [B, nc, H]
    carry = h0.to(x.dtype) if h0 is not None else torch.zeros((b, h, p, n), dtype=x.dtype,
                                                              device=x.device)
    entering = []
    for c in range(nc):
        entering.append(carry)  # the state *entering* chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)  # [B, nc, H, P, N]
    state_decay_out = torch.exp(a_cum)  # [B, nc, H, T]
    y_off = torch.einsum("bcln,bchpn,bchl->bclhp", Cc, prev_states, state_decay_out)
    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return y, carry


def mamba2_params(generator, cfg, dtype=torch.float32, device=None) -> Dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nheads = d_in // cfg.ssm_headdim
    n = cfg.ssm_state

    def w(shape):
        return dense_init(generator, shape, 0, dtype, device)

    def zeros(size, dt=dtype):
        return torch.zeros((size,), dtype=dt, device=device)

    return {
        "wz": w((d, d_in)),
        "wx": w((d, d_in)),
        "wB": w((d, n)),
        "wC": w((d, n)),
        "wdt": w((d, nheads)),
        "conv_x": w((cfg.ssm_conv, d_in)),
        "conv_B": w((cfg.ssm_conv, n)),
        "conv_C": w((cfg.ssm_conv, n)),
        "conv_bx": zeros(d_in),
        "conv_bB": zeros(n),
        "conv_bC": zeros(n),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, dtype=torch.float32,
                                          device=device)),
        "dt_bias": zeros(nheads, torch.float32),
        "D": torch.ones((nheads,), dtype=torch.float32, device=device),
        "norm_w": torch.ones((d_in,), dtype=dtype, device=device),
        "w_out": w((d_in, d)),
    }


def _causal_conv(u, w, b, state=None):
    """u: [B, S, C]; w: [K, C] depthwise causal; returns ([B, S, C], state)."""
    k = w.shape[0]
    if state is None:
        up = F.pad(u, (0, 0, k - 1, 0))
    else:
        up = torch.cat([state.to(u.dtype), u], dim=1)
    new_state = up[:, -(k - 1):, :] if k > 1 else None
    out = sum(up[:, i: i + u.shape[1], :] * w[i] for i in range(k))
    return silu(out + b), new_state


def mamba2_cache_shape(cfg, batch: int) -> Dict:
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    return {
        "conv_x": (batch, cfg.ssm_conv - 1, d_in),
        "conv_B": (batch, cfg.ssm_conv - 1, cfg.ssm_state),
        "conv_C": (batch, cfg.ssm_conv - 1, cfg.ssm_state),
        "ssm": (batch, nheads, cfg.ssm_headdim, cfg.ssm_state),
    }


def mamba2_apply(
    p: Dict,
    x: torch.Tensor,  # [B, S, D]
    cfg,
    cache: Optional[Dict] = None,
    par=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    b, s, d = x.shape
    d_in = cfg.ssm_expand * d
    hd = cfg.ssm_headdim
    nheads = d_in // hd
    tp = par is not None and par.ssm_tp
    # this rank's heads and channels (all of them off a mesh)
    h0_, nh = par.ssm_heads if tp else (0, nheads)
    c0, dl = par.ssm_channels if tp else (0, d_in)

    xt = par.enter_tp(x) if tp else x
    z = pdot(xt, p["wz"])
    xin = pdot(xt, p["wx"])
    B_ = pdot(x, p["wB"])
    C_ = pdot(x, p["wC"])
    dt = pdot(x, p["wdt"])

    cx = cache["conv_x"].narrow(2, c0, dl) if cache is not None else None
    cB = cache["conv_B"] if cache is not None else None
    cC = cache["conv_C"] if cache is not None else None
    xin, ncx = _causal_conv(xin, p["conv_x"], p["conv_bx"], cx)
    B_, ncB = _causal_conv(B_, p["conv_B"], p["conv_bB"], cB)
    C_, ncC = _causal_conv(C_, p["conv_C"], p["conv_bC"], cC)
    if tp:
        B_, C_ = par.enter_tp(B_), par.enter_tp(C_)
        dt = par.enter_tp(dt).narrow(2, h0_, nh)

    f32 = torch.float32
    dt = F.softplus(dt.to(f32) + p["dt_bias"])  # [B, S, H]
    A = -torch.exp(p["A_log"])  # [H]
    a_log = dt * A
    xh = xin.reshape(b, s, nh, hd)
    xdt = xh.to(f32) * dt[..., None]

    h0 = cache["ssm"].narrow(1, h0_, nh) if cache is not None else None
    # a decode step (s=1) pads to a chunk of 16, as the reference does
    y, hN = ssd_chunked(xdt, a_log, B_.to(f32), C_.to(f32), chunk=min(128, max(16, s)), h0=h0)
    y = y + xh.to(f32) * p["D"][None, None, :, None]
    y = y.reshape(b, s, dl).to(x.dtype)
    # over all of d_in: the fp32 sum of squares all-reduced (and its gradient)
    reduce = (lambda ss: par.enter_tp(par.exit_tp(ss))) if tp else None
    y = rms_norm(y * silu(z), p["norm_w"], reduce=reduce, width=d_in)
    out = pdot(y, p["w_out"])
    new_cache = None
    if cache is not None:
        if tp:  # the caches are whole over the model axis
            ncx = par.gather_tp(ncx, 2)
            hN = par.gather_tp(hN, 1)
        new_cache = {
            "conv_x": ncx.to(cache["conv_x"].dtype),
            "conv_B": ncB.to(cache["conv_B"].dtype),
            "conv_C": ncC.to(cache["conv_C"].dtype),
            "ssm": hN.to(cache["ssm"].dtype),
        }
    return (par.exit_tp(out) if tp else out), new_cache
