"""Shared neural-net layers (functional, param-dict style): the port of
``repro.models.layers``.

Mixed dtypes follow the reference's promotion: a bf16 activation meeting an
fp32 leaf (a 1-D bias the cast rule left in fp32) computes in fp32, as
``jnp`` does, and torch's promotion for tensors of one or more dimensions
is the same.

The activations (:func:`sigmoid`, :func:`silu`, :func:`gelu_tanh`) are
written op by op as ``jax.nn`` defines them: XLA rounds a bf16 result after
each elementwise op, and so does torch, so in bf16 they give the
reference's bits, where ``F.silu``/``F.gelu`` (one rounding of an fp32
result) differ in a third to two fifths of their outputs by an ulp. In a
model whose rms norms meet rows of small norm (the reduced Mamba-2) such
ulps grow to tenths of a logit.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def dense_init(generator: Optional[torch.Generator], shape, in_axis=0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Normal weights with std ``1/sqrt(fan_in)``, drawn from ``generator``
    on its own device and placed on ``device``. ``generator=None`` allocates
    the tensor without drawing (a model whose weights are loaded next)."""
    fan_in = shape[in_axis] if in_axis is not None else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, device=generator.device) * std
    return w.to(dtype=dtype, device=device)


def einsum_as(sub: str, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``jnp.einsum(sub, a, b, preferred_element_type=dtype)``: operands of
    two dtypes are promoted first, as ``jnp.einsum`` promotes them, and the
    result is given in ``dtype``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(sub, a.to(dt), b.to(dt)).to(dtype)


def pdot(x: torch.Tensor, w: torch.Tensor, sub: Optional[str] = None) -> torch.Tensor:
    """Projection GEMM keeping the OUTPUT in the activation dtype.

    ``sub``: optional einsum subscript (default '...a,ab->...b').
    """
    return einsum_as(sub or "...a,ab->...b", x, w, x.dtype)


def rms_norm(x, w, eps: float = 1e-6, reduce=None, width: int = 0):
    dt = x.dtype
    # statistics in fp32; x is consumed in its own dtype and the fp32 master
    # scale is cast at use, so the residual stream never upcasts
    sq = torch.square(x.to(torch.float32))
    if reduce is None:
        var = torch.mean(sq, dim=-1, keepdim=True)
    else:  # x is this rank's channels of ``width``: ``reduce`` sums over the ranks
        var = reduce(torch.sum(sq, dim=-1, keepdim=True)) / width
    scale = torch.rsqrt(var + eps).to(dt)
    return x * scale * w.to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * w.to(dt) + b.to(dt)


def apply_norm(cfg_norm: str, x, p: Dict):
    if cfg_norm == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


def norm_params(cfg_norm: str, d: int, dtype=torch.float32, device=None) -> Dict:
    if cfg_norm == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    return {"w": torch.ones((d,), dtype=dtype, device=device)}


# ----------------------------------------------------------- activations


def sigmoid(x):
    """``jax.nn.sigmoid``: ``1 / (1 + exp(-x))``, rounded after each op."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * sigmoid(x)


def gelu_tanh(x):
    """``jax.nn.gelu`` (its default, the tanh approximation), with its
    constants rounded to x's dtype as jnp's weak-typed scalars are."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * x**3)))
    return x * cdf


# ----------------------------------------------------------------- RoPE


@functools.lru_cache(maxsize=None)
def _inv_freq(rot: int, theta: float, device: torch.device) -> torch.Tensor:
    # numpy float32, as the reference computes it: theta ** (f32 / rot) in f32
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


def clear_rope_cache() -> None:
    """Drop the RoPE tables cached per ``(rot, theta, device)``. A dry run
    clears them before each cell: a table cached by an earlier cell in the
    process would count in the cell's census as an argument, not as its
    output."""
    _inv_freq.cache_clear()


def rope_freqs(head_dim: int, theta: float, rotary_frac: float = 1.0,
               device=None) -> Tuple[torch.Tensor, int]:
    """``(inv_freq [rot/2], rot)``: ``rot = int(head_dim * frac) // 2 * 2``
    leading dims of each head rotate (stablelm rotates a quarter)."""
    rot = int(head_dim * rotary_frac) // 2 * 2
    return _inv_freq(rot, float(theta), torch.device(device or "cpu")), rot


def apply_rope(x, positions, inv_freq, rot: int):
    """x: [..., S, H, D]; positions: [..., S] (broadcastable). Rotation
    pairs are interleaved (``x[..., 0::2]`` with ``x[..., 1::2]``)."""
    if rot == 0:
        return x
    ang = positions[..., :, None].to(torch.float32) * inv_freq  # [..., S, rot/2]
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    # the reference concatenates in fp32 and casts back; xp is exact in x's dtype
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ----------------------------------------------------------------- MLP


def mlp_params(generator, d: int, f: int, act: str, bias: bool, dtype=torch.float32,
               device=None) -> Dict:
    p = {}
    p["wi"] = dense_init(generator, (d, f), 0, dtype, device)
    if act == "swiglu":
        p["wg"] = dense_init(generator, (d, f), 0, dtype, device)
    p["wo"] = dense_init(generator, (f, d), 0, dtype, device)
    if bias:
        p["bi"] = torch.zeros((f,), dtype=dtype, device=device)
        p["bo"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def mlp_apply(p: Dict, x, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = silu(pdot(x, p["wi"])) * pdot(x, p["wg"])
    else:
        h = pdot(x, p["wi"])
        if "bi" in p:
            h = h + p["bi"]
        h = gelu_tanh(h)
    out = pdot(h, p["wo"])
    if "bo" in p:
        out = out + p["bo"]
    return out


# ----------------------------------------------------------------- loss


def softmax_cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4):
    """logits: [..., V] (computed in fp32); labels int. Returns mean loss.
    On a vocabulary-parallel mesh: :func:`vocab_parallel_cross_entropy`."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse**2
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(loss)


def vocab_parallel_cross_entropy(logits, labels, start: int, par, mask=None,
                                 z_loss: float = 1e-4):
    """:func:`softmax_cross_entropy` of logits split over the vocabulary:
    ``logits`` [..., V / tp] are this rank's columns, from column ``start``
    of the (padded) vocabulary, and ``par`` sums over the ranks (a
    :class:`~repro_torch.models.parallel.MeshPlan`: ``max_tp``, ``exit_tp``).
    The max, the sum of exponentials and the label's logit are one
    all-reduce each; no rank holds the whole ``[..., V]``. The z-loss comes
    from the same log-sum-exp, over every column (the padded ones too), as
    the reference's. Float32 sums in another order than
    :func:`softmax_cross_entropy`'s, so the result differs by rounding."""
    logits = logits.to(torch.float32)
    n = logits.shape[-1]
    m = par.max_tp(torch.amax(logits, dim=-1))
    lse = m + torch.log(par.exit_tp(torch.sum(torch.exp(logits - m[..., None]), dim=-1)))
    ids = labels.to(torch.int64) - start
    inside = (ids >= 0) & (ids < n)
    ll = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    ll = par.exit_tp(torch.where(inside, ll, torch.zeros((), device=ll.device)))
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse**2
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(loss)
