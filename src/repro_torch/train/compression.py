"""Gradient compression for a slow reduction axis; the twin of
``repro/train/compression.py`` on torch tensors.

* :func:`quantize_int8` / :func:`dequantize_int8` — per-row symmetric int8
  quantization (row = trailing dim), 4x smaller wires than fp32; the
  reference's payloads and scales bit for bit;
* :class:`ErrorFeedback` — residual accumulation so quantization error is
  re-injected next step (EF-SGD; keeps convergence);
* :func:`compressed_psum` — int8 mean-reduce over a ``torch.distributed``
  group: quantize -> all_gather int8 payloads and scales -> dequantize and
  average locally. For g participants this moves g x int8 instead of 2x
  fp32 ring traffic — a win for small g (the pods of a multi-pod job).

Gradients are mappings from parameter name to tensor, as the training
step's. Nothing on the training path uses this module, as in the
reference: ``launch/train.py`` keeps the uncompressed default, and the
pod axis it would compress arrives with the port's sharding (A14c).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch
import torch.distributed as dist


class QuantState(NamedTuple):
    q: torch.Tensor  # int8 payload
    scale: torch.Tensor  # per-row fp32 scale


def quantize_int8(x: torch.Tensor) -> QuantState:
    """Symmetric per-row int8 quantization over the trailing dim."""
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return QuantState(q=q, scale=scale)


def dequantize_int8(qs: QuantState, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (qs.q.to(torch.float32) * qs.scale).to(dtype)


class ErrorFeedback(NamedTuple):
    residual: Dict[str, torch.Tensor]  # float32, one per gradient

    @staticmethod
    def init(grads: Mapping[str, torch.Tensor]) -> "ErrorFeedback":
        return ErrorFeedback(residual={k: torch.zeros(g.shape, dtype=torch.float32,
                                                      device=g.device)
                                       for k, g in grads.items()})


def compress_with_feedback(
    grads: Mapping[str, torch.Tensor], ef: ErrorFeedback
) -> Tuple[Dict[str, QuantState], Dict[str, torch.Tensor], ErrorFeedback]:
    """Returns (quantized mapping, dequantized-for-use mapping, new feedback).

    The residual (what int8 could not represent) is added back before the
    next quantization, so the long-run average is unbiased.
    """
    qs_map, deq_map, residual = {}, {}, {}
    for k, g in grads.items():
        corrected = g.to(torch.float32) + ef.residual[k]
        qs_map[k] = quantize_int8(corrected)
        deq_map[k] = dequantize_int8(qs_map[k])
        residual[k] = corrected - deq_map[k]
    return qs_map, deq_map, ErrorFeedback(residual=residual)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 mean-reduce of ``x`` over the ranks of ``group`` (the default
    group without one): every rank gets the same mean.

    quantize locally -> all_gather int8 payloads and scales -> dequantize
    and average locally. Wire bytes: g x (n/4 + n/rowsize) fp32-equivalents
    vs 2 x n fp32 for a ring all-reduce.
    """
    qs = quantize_int8(x)
    g = dist.get_world_size(group)
    qg = [torch.empty_like(qs.q) for _ in range(g)]
    sg = [torch.empty_like(qs.scale) for _ in range(g)]
    dist.all_gather(qg, qs.q.contiguous(), group=group)
    dist.all_gather(sg, qs.scale.contiguous(), group=group)
    deq = torch.stack(qg).to(torch.float32) * torch.stack(sg)
    return (torch.sum(deq, dim=0) / g).to(x.dtype)
