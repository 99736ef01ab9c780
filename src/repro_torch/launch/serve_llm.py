"""Batched **LLM** serving driver: transformer prefill + greedy decode loop;
the port of ``repro.launch.serve_llm``.

This drives the transformer stack (``repro_torch.models`` /
``repro_torch.configs``) — it is NOT the quantum-circuit simulation
service (:mod:`repro_torch.launch.serve_sim`). Weights are random, drawn
from ``--seed``; prompts and the audio/vision stub inputs come from a CPU
``torch.Generator(seed)``, so every device sees the same ones. Runs on the
card unless given ``--device cpu``.

With ``--data-par``/``--model-par`` above 1 it runs under ``torchrun``, one
process per device of the ``data x model`` mesh (``--dist-backend``:
``nccl``, one rank per card, the default on CUDA; ``gloo``, the default on
the CPU and the way to run several ranks on one card): the model is
sharded with the reference's rules, each rank keeps its shards of the
weights at rest (cast, never gathered whole) and every step gathers each
layer's at its use, as the reference's jitted step does; each data shard
decodes its rows, and only rank 0 prints (on the card, with each rank's
serving peak: the most device memory it held after the build).

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve_llm --arch qwen2-1.5b --reduced \\
      --batch 4 --prompt-len 32 --gen-len 16 --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve_llm \\
      --arch qwen2-1.5b --reduced --data-par 2 --model-par 2 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import io
import time
from dataclasses import dataclass, field
from typing import Dict

import torch

from ..configs.registry import get_arch
from ..device import resolve_device
from ..models.parallel import collective_bytes, reset_collectives
from .mesh import join_lm_mesh, print_peaks
from .steps import build_model, make_decode_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class ServeRun:
    """What :func:`run` leaves: the generated tokens, [B, G] int32 (the
    prefill's token and G - 1 decode steps; on a mesh, the whole batch on
    every rank), and this rank's collective bytes (``weights``: the cast,
    none with the shards at rest; ``prefill``, ``decode``: a step's, each
    with its gathers of the weights; empty off a mesh)."""

    tokens: torch.Tensor
    collective_bytes: Dict[str, int] = field(default_factory=dict)


def main(argv=None) -> torch.Tensor:
    """Returns the generated tokens (:attr:`ServeRun.tokens`)."""
    return run(argv).tokens


def run(argv=None) -> ServeRun:
    """Parse ``argv`` and serve; returns the :class:`ServeRun`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="with --data-par/--model-par above 1: the process group's backend "
                         "(nccl on cuda, one rank per card; gloo on cpu)")
    args = ap.parse_args(argv)

    ctx = mesh = None
    if args.data_par > 1 or args.model_par > 1:
        ctx, mesh = join_lm_mesh(ap, args.arch, args.data_par, args.model_par, args.dist_backend,
                                 args.device, "repro_torch.launch.serve_llm")
    elif args.dist_backend is not None:
        ap.error("--dist-backend needs --data-par or --model-par above 1")
    try:
        # only rank 0 prints
        quiet = ctx is not None and ctx.rank != 0
        with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
            return _serve(args, ctx, mesh)
    finally:
        if ctx is not None:
            ctx.close()


def _serve(args, ctx, mesh) -> ServeRun:
    device = resolve_device(args.device) if ctx is None else ctx.device
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if mesh is not None:
        print(f"mesh: data {args.data_par} x model {args.model_par} on {ctx.world} ranks "
              f"({ctx.backend})")
    model = build_model(cfg, device, torch.Generator(device=device).manual_seed(args.seed),
                        remat=False, mesh=mesh)
    if mesh is not None and device.type == "cuda":  # the printed peaks: serving's
        torch.cuda.reset_peak_memory_stats(device)
    reset_collectives()
    # cast once: the bits each forward would cast to. On a mesh each rank's
    # shards stay at rest (no collective here): prefill and every decode
    # step gather each layer's weights at its use
    params = model.cast_params()
    moved = {"weights": collective_bytes()}

    B, P, G = args.batch, args.prompt_len, args.gen_len
    gen = torch.Generator().manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, dtype=torch.int32)
    prompts = prompts.to(device)
    extras = None
    stub = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if stub:
        x = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen)
        extras = {stub: x.to(torch.bfloat16).to(device)}
    decode = make_decode_step(model)

    _sync(device)
    reset_collectives()
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, extras=extras, cache_len=P + G, params=params)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    moved["prefill"] = collective_bytes()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]

    out = [tok]
    reset_collectives()
    t0 = time.perf_counter()
    for _ in range(G - 1):
        tok, cache = decode(params, tok, cache, extras)
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    moved["decode"] = collective_bytes() // max(G - 1, 1)
    tokens = torch.cat(out, dim=1)
    print(f"prefill: {B}x{P} tokens in {t_prefill:.3f}s "
          f"({B*P/max(t_prefill, 1e-9):,.0f} tok/s)")
    print(f"decode: {B}x{G-1} tokens in {t_decode:.3f}s "
          f"({B*(G-1)/max(t_decode, 1e-9):,.0f} tok/s)")
    print("sample generations (token ids):")
    for row in tokens[: min(B, 3)].cpu():
        print("  ", row[:16].tolist())
    if mesh is None:
        return ServeRun(tokens)
    print(f"collective bytes per rank: weights {moved['weights']}, prefill "
          f"{moved['prefill']}, decode {moved['decode']} a step")
    print_peaks(device)
    return ServeRun(tokens, moved)


if __name__ == "__main__":
    main()
