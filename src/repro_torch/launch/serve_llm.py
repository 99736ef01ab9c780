"""Batched **LLM** serving driver: transformer prefill + greedy decode loop;
the port of ``repro.launch.serve_llm``.

This drives the transformer stack (``repro_torch.models`` /
``repro_torch.configs``) — it is NOT the quantum-circuit simulation
service (:mod:`repro_torch.launch.serve_sim`). Weights are random, drawn
from ``--seed``; prompts and the audio/vision stub inputs come from a CPU
``torch.Generator(seed)``, so every device sees the same ones. Runs on the
card unless given ``--device cpu``.

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve_llm --arch qwen2-1.5b --reduced \\
      --batch 4 --prompt-len 32 --gen-len 16 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs.registry import get_arch
from ..device import resolve_device
from .steps import ParallelismNotPorted, build_model, make_decode_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> torch.Tensor:
    """Returns the generated tokens, [B, G] int32 (the prefill's token and
    G - 1 decode steps)."""
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
    args = ap.parse_args(argv)

    if args.data_par > 1 or args.model_par > 1:
        raise ParallelismNotPorted(
            f"--data-par {args.data_par} --model-par {args.model_par}: serving over ranks "
            "is A14c of the port's roadmap; run with both at 1")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device, torch.Generator(device=device).manual_seed(args.seed))
    params = model.cast_params()  # cast once: the bits each forward would cast to

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
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, extras=extras, cache_len=P + G, params=params)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]

    out = [tok]
    t0 = time.perf_counter()
    for _ in range(G - 1):
        tok, cache = decode(params, tok, cache, extras)
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1)
    print(f"prefill: {B}x{P} tokens in {t_prefill:.3f}s "
          f"({B*P/max(t_prefill, 1e-9):,.0f} tok/s)")
    print(f"decode: {B}x{G-1} tokens in {t_decode:.3f}s "
          f"({B*(G-1)/max(t_decode, 1e-9):,.0f} tok/s)")
    print("sample generations (token ids):")
    for row in tokens[: min(B, 3)].cpu():
        print("  ", row[:16].tolist())
    return tokens


if __name__ == "__main__":
    main()
