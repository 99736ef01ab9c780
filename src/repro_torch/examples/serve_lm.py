"""Batched serving example: prefill + greedy decode with a KV cache on the
reduced deepseek-v2-lite config (MLA attention, MoE experts), the same
serving step the ``decode_32k`` dry-run cells count; the twin of
``examples/serve_lm.py``. Runs on the card unless given ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..kernels import ops as kops
from ..launch import serve_llm as serve_mod

ARGV = ["--arch", "deepseek-v2-lite-16b", "--reduced",
        "--batch", "4", "--prompt-len", "32", "--gen-len", "16"]


def run(argv=ARGV, device: str = "cuda") -> torch.Tensor:
    """``serve_llm.main`` on ``argv`` (the reference's flags by default) on
    ``device``; returns the generated tokens, ``[batch, gen-len]``."""
    kops.reset_kernel_counters()
    tokens = serve_mod.main(list(argv) + ["--device", device])
    print(f"kernel launches: {json.dumps(dict(kops.kernel_call_counts(), by_k={}))}")
    return tokens


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    tokens = run(device=args.device)
    print("OK")
    return tokens


if __name__ == "__main__":
    main()
