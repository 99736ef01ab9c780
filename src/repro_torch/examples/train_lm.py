"""End-to-end training driver example: train a qwen2-family model for a few
hundred steps on synthetic data with checkpointing and fault tolerance, then
verify the loss dropped; the twin of ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

Default width is CPU-sized (~20M params, finishes in minutes on one core);
``--d-model 768 --layers 12`` is the ~100M configuration for an
accelerator, where the identical driver scales via --data-par/--model-par
(see repro_torch.launch.train). Runs on the card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np

from ..configs import registry
from ..kernels import ops as kops
from ..launch import train as train_mod


def register(d_model: int = 256, layers: int = 4):
    """The ~100M-param custom config in the qwen2 family (at these widths),
    registered as ``qwen2-100m`` in :data:`registry.ARCHS`."""
    cfg = dataclasses.replace(
        registry.get_arch("qwen2-1.5b"),
        name="qwen2-100m", n_layers=layers, d_model=d_model,
        n_heads=8, n_kv_heads=2, d_ff=d_model * 4, vocab_size=32000,
        head_dim=32,
    )
    registry.ARCHS[cfg.name] = cfg
    return cfg


def run(steps: int = 300, d_model: int = 256, layers: int = 4, device: str = "cuda",
        global_batch: int = 16, seq: int = 128, log_every: int = 20,
        ckpt_dir: Optional[str] = None) -> Dict:
    """Train ``qwen2-100m`` with the reference's flags (16 x 128, lr 1e-3, a
    checkpoint every 100 steps into ``ckpt_dir``, a fresh temporary
    directory by default, removed after) and assert that the loss fell;
    returns the logged history and the first and last loss (each the mean
    of two logged steps)."""
    cfg = register(d_model, layers)
    own = ckpt_dir is None
    root = tempfile.mkdtemp() if own else None
    ckpt = os.path.join(root, "ckpt") if own else ckpt_dir
    kops.reset_kernel_counters()
    try:
        hist: List[Dict] = train_mod.main([
            "--arch", cfg.name, "--steps", str(steps),
            "--global-batch", str(global_batch), "--seq", str(seq), "--lr", "1e-3",
            "--log-every", str(log_every), "--ckpt-dir", ckpt, "--ckpt-every", "100",
            "--device", device,
        ])
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)
    first = float(np.mean([h["loss"] for h in hist[:2]]))
    last = float(np.mean([h["loss"] for h in hist[-2:]]))
    print(f"\nloss: {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first - 0.2 else 'no significant change'})")
    print(f"kernel launches: {json.dumps(dict(kops.kernel_call_counts(), by_k={}))}")
    assert last < first, "training did not reduce the loss"
    return {"history": hist, "first": first, "last": last}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.steps, args.d_model, args.layers, args.device)
    print("OK")
    return out


if __name__ == "__main__":
    main()
