"""Multi-GPU dry run: every (arch x shape x mesh) cell's step traced on
``meta`` tensors under the census; the port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell for 256 or 512 placeholder XLA
devices. The port joins a fake process group (``torch.distributed``'s
``"fake"`` backend: every collective returns at once, moving nothing) of
256 ranks (the 16x16 ``(data, model)`` mesh) or 512 (2x16x16 ``(pod, data,
model)``) as rank 0, builds the production mesh on it with device type
``cpu`` (so a dry run never starts CUDA), builds the model on ``meta`` with
the reference's shardings and head policy, and runs rank 0's step
(``launch/steps.py``: ``jitted_train_step``/``jitted_serve_step``) under
:class:`~repro_torch.launch.hlo_analysis.Census`. Every rank of these
meshes runs the same shapes, so rank 0's counts are each device's.

Per cell this records into ``<results-dir>/<arch>__<shape>__<mesh>.json``:
  * ``memory``      (argument/output/temp/peak/alias bytes a device);
  * ``cost_flops``, ``cost_bytes`` (the step's FLOPs and fused-tier bytes);
  * ``census``      (each section's flops, byte tiers, op count and
                     collectives: ``step``, and a serving cell's
                     ``weights``, each rank's shards cast at rest: the
                     step gathers each layer at its use);
  * ``roofline``    (the three-term roofline against one H100's data-sheet
                     peaks, and whether the peak fits in its 80 GB);
  * ``trace_s``     (the traced step's seconds on the host; the reference's
                     ``lower_s``/``compile_s``);
  * the hardware's name and power limit the roofline assumes.

Resumable: existing ok/skipped result files are skipped unless ``--force``;
an error is recorded and the sweep goes on. Run on the CPU, no card needed:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh single
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import time
import traceback
from typing import Dict, Iterator, Optional

import torch.distributed as dist

from ..configs.base import SHAPES, shape_applicable
from ..configs.registry import ARCHS, get_arch
from ..models import layers
from ..optim import adamw
from . import hlo_analysis as ha
from .mesh import MULTI_POD_SHAPE, PRODUCTION_SHAPE, make_production_mesh
from .steps import build_model, jitted_serve_step, jitted_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun_results")


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """This process as rank 0 of a fake group of ``world`` ranks, destroyed
    at the end (so one process runs cells of both meshes). Refused inside
    a real process group."""
    if dist.is_initialized():
        raise RuntimeError("a dry run joins a fake process group of its own, and this process "
                           "is already in one: run it outside torchrun")
    # registers the "fake" backend (PyTorch's own, over FakeProcessGroup)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             opt_overrides: Optional[Dict] = None) -> Dict:
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": why}

    n_chips = math.prod(MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE)
    hw = ha.HardwareSpec()
    # every cell starts from the same state, whatever ran before it in the
    # process: no cached RoPE table, and the collector's counts at zero
    layers.clear_rope_cache()
    gc.collect()
    with fake_group(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        t0 = time.time()
        # decode steps are latency-bound on tiny per-token tensors: the
        # reference's policy turns head padding off for them (its QKV fusion
        # too); train/prefill keep padding
        model = build_model(cfg, "meta", mesh=mesh, pad_heads=(shape.kind != "decode"))
        if shape.kind == "train":
            opt_cfg = adamw.AdamWConfig(**(opt_overrides or {}))
            fn, args = jitted_train_step(model, opt_cfg, mesh, shape, multi_pod)
            model_flops = ha.model_flops_train(cfg, shape)
        else:
            fn, args = jitted_serve_step(model, mesh, shape, multi_pod)
            model_flops = ha.model_flops_serve(cfg, shape)
        t_build = time.time() - t0
        with ha.Census() as census:
            fn(*args)
        t_trace = time.time() - t0 - t_build
        del fn, args, model

    rl = ha.roofline_from_census(census, n_chips, hw, model_flops=model_flops)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    print(f"[{arch_name} x {shape_name} x {'multi' if multi_pod else 'single'}] "
          f"memory: {census.memory}")
    return {
        "status": "ok",
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_chips": n_chips,
        "kind": shape.kind,
        "build_s": t_build,
        "trace_s": t_trace,
        "memory": census.memory,
        "cost_flops": census.step.flops,
        "cost_bytes": census.step.bytes,
        "census": {k: v.as_dict() for k, v in census.sections.items()},
        "roofline": rl.as_dict(),
        "hardware": {"name": hw.name, "power_limit_w": hw.power_limit_w},
    }


def cell_path(results_dir, arch, shape, multi_pod):
    mesh = "multi" if multi_pod else "single"
    return os.path.join(results_dir, f"{arch}__{shape}__{mesh}.json")


def main(argv=None) -> Dict[str, int]:
    """Returns ``{"ok": n, "skipped": n, "failed": n}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--results-dir", default=os.path.normpath(RESULTS_DIR))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.arch != "all" and args.arch not in ARCHS:
        ap.error(f"unknown arch {args.arch!r}; available: all, {', '.join(sorted(ARCHS))}")
    if args.shape != "all" and args.shape not in SHAPES:
        ap.error(f"unknown shape {args.shape!r}; available: all, {', '.join(SHAPES)}")

    os.makedirs(args.results_dir, exist_ok=True)
    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                path = cell_path(args.results_dir, arch, shape, mp)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            continue
                t0 = time.time()
                try:
                    res = run_cell(arch, shape, mp)
                except Exception as e:  # record failure, keep sweeping
                    res = {"status": "error", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                res["wall_s"] = time.time() - t0
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                tag = res["status"].upper()
                if tag == "OK":
                    n_ok += 1
                    rl = res["roofline"]
                    print(f"OK   {arch} {shape} {'multi' if mp else 'single'} "
                          f"({res['wall_s']:.0f}s) dominant={rl['dominant']} "
                          f"peak={rl['peak_bytes'] / 1e9:.2f}GB fits={rl['fits']}")
                elif tag == "SKIPPED":
                    n_skip += 1
                    print(f"SKIP {arch} {shape}: {res['reason']}")
                else:
                    n_fail += 1
                    print(f"FAIL {arch} {shape} {'multi' if mp else 'single'}: "
                          f"{res['error']}")
    print(f"dry-run done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return {"ok": n_ok, "skipped": n_skip, "failed": n_fail}


if __name__ == "__main__":
    main()
