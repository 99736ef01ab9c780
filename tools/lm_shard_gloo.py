"""Where the time of the sharded LM path goes on one card: gloo's cost by
the call, against the collectives each step makes.

``chip_smoke.py``'s ``lm_shard_phase`` runs qwen2-1.5b in bf16 at full
width on 4 gloo ranks of one card (data 2 x model 2). This script puts two
checkouts of that phase side by side and breaks their times down.

  python tools/lm_shard_gloo.py count [--tree DIR]
      No card: the collectives a rank makes, by kind ``[calls, bytes]``,
      in the phase's bf16 train step and in one of its decode steps
      (meta tensors on a fake 2 x 2 group; the decode step as the phase
      serves it, from ``Model.cast_params``: where the checkout keeps the
      weights at rest, its all-gathers also make each layer's weights
      ready), and how many of the decode step's all-gathers make a step's
      new k/v whole for the cache (``MeshPlan.gather_kv``, where the
      checkout has it). DIR is the checkout to count (default: this one).

  torchrun --standalone --nproc-per-node 4 tools/lm_shard_gloo.py probe OUT
      On the card: the median time of one gloo all_gather, all_reduce and
      reduce_scatter over a model-axis group of 2 ranks (ranks {0, 1} and
      {2, 3}, as the 2 x 2 mesh groups them) on CUDA tensors, by size;
      rank 0 writes them to OUT.

  python tools/lm_shard_gloo.py compare PARENT_DIR [--out FILE]
      On the card: ``lm_shard_phase`` of PARENT_DIR, this checkout, this
      checkout and PARENT_DIR, each in a process of its own; then the probe
      and both checkouts' counts. Prints the card's name and power limit,
      then one JSON object of the figures (also written to FILE).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (64, 1024, 16384, 262144, 4194304)  # bytes a rank gives the collective
KINDS = ("all_gather", "all_reduce", "reduce_scatter")


def count(tree: str) -> dict:
    """See ``count`` above; imports the checkout at ``tree``."""
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch

    import chip_smoke
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import abstract_state, build_model, make_decode_step, \
        make_train_step
    from repro_torch.models import parallel
    from repro_torch.optim import adamw

    spec = chip_smoke.LM_SHARD
    torch.set_num_threads(1)
    cfg = get_arch(spec["arch"])
    cache_gathers = [0]
    if hasattr(parallel.MeshPlan, "gather_kv"):
        inner = parallel.MeshPlan.gather_kv

        def gather_kv(self, x):
            cache_gathers[0] += 1
            return inner(self, x)

        parallel.MeshPlan.gather_kv = gather_kv

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    def by_kind():
        return {k: list(v) for k, v in parallel.COLLECTIVES.items()}

    out = {"arch": spec["arch"], "mesh": [spec["data"], spec["model"]]}
    with dryrun.fake_group(spec["ranks"]):
        mesh = make_host_mesh(data=spec["data"], model=spec["model"], device="cpu")
        model = build_model(cfg, "meta", mesh=mesh)
        params, opt_state = abstract_state(model, adamw.AdamWConfig())
        batch = {k: meta(spec["train_batch"], spec["seq"]) for k in ("tokens", "labels")}
        parallel.reset_collectives()
        make_train_step(model, adamw.AdamWConfig())(params, opt_state, batch)
        out["train_step"] = by_kind()
        del model, params, opt_state
        model = build_model(cfg, "meta", remat=False, mesh=mesh)
        B, P, G = spec["batch"], spec["prompt"], spec["gen"]
        weights = model.cast_params()
        logits, cache = model.prefill(meta(B, P), cache_len=P + G, params=weights)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        step = make_decode_step(model)
        parallel.reset_collectives()
        cache_gathers[0] = 0
        step(weights, tok, cache)
        out["decode_step"] = by_kind()
        out["decode_cache_gathers"] = cache_gathers[0]
    return out


def probe(out_path: str) -> None:
    """See ``probe`` above (run under torchrun, 4 ranks, one card)."""
    import torch
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=int(os.environ["WORLD_SIZE"]))
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    group = groups[rank // 2]
    times = {}
    for kind in KINDS:
        for size in SIZES:
            x = torch.ones(size // 2, dtype=torch.bfloat16, device="cuda")
            reps = 40 if size < 1 << 20 else 10
            dts = []
            for i in range(reps + 3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if kind == "all_gather":
                    parts = [torch.empty_like(x) for _ in range(2)]
                    dist.all_gather(parts, x, group=group)
                elif kind == "all_reduce":
                    dist.all_reduce(x, group=group)
                else:
                    y = torch.empty(size // 4, dtype=torch.bfloat16, device="cuda")
                    dist.reduce_scatter_tensor(y, x, group=group)
                torch.cuda.synchronize()
                if i >= 3:
                    dts.append(time.perf_counter() - t0)
            times[f"{kind}/{size}"] = 1e3 * statistics.median(dts)
    dist.barrier()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"ms": times, "group": 2, "dtype": "bfloat16"}, f)
    dist.destroy_process_group()


def _phase(tree: str, card: str) -> dict:
    code = ("import json, sys; sys.path[:0] = ['.', 'src']; import chip_smoke; "
            "from repro_torch.kernels import ops; "
            f"f = chip_smoke.lm_shard_phase(ops, {card!r})['figures']; "
            "print('FIGURES ' + json.dumps({k: f[k] for k in ('serve', 'train', 'seconds')}))")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the phase in {tree} failed:\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("FIGURES ")][-1]
    fig = json.loads(line[len("FIGURES "):])
    return {"decode_ms_step": fig["serve"]["decode_ms_step"],
            "prefill_s": fig["serve"]["prefill_s"], "step_ms": fig["train"]["step_ms"],
            "first_step_ms": fig["train"]["first_step_ms"],
            "collective_bytes": {"serve": fig["serve"]["collective_bytes"],
                                 "train": fig["train"]["collective_bytes"]},
            "phase_s": fig["seconds"], "wall_s": time.time() - t0}


def compare(parent: str, out_path: str) -> dict:
    """See ``compare`` above."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for tag, tree in (("parent", parent), ("change", HERE), ("change", HERE),
                      ("parent", parent)):
        runs.append(dict(_phase(tree, card), tree=tag))
        print(json.dumps(runs[-1]), flush=True)
    probe_out = os.path.join(HERE, "build", "lm_shard_gloo_probe.json")
    os.makedirs(os.path.dirname(probe_out), exist_ok=True)
    subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "4", os.path.abspath(__file__), "probe", probe_out],
                   cwd=HERE, check=True, timeout=300, capture_output=True)
    with open(probe_out) as f:
        latency = json.load(f)
    counts = {}
    for tag, tree in (("parent", parent), ("change", HERE)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "count", "--tree",
                               tree], cwd=HERE, capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), check=True)
        counts[tag] = json.loads(proc.stdout.strip().splitlines()[-1])
    doc = {"card": card, "runs": runs, "gloo_ms": latency, "counts": counts}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1)
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("count")
    c.add_argument("--tree", default=HERE)
    p = sub.add_parser("probe")
    p.add_argument("out")
    m = sub.add_parser("compare")
    m.add_argument("parent")
    m.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.mode == "count":
        print(json.dumps(count(os.path.abspath(args.tree))))
    elif args.mode == "probe":
        probe(args.out)
    else:
        print(json.dumps(compare(os.path.abspath(args.parent), args.out)))


if __name__ == "__main__":
    main()
