"""A serving cell's memory a device, reckoned leaf by leaf (no card): the
model built on ``meta`` with the dry run's shardings and head policy, as
rank 0 of a fake group of 256 ranks (16x16) and of 512 (2x16x16).

Per mesh it prints the float32 parameters at rest, their cast at rest
(the reference's cast rule: bf16 where the leaf has two or more dims and
is not kept in float32), the cache of the data shard's rows, the units
that serving makes ready at their use, largest first: each body unit's
(one rep's) and each other leaf group's weights gathered over the data
axes and, where a layer computes with another slice than its stored
chunk, over the model axis; and, for each top-level part of the tree, the
bytes a rank's all-gathers move to make it ready whole once
(``parallel.full``, counted by the census).

  PYTHONPATH=src python tools/serve_memory.py deepseek-v3-671b decode_32k
"""

from __future__ import annotations

import argparse
import collections
import math


def reckon(arch: str, shape_name: str, multi_pod: bool, top: int = 6) -> dict:
    import torch

    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_model
    from repro_torch.models import parallel
    from repro_torch.models.transformer import KEEP_F32, flatten_tree

    shape = SHAPES[shape_name]
    with dryrun.fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        model = build_model(get_arch(arch), "meta", mesh=mesh, pad_heads=shape.kind != "decode")
        par = model.par
        f32 = cast = 0
        at_use: collections.Counter = collections.Counter()
        for name, p in model.named_parameters():
            local = p.to_local()
            parts = name.split(".")
            size = 2 if local.dim() >= 2 and parts[-1] not in KEEP_F32 else 4
            f32 += 4 * local.numel()
            cast += size * local.numel()
            shp = list(local.shape)
            for axis, dim, take in par.steps[name]:
                if dim is not None:
                    shp[dim] *= par.sizes[axis]
                if take is not None:
                    shp[take[0]] = sum(hi - lo for lo, hi in take[1])
            ready = math.prod(shp) * size
            if parts[0] in ("body", "encoder"):  # stacked: one rep at a time
                ready //= shp[0]
            unit = ".".join(parts[:2]) if parts[0] in ("body", "prefix", "mtp") else parts[0]
            at_use[unit] += ready
        moved = {}
        for part, tree in model.cast_params().items():
            with ha.Census() as c:
                parallel.full(tree)
            moved[part] = c.step.moved
        rows = par.rows(torch.empty(shape.global_batch, device="meta")).shape[0]
        cache = model.init_cache(rows, shape.seq_len)
        cache_bytes = sum(t.numel() * t.element_size() for t in flatten_tree(cache).values()
                          if torch.is_tensor(t))
    return {"mesh": "2x16x16" if multi_pod else "16x16", "f32_at_rest": f32,
            "cast_at_rest": cast, "cache": cache_bytes, "rows": rows,
            "at_use": at_use.most_common(top), "moved_whole": moved}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    args = ap.parse_args(argv)
    for multi_pod in (False, True):
        r = reckon(args.arch, args.shape, multi_pod)
        print(f"{args.arch} x {args.shape} on {r['mesh']}, bytes a device: float32 parameters "
              f"at rest {r['f32_at_rest']}, their cast at rest {r['cast_at_rest']}, the cache "
              f"of {r['rows']} rows {r['cache']}")
        for unit, b in r["at_use"]:
            print(f"  made ready at its use: {unit} {b}")
        print("  all-gather bytes a rank moves to make each part ready whole once: "
              + ", ".join(f"{k} {v}" for k, v in r["moved_whole"].items()))


if __name__ == "__main__":
    main()
