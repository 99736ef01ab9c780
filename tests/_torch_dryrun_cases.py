"""The cases of ``tests/test_torch_dryrun.py`` that join a fake process
group, run in one subprocess of their own (``python
tests/_torch_dryrun_cases.py OUT.json RESULTS_DIR``) so the test worker's
``torch.distributed`` state stays clean; each writes its figures into the
JSON the tests read. Imports torch and the port only."""

import json
import sys

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun, hlo_analysis as ha
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import abstract_state, build_model, jitted_serve_step, \
    make_decode_step, make_train_step
from repro_torch.models import parallel
from repro_torch.optim import adamw

PER_DEVICE_ARCHS = ("qwen2-1.5b", "deepseek-v3-671b", "jamba-1.5-large-398b")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def collectives():
    """Each collective kind once on a world-4 fake group (float32)."""
    import torch.distributed._functional_collectives as fc

    out = {}
    with dryrun.fake_group(4):
        cases = {
            "all_reduce": lambda: dist.all_reduce(_meta(1000)),
            "all_gather": lambda: dist.all_gather([_meta(100) for _ in range(4)], _meta(100)),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(_meta(400), _meta(100)),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(_meta(100), _meta(400)),
            "all_to_all_single": lambda: dist.all_to_all_single(_meta(400), _meta(400)),
            "broadcast": lambda: dist.broadcast(_meta(100), src=0),
            "send": lambda: dist.send(_meta(100), dst=1),
            "recv": lambda: dist.recv(_meta(100), src=1),
            "functional_all_reduce": lambda: fc.wait_tensor(
                fc.all_reduce(_meta(1000), "sum", dist.group.WORLD)),
            "functional_all_gather": lambda: fc.wait_tensor(
                fc.all_gather_tensor(_meta(100), 0, dist.group.WORLD)),
            "functional_reduce_scatter": lambda: fc.wait_tensor(
                fc.reduce_scatter_tensor(_meta(400), "sum", 0, dist.group.WORLD)),
        }
        for name, call in cases.items():
            with ha.Census() as c:
                call()
            out[name] = c.step.collectives
    return out


def pr27_mesh():
    """qwen2-1.5b at full width on a 2x2 fake group: a bf16 train step as
    ``train.main`` runs it (8 x 128, remat, one microbatch) and serving as
    ``serve_llm`` runs it (batch 4, prompt 128, 8 generated), each beside
    ``models/parallel.COLLECTIVES`` of the same run."""
    cfg = get_arch("qwen2-1.5b")
    out = {}
    with dryrun.fake_group(4):
        mesh = make_host_mesh(data=2, model=2, device="cpu")
        model = build_model(cfg, "meta", mesh=mesh)
        params, opt_state = abstract_state(model, adamw.AdamWConfig())
        batch = {k: _meta(8, 128, dtype=torch.int32) for k in ("tokens", "labels")}
        parallel.reset_collectives()
        with ha.Census() as c:
            make_train_step(model, adamw.AdamWConfig())(params, opt_state, batch)
        out["train"] = {"census": c.step.as_dict(),
                        "counter": {k: list(v) for k, v in parallel.COLLECTIVES.items()},
                        "memory": c.memory}
        del model, params, opt_state

        model = build_model(cfg, "meta", remat=False, mesh=mesh)
        B, P, G = 4, 128, 8
        moved = {}
        parallel.reset_collectives()
        with ha.Census() as c:
            with ha.section("weights"):
                weights = model.cast_params()
            moved["weights"] = parallel.collective_bytes()
            parallel.reset_collectives()
            with ha.section("prefill"):
                logits, cache = model.prefill(_meta(B, P, dtype=torch.int32), cache_len=P + G,
                                              params=weights)
            moved["prefill"] = parallel.collective_bytes()
            parallel.reset_collectives()
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            step = make_decode_step(model)
            with ha.section("decode"):
                for _ in range(G - 1):
                    tok, cache = step(weights, tok, cache)
            moved["decode"] = parallel.collective_bytes() // (G - 1)
        out["serve"] = {"census": {k: c[k].moved for k in ("weights", "prefill", "decode")},
                        "decode_steps": G - 1, "counter": moved}
    return out


def per_device():
    """Each rank's local parameter and moment shapes on the production meshes."""
    out = {}
    for arch in PER_DEVICE_ARCHS:
        for multi_pod in (False, True):
            with dryrun.fake_group(512 if multi_pod else 256):
                mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
                model = build_model(get_arch(arch), "meta", mesh=mesh)
                params, opt = abstract_state(model, adamw.AdamWConfig())

                def local(named):
                    return {k: [list(v.to_local().shape), str(v.dtype)]
                            for k, v in named.items()}

                out[f"{arch}|{multi_pod}"] = {"params": local(params), "m": local(opt.m),
                                              "v": local(opt.v)}
    return out


def cli(results_dir):
    """One cell of the CLI end to end, its resume, a skipped cell, the same
    cell's step split into its weights made ready whole and the step on
    them, and the refusals."""
    from io import StringIO
    from contextlib import redirect_stdout

    argv = ["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--mesh", "multi",
            "--results-dir", results_dir]
    runs = []
    for extra in ([], [], ["--shape", "long_500k"]):
        buf = StringIO()
        with redirect_stdout(buf):
            counts = dryrun.main(argv + extra)
        runs.append({"counts": counts, "out": buf.getvalue()})
    with open(dryrun.cell_path(results_dir, "qwen2-1.5b", "decode_32k", True)) as f:
        cell = json.load(f)
    # the same cell's step split in two: its weights made ready whole once
    # (``parallel.full`` of the cast at rest), then the decode step on them
    split = {}
    with dryrun.fake_group(512):
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        model = build_model(get_arch("qwen2-1.5b"), "meta", mesh=mesh, pad_heads=False)
        _, args = jitted_serve_step(model, mesh, SHAPES["decode_32k"], True)
        with ha.Census() as c:
            weights = parallel.full(model.cast_params(args[0]))
        split["gathered_tree"] = c.step.collectives
        with ha.Census() as c:
            make_decode_step(model)(weights, *args[1:])
        split["step_on_tree"] = c.step.collectives
    refused = {}
    with dryrun.fake_group(4):
        try:
            with dryrun.fake_group(256):
                pass
        except RuntimeError as e:
            refused["nested"] = str(e)
        try:
            make_production_mesh(device="cpu")
        except ValueError as e:
            refused["mesh"] = str(e)
    return {"runs": runs, "cell": cell, "split": split, "refused": refused}


def main(out_path: str, results_dir: str) -> None:
    torch.set_num_threads(1)
    res = {"collectives": collectives(), "pr27": pr27_mesh(), "per_device": per_device(),
           "cli": cli(results_dir)}
    with open(out_path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
