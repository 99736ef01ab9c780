"""The port's dry-run tooling (``repro_torch.launch.dryrun``,
``launch/hlo_analysis.py``, the dry-run builders of ``launch/steps.py``)
against the reference's on the CPU.

The reference's dry run itself fails under jax 0.9 (``DuplicateSpecError``),
so the port is held to the reference functions that do run (the model-FLOP
formulas, ``abstract_state`` through ``jax.eval_shape``, ``params_shardings``
on an ``AbstractMesh``), to the contracts of the reference's own tests
(``tests/test_system.py``, ``tests/test_launch.py``), and to the collective
bytes a rank that ``models/parallel.COLLECTIVES`` counts for the same steps
(reckoned below; the ranks count the same on the card, ``chip_smoke.py``'s
``lm_shard_phase``). The cases that join a fake process group run in one subprocess
(``tests/_torch_dryrun_cases.py``) with a hard timeout; the rest here, on
``meta`` tensors."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import get_arch as ref_get_arch
from repro.launch import hlo_analysis as r_ha
from repro.launch import steps as r_steps
from repro.models import sharding as r_sharding
from repro.models.transformer import Model as RefModel
from repro.optim import adamw as r_adamw
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch.steps import abstract_state, build_model, jitted_serve_step, \
    jitted_train_step
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
CASES_TIMEOUT_S = 240

# Collective bytes a rank, qwen2-1.5b on data 2 x model 2 with attention,
# the MLPs and the vocabulary tensor parallel (d 1536, 28 layers, 12 + 2 + 2
# fused heads of 128, d_ff 8960, tied vocabulary 152064; bf16). A ring
# all-gather of b bytes a rank moves b, an all-reduce of b bytes 2 (n - 1)
# b / n (b on 2 ranks), a reduce-scatter of b bytes (n - 1) b / n.
# The cast gathers over data the rank's halves of embed (116785152), wqkv
# (44040192), wo (33030144) and wi/wg/wo (3 x 192675840), and over model the
# whole wqkv, whose q/k/v heads the rank slices (88080384): 859963392.
# A train step (8 x 128, 4 rows a data shard, remat) gathers the body twice
# (forward and recompute: 2 x 743178240) and embed once: 1603141632;
# reduce-scatters each gather's gradient once: 859963392; all-reduces per
# layer five [4, 128, 1536] activations (attention's and the MLP's exits,
# the attention exit recomputed, both entries' backward: 5 x 1572864) and
# 14336 bytes of replicated leaves' gradients (norm1, norm2, bqkv over data
# and bqkv's slices over model), then the embedding's exit and the head's
# entry (2 x 1572864), the cross-entropy's max, sum and label logit (3 x
# 2048), final_norm's float32 gradient (6144), the loss's mean (2 x 4) and
# AdamW's grad norm over the 4 ranks (6): 223760398. Serving (4 prompts of
# 128, 2 rows a data shard): prefill all-reduces two [2, 128, 1536]
# activations a layer and all-gathers its new k and v (one kv head a rank:
# 2 x 65536), 28 x 1703936, plus the embedding's exit (786432), the last
# logits over model (304128) and over data (608256): 49409024; a decode
# step the same at one token: 28 x 13312 + 6144 + 304128 + 608256 =
# 1291264.
PR29_TRAIN_STEP = 1603141632 + 859963392 + 223760398
# Serving with the shards at rest: the cast gathers nothing, and prefill and
# each decode step gather what it gathered, each layer's at its use (the
# body's 743178240, the embedding's 116785152): prefill 49409024 +
# 859963392 = 909372416, a decode step 1291264 + 859963392 = 861254656.
PR30_SERVE = {"weights": 0, "prefill": 49409024 + 859963392, "decode": 1291264 + 859963392}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    out = tmp / "cases.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_dryrun_cases.py"),
                           str(out), str(tmp / "results")], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=CASES_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# ------------------------------------------------------ copied functions


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_are_the_references(arch, shape):
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    assert ha.active_params(cfg) == r_ha.active_params(ref_cfg)
    if SHAPES[shape].kind == "train":
        assert ha.model_flops_train(cfg, SHAPES[shape]) == \
            r_ha.model_flops_train(ref_cfg, REF_SHAPES[shape])
    else:
        assert ha.model_flops_serve(cfg, SHAPES[shape]) == \
            r_ha.model_flops_serve(ref_cfg, REF_SHAPES[shape])


@pytest.mark.parametrize("contract", ["active_params_sane", "model_flops_scaling"])
def test_reference_contracts(contract):
    """The twins of ``tests/test_system.py::test_active_params_sane`` and
    ``tests/test_launch.py::test_model_flops_scaling``."""
    if contract == "active_params_sane":
        assert 25e9 < ha.active_params(get_arch("deepseek-v3-671b")) < 50e9
        assert 1.0e9 < ha.active_params(get_arch("qwen2-1.5b")) < 2.5e9
        assert 9e9 < ha.active_params(get_arch("mistral-nemo-12b")) < 15e9
    else:
        cfg = get_arch("mistral-nemo-12b")
        n = ha.active_params(cfg)
        assert ha.model_flops_train(cfg, SHAPES["train_4k"]) == pytest.approx(6 * n * 256 * 4096)
        assert ha.model_flops_serve(cfg, SHAPES["prefill_32k"]) == \
            pytest.approx(2 * n * 32 * 32768)
        assert ha.model_flops_serve(cfg, SHAPES["decode_32k"]) == pytest.approx(2 * n * 128)


# -------------------------------------------------------- abstract_state


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    params, opt = r_steps.abstract_state(RefModel(ref_get_arch(arch)), r_adamw.AdamWConfig())

    def named(tree):
        return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                (tuple(leaf.shape), str(leaf.dtype))
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}

    return named(params), named(opt.m), named(opt.v), (tuple(opt.step.shape), str(opt.step.dtype))


def _named(tensors):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tensors.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_state_is_the_references(arch):
    ref_params, ref_m, ref_v, ref_step = _ref_abstract(arch)
    model = build_model(get_arch(arch), "meta")
    params, opt = abstract_state(model)
    assert opt is None and _named(params) == ref_params
    params, opt = abstract_state(model, adamw.AdamWConfig())
    assert all(p.device.type == "meta" for p in params.values())
    assert _named(params) == ref_params
    assert _named(opt.m) == ref_m and _named(opt.v) == ref_v
    assert (tuple(opt.step.shape), str(opt.step.dtype).replace("torch.", "")) == ref_step


def test_abstract_state_of_a_model_off_meta_is_its_meta_twin():
    model = build_model(get_arch("qwen2-1.5b").reduced(), "cpu",
                        torch.Generator().manual_seed(0))
    params, _ = abstract_state(model)
    assert _named(params) == _named(dict(model.named_parameters()))
    assert all(p.device.type == "meta" for p in params.values())


def test_meta_is_taken_only_by_name():
    from repro_torch.device import resolve_device

    assert resolve_device("meta").type == "meta"
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
    with pytest.raises(ValueError, match="'cuda', 'cpu' or 'meta'"):
        resolve_device("xpu")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_step_builders_without_a_mesh(shape):
    """The builders' ``(fn, args)`` on one device: meta arguments, the step
    counted under the census, a serving step's cast apart."""
    cfg = get_arch("qwen2-1.5b").reduced()
    sc = SHAPES[shape]
    if sc.kind == "prefill":  # 32k tokens' chunked attention on meta takes ~20 s
        sc = dataclasses.replace(sc, seq_len=2048)
    model = build_model(cfg, "meta", pad_heads=sc.kind != "decode")
    if sc.kind == "train":
        fn, args = jitted_train_step(model, adamw.AdamWConfig(), None, sc, False)
        params, opt, batch = args
        assert set(batch) == {"tokens", "labels"} and batch["tokens"].shape == (256, 4096)
    else:
        fn, args = jitted_serve_step(model, None, sc, False)
        if sc.kind == "decode":
            assert args[1].shape == (128, 1)
            assert args[2]["body"]["l0"]["k"].shape[1:3] == (128, 32768)
    off_meta = [t for t in ha._tensors(args) if t.device.type != "meta"]
    assert off_meta == ([args[1].step] if sc.kind == "train" else [])  # AdamW's host count
    with ha.Census() as census:
        fn(*args)
    assert census.step.flops > 0 and census.step.dtensor_ops == 0
    if sc.kind == "train":
        # the parameters and moments are updated in place: aliased
        n = sum(p.numel() * (4 + 2 + 2) for p in args[0].values())
        assert census.memory["alias"] == n
        assert census.step.flops > 3 * 2 * 256 * 4096 * ha.active_params(cfg) * 0.9
    else:
        assert census["weights"].ops > 0
        assert census.memory["alias"] == (0 if sc.kind == "prefill" else
                                          sum(t.numel() * t.element_size()
                                              for t in ha._tensors(args[2])))
    with pytest.raises(ValueError, match="not on this mesh"):
        (jitted_train_step if sc.kind == "train" else jitted_serve_step)(
            model, *((adamw.AdamWConfig(),) if sc.kind == "train" else ()), object(), sc, False)


# --------------------------------------------------------- census units


def test_census_counts_a_loop_of_matmuls():
    """The twin of ``test_hlo_analyzer_on_known_program``: eager dispatch
    sees every iteration, so a loop of 5 matmuls counts 5 x 2mn^2."""
    m, n = 64, 64
    x, w = _meta(m, n), _meta(n, n)
    with ha.Census() as c:
        for _ in range(5):
            x = x @ w
    assert c.step.flops == 5 * 2 * m * n * n
    assert c.step.ops == 5 and c.step.collectives == {}


def test_census_of_x_at_x():
    """The twin of ``test_collective_census_parses_real_hlo``."""
    x = _meta(8, 8)
    with ha.Census() as c:
        x @ x
    assert ha.collective_stats(c) == {}
    assert c.step.flops == 2 * 8 * 8 * 8 == 1024
    assert c.step.bytes == c.step.bytes_upper == 3 * 8 * 8 * 4
    xc = _meta(8, 8, dtype=torch.complex64)
    with ha.Census() as c:
        xc @ xc
    assert c.step.flops == 4 * 1024


def test_views_move_no_bytes():
    x = _meta(4, 6, 8)
    with ha.Census() as c:
        y = x.view(24, 8).t().unsqueeze(0).expand(3, 8, 24)
        x.permute(2, 0, 1)[1:, :, 2].detach().reshape(7, 4)  # a view: no copy
        x.transpose(0, 1).unbind(0)
        torch.empty_like(x)
    assert c.step.ops == 0 and c.step.bytes_upper == 0 and c.step.flops == 0
    with ha.Census() as c:
        y.contiguous()  # a copy: read and written
        x + 1
    nb = 4 * 6 * 8 * 4
    assert c.step.ops == 2
    assert c.step.bytes_upper == (3 * nb + 3 * nb) + (nb + nb)
    assert c.step.bytes == 6 * nb  # only the copy is in the fused tier


def test_remat_forward_is_counted_twice():
    from torch.utils.checkpoint import checkpoint

    def f(x, w):
        return torch.relu(x @ w)

    flops = {}
    for remat in (False, True):
        x, w = _meta(32, 64, grad=True), _meta(64, 48, grad=True)
        with ha.Census() as c:
            y = checkpoint(f, x, w, use_reentrant=False) if remat else f(x, w)
            torch.autograd.grad(y.sum(), (x, w))
        flops[remat] = c.step.flops
    fwd = 2 * 32 * 64 * 48
    assert flops[False] == 3 * fwd  # forward, and the two gradient matmuls
    assert flops[True] == 4 * fwd


def test_census_peak_and_arguments():
    arg = _meta(1000)  # 4000 bytes, alive before the census
    with ha.Census() as c:
        a = torch.empty(100, device="meta")  # 400
        b = torch.empty(200, device="meta")  # 800
        del a
        cc = torch.empty(300, device="meta")  # 1200
        arg.add_(1)  # written in place: aliased
    assert c.memory == {"argument": 4000, "output": 2000, "temp": 2000, "peak": 6000,
                        "alias": 4000}
    del b, cc
    with ha.Census() as c:
        a = torch.empty(300, device="meta")
        b = torch.empty(200, device="meta")
        del a
        torch.empty(100, device="meta")  # released at once
    assert c.memory["peak"] == 2000 and c.memory["output"] == 800 and c.memory["argument"] == 0


def test_host_tensors_are_not_counted():
    with ha.Census() as c:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert c.step.ops == 0 and c.step.flops == 0 and c.memory["peak"] == 0


def test_roofline_from_census():
    x = _meta(4096, 4096, dtype=torch.bfloat16)
    with ha.Census() as c:
        x @ x
    hw = ha.HardwareSpec()
    rl = ha.roofline_from_census(c, 4, hw, model_flops=4 * 2 * 4096 ** 3)
    assert (hw.peak_flops, hw.tf32_flops, hw.fp32_flops) == (989e12, 495e12, 67e12)
    assert (hw.hbm_bw, hw.hbm_bytes, hw.nvlink_bw) == (3.35e12, 80e9, 450e9)
    assert rl.dominant == "compute" and rl.t_compute == 2 * 4096 ** 3 / 989e12
    assert rl.t_memory == 3 * 4096 * 4096 * 2 / 3.35e12 and rl.useful_ratio == 1.0
    assert rl.fits and rl.peak_bytes == 2 * 4096 * 4096 * 2
    d = rl.as_dict()
    assert {"flops", "hbm_bytes", "hbm_bytes_upper", "coll_bytes", "coll_detail", "t_compute_s",
            "t_memory_s", "t_collective_s", "dominant", "model_flops", "useful_ratio",
            "fits"} <= set(d)


# ------------------------------------------------- on a fake process group


_COLLECTIVE_CASES = {
    # name: (kind, result bytes, ring bytes one rank moves), float32 on 4 ranks
    "all_reduce": ("all-reduce", 4000, 2 * 3 * 4000 // 4),
    "functional_all_reduce": ("all-reduce", 4000, 2 * 3 * 4000 // 4),
    "all_gather": ("all-gather", 1600, 3 * 400),
    "all_gather_into_tensor": ("all-gather", 1600, 3 * 400),
    "functional_all_gather": ("all-gather", 1600, 3 * 400),
    "reduce_scatter_tensor": ("reduce-scatter", 400, 3 * 1600 // 4),
    "functional_reduce_scatter": ("reduce-scatter", 400, 3 * 1600 // 4),
    "all_to_all_single": ("all-to-all", 1600, 3 * 1600 // 4),
    "broadcast": ("broadcast", 400, 400),
    "send": ("collective-permute", 400, 400),
    "recv": ("collective-permute", 400, 400),
}


@pytest.mark.parametrize("name", sorted(_COLLECTIVE_CASES))
def test_census_counts_each_collective(cases, name):
    kind, result, moved = _COLLECTIVE_CASES[name]
    factor = {"all-reduce": 2.0}.get(kind, 1.0)
    assert kind == "broadcast" or ha._FACTOR[kind] == r_ha._FACTOR[kind] == factor
    assert cases["collectives"][name] == {
        kind: {"count": 1, "bytes": result, "traffic": result * factor, "moved": moved}}


def test_census_train_step_is_pr27s(cases):
    """The census of a full-width qwen2-1.5b bf16 train step on a 2x2 fake
    group against ``parallel.COLLECTIVES`` of the same step and the bytes
    reckoned above, exactly: every collective, AdamW's gradient-norm
    all-reduce (``optim/adamw.global_norm``) too."""
    train = cases["pr27"]["train"]
    counter, census = train["counter"], train["census"]
    assert sum(v[1] for v in counter.values()) == PR29_TRAIN_STEP
    assert census["moved"] == PR29_TRAIN_STEP
    colls = census["collectives"]
    for kind, name in (("all-gather", "all_gather"), ("reduce-scatter", "reduce_scatter"),
                       ("all-reduce", "all_reduce")):
        assert (colls[kind]["count"], colls[kind]["moved"]) == tuple(counter[name]), kind
    assert colls["all-gather"]["moved"] == 1603141632
    assert colls["reduce-scatter"]["moved"] == 859963392
    assert census["dtensor_ops"] == 0
    mem = train["memory"]
    assert mem["alias"] > 0 and mem["peak"] == mem["argument"] + mem["temp"]


@pytest.mark.parametrize("phase", ["weights", "prefill", "decode"])
def test_census_serving_is_pr27s(cases, phase):
    """Serving as ``serve_llm`` runs it, with the shards at rest: the
    census, ``parallel.COLLECTIVES`` and the bytes reckoned above agree."""
    serve = cases["pr27"]["serve"]
    census = serve["census"][phase]
    if phase == "decode":
        assert census % serve["decode_steps"] == 0
        census //= serve["decode_steps"]
    assert census == serve["counter"][phase] == PR30_SERVE[phase]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b", "jamba-1.5-large-398b"])
def test_per_device_bytes_are_the_references(cases, arch, mesh):
    multi_pod = mesh == "2x16x16"
    got = cases["per_device"][f"{arch}|{multi_pod}"]
    amesh = AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        AbstractMesh((16, 16), ("data", "model"))
    # the training policy pads the query heads for TP on both sides
    ref_cfg = r_steps.pad_heads_for_tp(ref_get_arch(arch), 16)
    shapes = jax.eval_shape(lambda: RefModel(ref_cfg).init(jax.random.PRNGKey(0)))
    specs = r_sharding.params_shardings(amesh, shapes, multi_pod=multi_pod)
    ref = {}
    for (path, leaf), ns in zip(jax.tree_util.tree_leaves_with_path(shapes),
                                jax.tree_util.tree_leaves(specs)):
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        ref[name] = list(ns.shard_shape(leaf.shape))
    for part in ("params", "m", "v"):
        assert {k: v[0] for k, v in got[part].items()} == ref, part
    ref_elems = sum(int(np.prod(s)) for s in ref.values())
    port = {part: sum(int(np.prod(s)) * torch.empty((), dtype=getattr(torch, dt[6:])).element_size()
                      for s, dt in got[part].values()) for part in ("params", "m", "v")}
    assert port == {"params": 4 * ref_elems, "m": 2 * ref_elems, "v": 2 * ref_elems}


def test_cli_cell_end_to_end(cases):
    runs = cases["cli"]["runs"]
    assert runs[0]["counts"] == {"ok": 1, "skipped": 0, "failed": 0}
    assert "dry-run done: 1 ok, 0 skipped, 0 failed" in runs[0]["out"]
    assert runs[1]["counts"] == {"ok": 0, "skipped": 0, "failed": 0}  # resumed
    assert runs[2]["counts"] == {"ok": 0, "skipped": 1, "failed": 0}
    assert "SKIP qwen2-1.5b long_500k" in runs[2]["out"]
    cell = cases["cli"]["cell"]
    assert cell["status"] == "ok" and cell["mesh"] == "2x16x16" and cell["n_chips"] == 512
    assert {"arch", "shape", "kind", "trace_s", "memory", "cost_flops", "cost_bytes", "census",
            "roofline", "hardware", "wall_s"} <= set(cell)
    assert set(cell["census"]) == {"step", "weights"}
    # the weights' cast moves nothing; the step's all-gathers carry the
    # weights: the bytes of the tree made ready whole, then of the step on
    # it (the tree gathers a stacked leaf in one call, the step a layer's)
    assert cell["census"]["weights"]["ops"] > 0
    assert cell["census"]["weights"]["collectives"] == {}
    split = cases["cli"]["split"]
    tree = split["gathered_tree"]["all-gather"]
    assert tree["moved"] > 0 and set(split["gathered_tree"]) == {"all-gather"}
    step = cell["census"]["step"]["collectives"]["all-gather"]
    rest = split["step_on_tree"]["all-gather"]
    for k in ("moved", "bytes"):
        assert step[k] == tree[k] + rest[k], k
    assert step["count"] > tree["count"] + rest["count"]
    assert cell["roofline"]["fits"] and cell["memory"]["peak"] < 80e9
    assert cell["hardware"]["power_limit_w"] == 700.0


def test_cli_refusals(cases, tmp_path):
    from repro_torch.launch import dryrun

    refused = cases["cli"]["refused"]
    assert "already in one" in refused["nested"]
    assert "needs 256 ranks, and the world has 4" in refused["mesh"]
    for argv in (["--mesh", "pod"], ["--arch", "gpt-5"], ["--shape", "train_8k"]):
        with pytest.raises(SystemExit) as e:
            dryrun.main(argv + ["--results-dir", str(tmp_path)])
        assert e.value.code == 2
    assert not os.listdir(tmp_path)
