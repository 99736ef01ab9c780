"""The port's sharding rules (``repro_torch.models.sharding``) and mesh
builders (``repro_torch.launch.mesh``) against the reference's, on the CPU
without ranks: every leaf of every arch in the registry, full and reduced,
gets the reference's ``PartitionSpec`` on the same ``AbstractMesh`` (the
reference's rules read only the axis sizes), on the five meshes the
reference names ((2, 4), (4, 2), (1, 8), its 16x16 production mesh and the
2x16x16 multi-pod one); batches and caches too; the DTensor placements of
each spec; and the meshes' refusals. The numerics on a mesh are in
``tests/test_torch_lm_sharding_ranks.py``."""

import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import get_arch as ref_get_arch
from repro.models import sharding as r_sharding
from repro.models.transformer import Model as RefModel
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch import mesh as p_mesh
from repro_torch.models import sharding
from repro_torch.models.transformer import Model, body_structure, flatten_tree

MESHES = {"2x4": ((2, 4), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _ref_shapes(cfg):
    return jax.eval_shape(lambda: RefModel(cfg).init(jax.random.PRNGKey(0)))


def _ref_specs(cfg, mesh, multi_pod):
    shapes = _ref_shapes(cfg)
    tree = r_sharding.params_shardings(mesh, shapes, multi_pod=multi_pod)
    out = {}
    for path, ns in jax.tree_util.tree_leaves_with_path(tree):
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[name] = ns.spec
    return out, {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf.shape
                 for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}


def _port_shapes(cfg):
    """The port's parameter names and shapes, on the meta device (a
    full-width model's weights are never allocated)."""
    prefix, unit, reps = body_structure(cfg)
    stub = types.SimpleNamespace(cfg=cfg, prefix_kinds=prefix, unit_kinds=unit, reps=reps)
    tree = Model._param_tree(stub, None, torch.device("meta"))
    return {k: tuple(v.shape) for k, v in flatten_tree(tree).items()}


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_specs_are_the_references(mesh_name, arch):
    shape, names = MESHES[mesh_name]
    mesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    multi_pod = "pod" in names
    for reduced in (False, True):
        ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
        if reduced:
            ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
        ref, ref_shapes = _ref_specs(ref_cfg, mesh, multi_pod)
        port_shapes = _port_shapes(cfg)
        assert port_shapes == {k: tuple(v) for k, v in ref_shapes.items()}
        got = sharding.params_specs(sizes, port_shapes, multi_pod=multi_pod)
        for name, spec in ref.items():
            ndim = len(ref_shapes[name])
            assert got[name] == _padded(spec, ndim), (reduced, name, got[name], spec)
            pl = sharding.placements(got[name], names)
            for axis, p in zip(names, pl):
                dims = [d for d, a in enumerate(got[name])
                        if a == axis or (isinstance(a, tuple) and axis in a)]
                assert (p == Shard(dims[0])) if dims else (p == Replicate())
        sharded = sharding.params_shardings(sizes, port_shapes, multi_pod=multi_pod)
        assert sorted(sharded) == sorted(port_shapes)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-lite-16b", "whisper-base",
                                  "mamba2-1.3b"])
def test_batch_and_cache_specs_are_the_references(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    mesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    multi_pod = "pod" in names
    cfg = ref_get_arch(arch).reduced()
    for batch in (1, 2, 32, 512):
        cache = jax.eval_shape(lambda: RefModel(cfg).init_cache(batch, 64))
        ref = r_sharding.cache_shardings(mesh, cache, multi_pod=multi_pod)
        leaves = dict(zip(
            (".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(cache)),
            zip(jax.tree_util.tree_leaves(cache), jax.tree_util.tree_leaves(ref))))
        got = sharding.cache_specs(sizes, {k: v.shape for k, (v, _) in leaves.items()},
                                   multi_pod=multi_pod)
        for k, (leaf, ns) in leaves.items():
            assert got[k] == _padded(ns.spec, len(leaf.shape)), (batch, k, got[k], ns.spec)
        placed = sharding.cache_shardings(sizes, {k: v.shape for k, (v, _) in leaves.items()},
                                          multi_pod=multi_pod)
        assert placed == {k: sharding.placements(v, names) for k, v in got.items()}
        b = {"tokens": jax.ShapeDtypeStruct((batch, 64), np.int32),
             "labels": jax.ShapeDtypeStruct((batch, 64), np.int32),
             "frames": jax.ShapeDtypeStruct((batch, 32, cfg.d_model), np.float32)}
        rb = r_sharding.batch_shardings(mesh, b, multi_pod=multi_pod)
        gb = sharding.batch_specs(sizes, {k: v.shape for k, v in b.items()}, multi_pod=multi_pod)
        for k in b:
            assert gb[k] == _padded(rb[k].spec, len(b[k].shape)), (batch, k)
        placed = sharding.batch_shardings(sizes, {k: v.shape for k, v in b.items()},
                                          multi_pod=multi_pod)
        assert placed == {k: sharding.placements(v, names) for k, v in gb.items()}


def test_registries_match():
    assert sorted(ARCHS) == sorted(REF_ARCHS)


def test_placements_order_and_refusals():
    names = ("pod", "data", "model")
    assert sharding.placements((("pod", "data"), "model"), names) == (Shard(0), Shard(0), Shard(1))
    assert sharding.placements((None, None), names) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        sharding.placements((("data", "pod"), None), names)
    with pytest.raises(ValueError, match="one axis"):
        sharding.placements(("model", "model"), names)


def test_sanitize_drops_trailing_axes_as_the_reference():
    sizes = {"pod": 2, "data": 16, "model": 16}
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    for shape in [(64, 12), (4, 48), (2, 16), (3, 5), (32, 32)]:
        for spec in [(("pod", "data"), "model"), ("model", ("pod", "data")), (None, "data")]:
            ref = r_sharding.sanitize(mesh, jax.sharding.PartitionSpec(*spec), shape)
            assert sharding.full_spec(sharding.sanitize(sizes, spec, shape), len(shape)) == \
                _padded(ref, len(shape)), (shape, spec)


def test_meshes_need_a_group_of_their_size():
    assert not torch.distributed.is_initialized()
    with pytest.raises(p_mesh.MeshSizeError, match="needs a process group of 4 ranks"):
        p_mesh.make_host_mesh(data=2, model=2, device="cpu")
    with pytest.raises(p_mesh.MeshSizeError, match="256 ranks"):
        p_mesh.make_production_mesh(device="cpu")
    with pytest.raises(p_mesh.MeshSizeError, match="512 ranks"):
        p_mesh.make_production_mesh(multi_pod=True, device="cpu")
