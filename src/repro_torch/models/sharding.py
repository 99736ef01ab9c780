"""Parameter / batch / cache sharding rules for the mesh; the port of
``repro.models.sharding``.

Policy (the reference's):
* TP over 'model' (attention heads when divisible, SwiGLU d_ff, padded vocab);
* EP over 'model' for MoE expert dim;
* DP over ('pod','data') for the batch;
* FSDP over 'data' (+'pod' multi-pod) on the d_model axis of big matrices;
* every proposed spec is *sanitized* against actual divisibility, so configs
  whose head counts don't divide the mesh (qwen2: 12H, starcoder2: 24H,
  whisper: 8H) degrade per-tensor to replication instead of failing.

A spec is the reference's ``PartitionSpec`` as a tuple with one entry per
dimension: ``None`` (not sharded), an axis name, or a tuple of axis names
(that dimension split over several axes, the first the most major). The
rules read only the mesh's axis sizes (``{"data": 2, "model": 4}``, or a
``DeviceMesh``), so they run without a process group, as the reference's
run on an ``AbstractMesh``. :func:`placements` turns a spec into the
DTensor placements of a mesh (one ``Shard(d)`` or ``Replicate()`` per mesh
axis); ``params_shardings``/``batch_shardings``/``cache_shardings`` map a
name -> tensor dict to them.

Parameter names are the port's: the reference's tree paths joined by
``.`` (``body.l0.ffn.wi``, ``prefix.0.mixer.wo``); a leaf under ``body`` or
``encoder`` is stacked over the reps (a leading dim the rules leave
unsharded).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import Replicate, Shard

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]
Sizes = Mapping[str, int]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axsize(sizes: Sizes, axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


def sanitize(mesh, spec: Sequence[Axes], shape: Sequence[int]) -> Spec:
    sizes = axis_sizes(mesh)
    out = []
    for d, axes in enumerate(spec):
        if axes is None or d >= len(shape):
            out.append(None)
            continue
        if shape[d] % _axsize(sizes, axes) == 0:
            out.append(axes)
        else:
            # try dropping trailing axes of a tuple before giving up
            if isinstance(axes, (tuple, list)):
                kept = list(axes)
                while kept and shape[d] % _axsize(sizes, tuple(kept)) != 0:
                    kept.pop()
                out.append(tuple(kept) if kept else None)
            else:
                out.append(None)
    return tuple(out)


def full_spec(spec: Sequence[Axes], ndim: int) -> Spec:
    """``spec`` as ``PartitionSpec`` writes it, with ``None`` for each
    dimension it leaves out (a spec shorter than the array replicates the
    rest) and a tuple of one axis written as that axis."""
    canon = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in spec)
    return canon + (None,) * (ndim - len(spec))


def _parts(name: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    return tuple(name.split(".")) if isinstance(name, str) else tuple(name)


def param_spec(name, shape, mesh, fsdp, model: str = "model") -> Spec:
    """Rule table keyed on leaf name + ndim (``name``: the parameter's name,
    or its path's parts). Leaves under a stacked 'body' / 'encoder' carry a
    leading [reps] dim: the rule applies to the trailing dims and the reps
    dim stays unsharded. Returns one entry per dimension of ``shape``."""
    sizes = axis_sizes(mesh)
    names = _parts(name)
    leaf = names[-1]
    stacked = any(n in ("body", "encoder") for n in names)
    nd = len(shape) - (1 if stacked else 0)

    def mk(*axes):
        if stacked:
            axes = (None,) + axes
        return full_spec(sanitize(sizes, axes, shape), len(shape))

    def rep():
        return (None,) * len(shape)

    if leaf == "embed":
        return mk(model, fsdp)
    if leaf == "lm_head":
        return mk(fsdp, model)
    if leaf in ("wq", "wk", "wv", "wqkv"):  # [D, H(+2Hkv), hd]
        return mk(fsdp, model, None)
    if leaf == "wkv":  # [D, 2*Hkv, hd]: shard only if each k|v HALF shards
        tp = _axsize(sizes, model)
        if (shape[1 if not stacked else 2] // 2) % tp == 0:
            return mk(fsdp, model, None)
        return mk(fsdp, None, None)
    if leaf == "wo" and nd == 3:  # attn out [H, hd, D]
        return mk(model, None, fsdp)
    if leaf in ("wi", "wg") and nd == 3:  # moe experts [E, D, F]
        return mk(model, fsdp, None)
    if leaf == "wo" and nd == 2 and "ffn" in names and any(n in ("wi", "wg") for n in names):
        return mk(model, fsdp)
    if leaf in ("wi", "wg") and nd == 2:  # mlp [D, F]
        return mk(fsdp, model)
    if leaf == "wo" and nd == 2:  # mlp out [F, D]
        return mk(model, fsdp)
    if leaf in ("wuq", "wuk", "wuv"):  # mla up [r|D, H, k]
        return mk(None, model, None)
    if leaf in ("wdq", "wdkv", "wkr"):  # mla down [D, r]
        return mk(fsdp, None)
    if leaf in ("wz", "wx"):  # mamba in [D, d_in]
        return mk(fsdp, model)
    if leaf == "w_out":  # mamba out [d_in, D]
        return mk(model, fsdp)
    if leaf in ("wB", "wC", "wdt"):
        return mk(fsdp, None)
    if leaf.startswith("conv_"):
        return mk(None, model) if nd == 2 else rep()
    if leaf == "proj":  # mtp [2D, D]
        return mk(fsdp, None)
    return rep()  # router, norms, biases, scalars: replicated


def placements(spec: Sequence[Axes], axis_names: Sequence[str]) -> Tuple:
    """The DTensor placements of ``spec`` on a mesh with ``axis_names``: for
    each mesh axis, ``Shard(d)`` for the dimension it splits, else
    ``Replicate()``. A dimension split over several axes takes a ``Shard``
    on each, the most major first, which must be the mesh's order."""
    out = []
    for a in axis_names:
        dims = [d for d, axes in enumerate(spec)
                if axes == a or (isinstance(axes, tuple) and a in axes)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} shards dims {dims} over one axis {a!r}")
        out.append(Shard(dims[0]) if dims else Replicate())
    for axes in spec:
        if isinstance(axes, tuple) and len(axes) > 1:
            order = [axis_names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"spec {spec}: {axes} is not in the mesh's axis order "
                                 f"{tuple(axis_names)}")
    return tuple(out)


def data_axes_for(axis_names: Sequence[str]) -> Tuple[str, ...]:
    """The batch axes of a mesh with these axis names, over which FSDP
    shards too: ``("pod", "data")`` with a pod axis, else ``("data",)``."""
    return ("pod", "data") if "pod" in axis_names else ("data",)


def _fsdp(multi_pod: bool) -> Tuple[str, ...]:
    return data_axes_for(("pod",) if multi_pod else ())


def params_specs(mesh, named: Mapping[str, Any], multi_pod: bool = False) -> Dict[str, Spec]:
    """``{name: spec}`` of a name -> tensor (or shape) mapping."""
    sizes, fsdp = axis_sizes(mesh), _fsdp(multi_pod)
    return {k: param_spec(k, _shape(v), sizes, fsdp) for k, v in named.items()}


def params_shardings(mesh, named: Mapping[str, Any], multi_pod: bool = False) -> Dict[str, Tuple]:
    """``{name: DTensor placements}`` of the parameters on ``mesh``."""
    return _placed(mesh, params_specs(mesh, named, multi_pod))


def batch_specs(mesh, named: Mapping[str, Any], multi_pod: bool = False) -> Dict[str, Spec]:
    """tokens/labels [B, S]; frames/patches [B, S, D]: the batch over DP."""
    sizes, dp = axis_sizes(mesh), _fsdp(multi_pod)
    out = {}
    for k, v in named.items():
        shape = _shape(v)
        out[k] = full_spec(sanitize(sizes, (dp,) + (None,) * (len(shape) - 1), shape),
                           len(shape))
    return out


def batch_shardings(mesh, named: Mapping[str, Any], multi_pod: bool = False) -> Dict[str, Tuple]:
    return _placed(mesh, batch_specs(mesh, named, multi_pod))


def cache_specs(mesh, named: Mapping[str, Any], multi_pod: bool = False) -> Dict[str, Spec]:
    """KV/SSM caches: batch over DP axes when divisible; otherwise shard the
    sequence axis over ('data','model') (long-context, batch=1)."""
    sizes, dp = axis_sizes(mesh), _fsdp(multi_pod)
    out = {}
    for k, v in named.items():
        shape = _shape(v)
        if len(shape) == 0:
            out[k] = ()
            continue
        b = shape[0]
        if b % _axsize(sizes, dp) == 0 and b > 1:
            spec = (dp,) + (None,) * (len(shape) - 1)
        elif len(shape) >= 3:
            spec = (None, ("data", "model")) + (None,) * (len(shape) - 2)
        else:
            spec = (None,) * len(shape)
        out[k] = full_spec(sanitize(sizes, spec, shape), len(shape))
    return out


def cache_shardings(mesh, named: Mapping[str, Any], multi_pod: bool = False) -> Dict[str, Tuple]:
    return _placed(mesh, cache_specs(mesh, named, multi_pod))


def _shape(v) -> Tuple[int, ...]:
    return tuple(v.shape) if hasattr(v, "shape") else tuple(v)


def _placed(mesh, specs: Mapping[str, Spec]) -> Dict[str, Tuple]:
    names: Optional[Sequence[str]] = (list(mesh) if isinstance(mesh, Mapping)
                                      else list(mesh.mesh_dim_names))
    return {k: placements(s, names) for k, s in specs.items()}
