"""Serving with the FSDP shards at rest (``Model.cast_params`` on a mesh):
each rank keeps its cast local shards, and prefill and decode make each
layer's weights ready at its use, as the reference's jitted serve step casts
inside the step and lets XLA gather a layer at a time.

Ranks are spawned twice for the module (``repro_torch.sim.ranks.run_ranks``,
one thread each, under ``nice``; the rank side is
``tests/_torch_lm_at_rest_ranks.py``): 4 ranks as data 2 x model 2 for
every arch of the registry, reduced, then 2 as data 1 x model 2 for qwen2;
each in float32 and bf16, on weights drawn from a seed.

* **Bit for bit.** The at-rest path and the gathered tree
  (``parallel.full(model.cast_params())``, made ready once) give the same
  prefill logits, cache, three teacher-forced decode steps' logits, final
  cache and greedy tokens, exactly: a gather copies, the cast is
  elementwise (cast then gather is gather then cast), and the layers run
  the same arithmetic on the same values.
* **Only the rank's shards.** The at-rest cast moves no collective byte,
  and on every rank each leaf of its tree is the parameter's local shard:
  its bytes are the whole leaf's (at the cast dtype) over the sizes of the
  mesh axes its placements shard it on, leaf by leaf and in sum; the
  gathered tree holds more in sum on a mesh with a data axis (a leaf the
  model axis replicates and the rank slices is less gathered than at
  rest).

The at-rest path's logits against the reference's are held by
``tests/test_torch_lm_sharding_ranks.py`` and ``tests/test_torch_lm_tp.py``
(their forwards cast and gather inside each call, as at rest)."""

import threading

import numpy as np
import pytest

import _torch_lm_at_rest_ranks as rank_side
from repro_torch.configs.registry import ARCHS as PORT_ARCHS
from repro_torch.sim.ranks import run_ranks

ARCHS = tuple(sorted(PORT_ARCHS))
DTYPES = ("float32", "bfloat16")
DENSE = "qwen2-1.5b"
# the spawns' jobs, in order: (mesh shape, arch, dtype)
JOBS = {4: [((2, 2), n, d) for n in ARCHS for d in DTYPES],
        2: [((1, 2), DENSE, d) for d in DTYPES]}
CASES = [(s, n, d) for world in (4, 2) for s, n, d in JOBS[world]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two spawns' results (4 ranks, then 2), run in a thread."""
    tmp = tmp_path_factory.mktemp("lm_at_rest")
    out, done = {}, {4: threading.Event(), 2: threading.Event()}

    def go():
        try:
            for world in (4, 2):
                jobs = [(s, dict(name=n, dtype=d)) for s, n, d in JOBS[world]]
                out[world] = run_ranks(rank_side.main, world, str(tmp / "rdv"), args=(jobs,),
                                       timeout=400, threads=1)
                done[world].set()
        except Exception as e:  # raised again in the tests
            out["error"] = e
        finally:
            for ev in done.values():
                ev.set()

    t = threading.Thread(target=go, daemon=True)
    t.start()
    yield {"done": done, "out": out}
    t.join(timeout=900)


def _results(runs, shape, name, dtype):
    """Every rank's result of the job (rank 0's whole, the others' byte
    counts)."""
    world = shape[0] * shape[1]
    assert runs["done"][world].wait(timeout=900), "the rank runs overran"
    if "error" in runs["out"]:
        raise runs["out"]["error"]
    i = JOBS[world].index((shape, name, dtype))
    return [r[i] for r in runs["out"][world]]


def _id(case):
    shape, name, dtype = case
    return f"{shape[0]}x{shape[1]}-{name}-{dtype}"


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_at_rest_serving_is_the_gathered_trees_bit_for_bit(runs, case):
    got = _results(runs, *case)[0]
    rest, whole = got["rest"], got["gathered"]
    assert sorted(rest) == sorted(whole)
    steps = ["prefill"] + [f"decode{i}" for i in range(rank_side.DECODE)]
    assert set(steps) <= set(rest)
    for k in steps + ["greedy"]:
        assert rest[k].shape == whole[k].shape, k
        np.testing.assert_array_equal(rest[k], whole[k], err_msg=k)
    assert np.isfinite(rest["prefill"]).all()
    for tag in ("prefill_cache", "decode_cache"):
        assert sorted(rest[tag]) == sorted(whole[tag]) and rest[tag]
        for k, v in rest[tag].items():
            np.testing.assert_array_equal(v, whole[tag][k], err_msg=f"{tag}.{k}")
    assert rest["decode_cache"]["len"] == rank_side.PROMPT + rank_side.DECODE


SHARD_CASES = [c for c in CASES if c[2] == "bfloat16"]


@pytest.mark.parametrize("case", SHARD_CASES, ids=[_id(c) for c in SHARD_CASES])
def test_at_rest_tree_holds_only_the_ranks_shards(runs, case):
    shape, _, _ = case
    ranks = _results(runs, *case)
    assert len(ranks) == shape[0] * shape[1]
    for r, got in enumerate(ranks):
        assert all(v == [0, 0] for v in got["cast_moved"].values()), (r, got["cast_moved"])
        leaves = got["leaves"]
        assert leaves
        for k, v in leaves.items():
            assert v["local"], (r, k)
            assert v["bytes"] == v["placed"], (r, k, v)
            assert v["gathered"] <= v["whole"], (r, k, v)
        rest = sum(v["bytes"] for v in leaves.values())
        assert rest == sum(v["placed"] for v in leaves.values())
        # in sum the gathered tree holds more: it is whole over the data axes
        if shape[0] > 1:
            assert sum(v["gathered"] for v in leaves.values()) > rest
        assert rest < sum(v["whole"] for v in leaves.values())
