"""The port's LM models against the reference's on the CPU: the configs and
structure of every registered arch, the weights carried across by
``repro_torch.convert.lm_params_from_reference``, and every arch of
``ARCHS`` at reduced size in float32 (forward logits, loss, prefill logits
and cache, three decode steps). The configuration's bf16 is held in
``tests/test_torch_lm_bf16.py``."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from _torch_lm import configs, port_model, ref_params, run_both
from repro.configs import base as r_base
from repro.configs import registry as r_registry
from repro.launch import steps as r_steps
from repro.models.transformer import Model as RefModel
from repro.models.transformer import body_structure as r_body_structure
from repro_torch.configs import base, registry
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import steps
from repro_torch.models import sharding
from repro_torch.models.transformer import Model, body_structure

NAMES = sorted(r_registry.ARCHS)


def test_registry_is_the_references():
    assert sorted(registry.ARCHS) == NAMES
    for name in NAMES:
        ref, got = r_registry.get_arch(name), registry.get_arch(name)
        assert dataclasses.asdict(ref) == dataclasses.asdict(got)
        assert dataclasses.asdict(ref.reduced()) == dataclasses.asdict(got.reduced())
        assert (ref.padded_vocab, ref.is_moe) == (got.padded_vocab, got.is_moe)
        if ref.n_heads:
            assert ref.hd == got.hd
    with pytest.raises(KeyError) as ref_err:
        r_registry.get_arch("gpt-5")
    with pytest.raises(KeyError) as got_err:
        registry.get_arch("gpt-5")
    assert str(ref_err.value) == str(got_err.value)


@pytest.mark.parametrize("name", NAMES)
def test_layer_kinds_and_body_structure_full_configs(name):
    ref, got = r_registry.get_arch(name), registry.get_arch(name)
    assert ref.layer_kinds() == got.layer_kinds()
    assert r_body_structure(ref) == body_structure(got)
    assert r_body_structure(ref.reduced()) == body_structure(got.reduced())


def test_llama_vision_cross_layer_sits_at_i_mod_5_eq_3():
    kinds = registry.get_arch("llama-3.2-vision-11b").layer_kinds()
    assert [i for i, k in enumerate(kinds) if "+cross" in k] == list(range(3, 40, 5))


@pytest.mark.parametrize("shape", sorted(r_base.SHAPES))
def test_input_specs_and_shape_applicable(shape):
    assert dataclasses.asdict(r_base.SHAPES[shape]) == dataclasses.asdict(base.SHAPES[shape])
    for name in NAMES:
        ref_cfg, cfg = r_registry.get_arch(name), registry.get_arch(name)
        assert r_base.shape_applicable(ref_cfg, r_base.SHAPES[shape]) == \
            base.shape_applicable(cfg, base.SHAPES[shape])
        ref = r_base.input_specs(ref_cfg, r_base.SHAPES[shape])
        got = base.input_specs(cfg, base.SHAPES[shape])
        assert sorted(ref) == sorted(got)
        for k in ref:
            assert got[k].device.type == "meta"
            assert tuple(ref[k].shape) == tuple(got[k].shape)
            assert str(ref[k].dtype) == str(got[k].dtype).removeprefix("torch.")


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8, 16])
def test_pad_heads_for_tp_and_data_axes(tp):
    for name in NAMES:
        ref = r_steps.pad_heads_for_tp(r_registry.get_arch(name), tp)
        got = steps.pad_heads_for_tp(registry.get_arch(name), tp)
        assert dataclasses.asdict(ref) == dataclasses.asdict(got)
    for names in [("data", "model"), ("pod", "data", "model")]:
        mesh = jax.sharding.AbstractMesh((1,) * len(names), names)
        fake = types.SimpleNamespace(mesh_dim_names=names)  # a DeviceMesh's axis names
        assert r_steps.data_axes_for(mesh) == steps.data_axes_for(fake) == \
            sharding.data_axes_for(names)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_names_are_the_reference_tree_paths(name):
    ref_cfg, cfg = configs(name)
    shapes = jax.eval_shape(RefModel(ref_cfg).init, jax.random.PRNGKey(0))
    ref = {jax.tree_util.keystr(path, simple=True, separator="."): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {k: tuple(v.shape) for k, v in Model(cfg, device="cpu").state_dict().items()}
    assert ref == got


def test_convert_refuses_missing_extra_and_misshapen_leaves():
    ref_cfg, cfg = configs("qwen2-1.5b")
    params = ref_params(ref_cfg)
    model = Model(cfg, device="cpu")
    body = dict(params["body"])
    missing = dict(params, body={**body, "l0": {k: v for k, v in body["l0"].items()
                                                if k != "norm2"}})
    with pytest.raises(ValueError, match="missing.*body.l0.norm2.w"):
        lm_params_from_reference(model, missing)
    with pytest.raises(ValueError, match=r"extra \['lm_head'\]"):
        lm_params_from_reference(model, dict(params, lm_head=params["embed"].T))
    with pytest.raises(ValueError, match="embed: shape"):
        lm_params_from_reference(model, dict(params, embed=params["embed"][:-1]))
    got = lm_params_from_reference(model, params)
    np.testing.assert_array_equal(got.body.l0.mixer.wqkv.detach().numpy(),
                                  params["body"]["l0"]["mixer"]["wqkv"])


def test_model_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = configs("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steps.build_model(cfg)


def test_init_draws_from_the_generator():
    _, cfg = configs("jamba-1.5-large-398b")
    a = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = Model(cfg, device="cpu")
    b.init(torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    std = a.body.l0.mixer.wz.std().item()  # dense_init: std 1/sqrt(fan_in)
    assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(cfg.d_model)
    torch.testing.assert_close(a.body.l0.mixer.A_log[0],
                               torch.log(torch.linspace(1.0, 16.0, a.body.l0.mixer.A_log.shape[1])))


def _assert_float32_match(out):
    """Float32: within 1e-4 of the largest logit (the two packages sum in
    other orders through a few layers); caches within 1e-4 of their largest
    entry; the loss and its metrics within a relative 1e-5."""
    scale = float(np.abs(out["logits"][0]).max())
    for what, (ref, got) in out.items():
        if what.endswith(".len"):
            assert ref == got, what
        elif what.startswith("loss."):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7, err_msg=what)
        elif "cache" in what:
            tol = 1e-4 * max(float(np.abs(ref).max()), 1e-30)
            np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale, err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_arch_float32_matches_the_reference(name):
    _assert_float32_match(run_both(name, "float32"))


def test_qwen2_real_widths_one_layer():
    """qwen2-1.5b's real widths (d 1536, GQA 12:2 at hd 128, qkv bias, d_ff
    8960, tied head) with one layer and a 503-row vocabulary."""
    _assert_float32_match(run_both("qwen2-1.5b", "float32", reduced=False, n_layers=1,
                                   vocab_size=503, batch=1, seq=12, prompt=9, steps=3))


def test_bf16_serving_cast_once_is_the_forwards_cast():
    """``cast_params`` (computed once for serving) gives the bits each
    forward casts to: logits equal to the last bit."""
    _, cfg = configs("deepseek-v3-671b")
    model = port_model(cfg, ref_params(configs("deepseek-v3-671b")[0]))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)))
    with torch.no_grad():
        a = model.forward(toks)[0]
        b = model.forward(toks, params=model.cast_params())[0]
    assert a.dtype == torch.bfloat16
    torch.testing.assert_close(a, b, rtol=0, atol=0)
