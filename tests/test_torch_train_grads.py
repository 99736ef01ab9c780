"""One training step's loss and gradients for every arch of the registry,
reduced and in float32: autograd through ``repro_torch.models`` (with
remat, as training runs it) against ``jax.value_and_grad`` of the
reference's loss on the same weights and batch (its model without remat:
the same values, compiled sooner); the twin of
``tests/test_models.py::test_arch_smoke_train``. The loss within a
relative 1e-5; every gradient leaf within 1e-4 of its largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import configs, extras_for, flat, port_model, ref_params
from repro.configs.registry import ARCHS
from repro.models.transformer import Model as RefModel


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread, so the suite's other
    workers, and the rank processes that other test files run under
    ``nice``, keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_train_step_gradients_match_the_reference(name):
    ref_cfg, cfg = configs(name, "float32")
    params = ref_params(ref_cfg)
    ref, port = RefModel(ref_cfg, remat=False), port_model(cfg, params)
    assert port.remat
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    ex_ref, ex_port = extras_for(cfg, rng, 2)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), **(ex_ref or {})}
    pb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          **(ex_port or {})}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(params, rb)
    leaves = dict(port.named_parameters())
    got, got_metrics = port.loss(pb)
    got_grads = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()),
                                                     allow_unused=True,
                                                     materialize_grads=True)))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    assert sorted(metrics) == sorted(got_metrics)
    for k in metrics:
        np.testing.assert_allclose(got_metrics[k].item(), float(metrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    ref_grads = flat(grads)
    assert sorted(ref_grads) == sorted(got_grads)
    for k, g in ref_grads.items():
        g = np.asarray(g, np.float32)
        np.testing.assert_allclose(got_grads[k].numpy(), g, rtol=0,
                                   atol=1e-4 * float(np.abs(g).max()), err_msg=k)
