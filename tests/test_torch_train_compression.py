"""The port's gradient compression (``repro_torch.train.compression``)
against ``repro.train.compression`` on the CPU: int8 payloads and scales
bit for bit; an error bound that holds under float32 rounding; error
feedback's long-run mean (``tests/test_compression.py``'s twin); and
``compressed_psum`` on 4 gloo ranks (spawned once for the module, under
``nice``) against the mean of the reference's quantize/dequantize of each
rank's slice and against the true mean."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_compression_ranks as rank_side
from repro.train import compression as r_compression
from repro_torch.sim.ranks import run_ranks
from repro_torch.train.compression import (
    ErrorFeedback,
    compress_with_feedback,
    dequantize_int8,
    quantize_int8,
)

CASES = [(seed, scale) for seed in (0, 1, 7, 123, 9999) for scale in (1e-4, 0.37, 1.0, 1e3)]


@pytest.mark.parametrize("seed,scale", CASES)
def test_quantize_is_the_references_bit_for_bit(seed, scale):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(8, 64)) * scale).astype(np.float32)
    x[0, :3] = 0.0  # exact zeros, and a row of them (the scale's floor)
    x[1] = 0.0
    ref = r_compression.quantize_int8(jnp.asarray(x))
    got = quantize_int8(torch.from_numpy(x))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(dequantize_int8(got).numpy(),
                                  np.asarray(r_compression.dequantize_int8(ref)))
    assert dequantize_int8(got, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("seed,scale", CASES)
def test_quantize_error_bound_under_float32_rounding(seed, scale):
    """|dequantized - x| <= scale/2 + the float32 rounding of x/scale and of
    q*scale: scale * (1/2 + 2 * 127 * 2^-24). (The reference's own test
    allows 1e-9, which float32 rounding can exceed at large scales.)"""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(8, 64)) * scale).astype(np.float32))
    qs = quantize_int8(x)
    err = (dequantize_int8(qs).double() - x.double()).abs()
    bound = qs.scale.double() * (0.5 + 2 * 127 * 2.0**-24)
    assert bool((err <= bound).all()), float((err - bound).max())
    assert int(qs.q.abs().max()) == 127  # each row's largest entry maps to +-127


def test_error_feedback_is_unbiased_over_time():
    """With constant gradients, EF-compressed updates average to the truth."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32))}
    ef = ErrorFeedback.init(g)
    total = torch.zeros_like(g["w"])
    steps = 50
    for _ in range(steps):
        qs, deq, ef = compress_with_feedback(g, ef)
        total = total + deq["w"]
    assert qs["w"].q.dtype == torch.int8
    mean = total.numpy() / steps
    np.testing.assert_allclose(mean, g["w"].numpy(), atol=2e-3, rtol=1e-2)


def test_error_feedback_matches_the_reference():
    rng = np.random.default_rng(3)
    grads = {"a": rng.normal(size=(4, 32)).astype(np.float32),
             "b": rng.normal(size=(6, 16)).astype(np.float32)}
    ref_ef = r_compression.ErrorFeedback.init({k: jnp.asarray(v) for k, v in grads.items()})
    ef = ErrorFeedback.init({k: torch.from_numpy(v) for k, v in grads.items()})
    for _ in range(5):
        _, rdeq, ref_ef = r_compression.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in grads.items()}, ref_ef)
        _, deq, ef = compress_with_feedback({k: torch.from_numpy(v) for k, v in grads.items()},
                                            ef)
        for k in grads:
            np.testing.assert_array_equal(deq[k].numpy(), np.asarray(rdeq[k]))
            np.testing.assert_array_equal(ef.residual[k].numpy(),
                                          np.asarray(ref_ef.residual[k]))


@pytest.fixture(scope="module")
def psum(tmp_path_factory):
    x = np.random.default_rng(0).normal(size=(4, 16, 32)).astype(np.float32)
    out = run_ranks(rank_side.main, 4, str(tmp_path_factory.mktemp("rendezvous")),
                    args=(x,), threads=1, timeout=120, init_timeout=60)
    return x, out


def test_compressed_psum_matches_the_references_quantization(psum):
    x, out = psum
    want = np.mean([np.asarray(r_compression.dequantize_int8(
        r_compression.quantize_int8(jnp.asarray(s)))) for s in x], axis=0)
    for r, got in enumerate(out):
        assert got["world"] == 4 and got["dtype"] == "torch.float32"
        np.testing.assert_allclose(got["out"], want, rtol=0, atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["out"], out[0]["out"])  # every rank the same


def test_compressed_psum_matches_mean(psum):
    x, out = psum
    for got in out:
        np.testing.assert_allclose(got["out"], x.mean(axis=0), atol=2e-2, rtol=2e-2)
