"""The port's LM layers (``repro_torch.models``) against the reference's
(``repro.models``) on the CPU, unit by unit: the same inputs, drawn with
numpy from a seed, and the same weights through both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import configs, np32, to_torch
from repro.models import attention as r_att
from repro.models import layers as r_lay
from repro.models import moe as r_moe
from repro.models import ssm as r_ssm
from repro_torch.models import attention as p_att
from repro_torch.models import layers as p_lay
from repro_torch.models import moe as p_moe
from repro_torch.models import ssm as p_ssm

# float32 arithmetic on O(1) values: the two packages sum in other orders
# and their exp/sin/tanh may differ in the last bit
ATOL = 1e-5
KEY = jax.random.PRNGKey(0)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np32(a), np32(b), atol=atol, rtol=0)


def _ulp_close(a, b):
    """Within one bf16 ulp of the largest value (2^-7 of it): fp32
    statistics summed in another order can flip one rounding."""
    ref = np32(a)
    _close(ref, b, atol=2.0**-7 * float(np.abs(ref).max()))


def _randomize(tree, rng, names):
    """The reference initialises biases to zero; draw them so they count."""
    return {k: (jnp.asarray(rng.normal(size=v.shape), v.dtype) if k in names else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("fn", ["sigmoid", "silu", "gelu_tanh"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_activations_match_jax_nn(fn, dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(4096,)) * 4, getattr(jnp, dtype))
    ref = {"sigmoid": jax.nn.sigmoid, "silu": jax.nn.silu, "gelu_tanh": jax.nn.gelu}[fn](x)
    got = getattr(p_lay, fn)(to_torch(x))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":  # op by op as jax.nn: the reference's bits
        np.testing.assert_array_equal(np32(ref), np32(got))
    else:
        _close(ref, got, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 5, 64)) * 3, getattr(jnp, dtype))
    w = jnp.asarray(rng.normal(size=(64,)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(64,)), jnp.float32)
    for ref, got in [(r_lay.rms_norm(x, w), p_lay.rms_norm(to_torch(x), to_torch(w))),
                     (r_lay.layer_norm(x, w, b),
                      p_lay.layer_norm(to_torch(x), to_torch(w), to_torch(b)))]:
        assert got.dtype == getattr(torch, dtype)
        (_close if dtype == "float32" else _ulp_close)(ref, got)


@pytest.mark.parametrize("frac", [1.0, 0.25])
@pytest.mark.parametrize("offset", [0, 9])
def test_rope_interleaved_and_partial(frac, offset):
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 7, 3, 16)), jnp.float32)
    pos = offset + jnp.arange(7)[None, :]
    inv, rot = r_lay.rope_freqs(16, 1e6, frac)
    pinv, prot = p_lay.rope_freqs(16, 1e6, frac)
    assert prot == rot == int(16 * frac) // 2 * 2
    _close(inv, pinv, atol=0)
    _close(r_lay.apply_rope(x, pos, inv, rot),
           p_lay.apply_rope(to_torch(x), to_torch(pos), pinv, prot))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("bias", [False, True])
def test_mlp(act, bias):
    rng = np.random.default_rng(3)
    p = _randomize(r_lay.mlp_params(KEY, 32, 48, act, bias), rng, ("bi", "bo"))
    assert sorted(p) == sorted(p_lay.mlp_params(None, 32, 48, act, bias))
    x = jnp.asarray(rng.normal(size=(2, 5, 32)), jnp.float32)
    _close(r_lay.mlp_apply(p, x, act), p_lay.mlp_apply(to_torch(p), to_torch(x), act))
    # a bf16 activation meets fp32 1-D biases (an unstacked layer): both promote
    xb = x.astype(jnp.bfloat16)
    pb = {k: (v.astype(jnp.bfloat16) if v.ndim >= 2 else v) for k, v in p.items()}
    ref, got = r_lay.mlp_apply(pb, xb, act), p_lay.mlp_apply(to_torch(pb), to_torch(xb), act)
    assert str(ref.dtype) == str(got.dtype).removeprefix("torch.")
    _ulp_close(ref, got)


@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_with_z_loss(z_loss, masked):
    rng = np.random.default_rng(4)
    logits = jnp.asarray(rng.normal(size=(2, 5, 11)) * 3, jnp.float32)
    labels = jnp.asarray(rng.integers(0, 11, (2, 5)), jnp.int32)
    mask = jnp.asarray(rng.integers(0, 2, (2, 5)), jnp.float32) if masked else None
    ref = r_lay.softmax_cross_entropy(logits, labels, mask, z_loss)
    got = p_lay.softmax_cross_entropy(to_torch(logits), to_torch(labels),
                                      None if mask is None else to_torch(mask), z_loss)
    _close(ref, got)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 5])
def test_chunked_attention_ragged_blocks(causal, q_offset):
    """S=37 over blocks of 16 (padded, masked) against the reference."""
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.normal(size=(2, 37, 4, 16)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(2, 37, 4, 16)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(2, 37, 4, 12)), jnp.float32)
    for qb, kb in [(16, 16), (16, 8), (1024, 1024)]:
        ref = r_att.chunked_attention(q, k, v, causal, qb, kb, q_offset)
        got = p_att.chunked_attention(to_torch(q), to_torch(k), to_torch(v), causal, qb, kb,
                                      q_offset)
        _close(ref, got)
    # bf16 inputs: fp32 scores and accumulators, the output in q's dtype
    qb16, kb16, vb16 = (a.astype(jnp.bfloat16) for a in (q, k, v))
    ref = r_att.chunked_attention(qb16, kb16, vb16, causal, 16, 16, q_offset)
    got = p_att.chunked_attention(to_torch(qb16), to_torch(kb16), to_torch(vb16), causal, 16,
                                  16, q_offset)
    assert got.dtype == torch.bfloat16
    _ulp_close(ref, got)


def test_chunked_attention_cross_lengths():
    rng = np.random.default_rng(6)
    q = jnp.asarray(rng.normal(size=(2, 5, 4, 16)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(2, 37, 4, 16)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(2, 37, 4, 16)), jnp.float32)
    _close(r_att.chunked_attention(q, k, v, False, 4, 16),
           p_att.chunked_attention(to_torch(q), to_torch(k), to_torch(v), False, 4, 16))


@pytest.mark.parametrize("lens", [6, [3, 9]])
def test_decode_attention_scalar_and_per_row_length(lens):
    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.normal(size=(2, 1, 4, 8)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(2, 9, 4, 8)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(2, 9, 4, 8)), jnp.float32)
    ref_len = lens if isinstance(lens, int) else jnp.asarray(lens, jnp.int32)
    got_len = lens if isinstance(lens, int) else torch.tensor(lens, dtype=torch.int32)
    _close(r_att.decode_attention(q, k, v, ref_len),
           p_att.decode_attention(to_torch(q), to_torch(k), to_torch(v), got_len))
    if isinstance(lens, int):  # a 0-d tensor length too
        _close(r_att.decode_attention(q, k, v, ref_len),
               p_att.decode_attention(to_torch(q), to_torch(k), to_torch(v),
                                      torch.tensor(lens)))


def test_repeat_kv_is_consecutive():
    k = jnp.asarray(np.random.default_rng(8).normal(size=(2, 3, 2, 4)), jnp.float32)
    _close(r_att._repeat_kv(k, 3), p_att._repeat_kv(to_torch(k), 3), atol=0)


def _attn_modes(ref_apply, port_apply, p, cfg, cache_keys, cache_shapes, rng, **kw):
    """Train, then prefill of 6 tokens into a cache of 9, then two decode
    steps, each through both packages; outputs and caches compared."""
    b, s, d = 2, 6, cfg.d_model
    x = jnp.asarray(rng.normal(size=(b, s + 2, d)), jnp.float32)
    pt = to_torch(p)
    pos = jnp.arange(s)[None, :]
    ref, _ = ref_apply(p, x[:, :s], cfg, pos, **kw)
    got, _ = port_apply(pt, to_torch(x[:, :s]), cfg, torch.arange(s)[None, :], **kw)
    _close(ref, got)
    rc = {k: jnp.zeros(shape, jnp.float32) for k, shape in zip(cache_keys, cache_shapes)}
    pc = {k: torch.zeros(shape) for k, shape in zip(cache_keys, cache_shapes)}
    rc["len"], pc["len"] = jnp.zeros((), jnp.int32), 0
    ref, rnew = ref_apply(p, x[:, :s], cfg, pos, dict(rc), mode="prefill", **kw)
    got, pnew = port_apply(pt, to_torch(x[:, :s]), cfg, torch.arange(s)[None, :], dict(pc),
                           mode="prefill", **kw)
    _close(ref, got)
    for step in range(2):
        for key in cache_keys:
            _close(rnew[key], pnew[key])
        n = s + step
        rc = dict(rnew, len=jnp.asarray(n, jnp.int32))
        pc = dict(pnew, len=n)
        ref, rnew = ref_apply(p, x[:, n:n + 1], cfg, jnp.asarray([[n]]), rc, mode="decode", **kw)
        got, pnew = port_apply(pt, to_torch(x[:, n:n + 1]), cfg, torch.tensor([[n]]), pc,
                               mode="decode", **kw)
        _close(ref, got)


@pytest.mark.parametrize("fused", [True, False])
def test_gqa_fused_and_split(fused):
    rng = np.random.default_rng(9)
    ref_cfg, cfg = configs("qwen2-1.5b", "float32", qkv_fused=fused)
    p = _randomize(r_att.gqa_params(KEY, ref_cfg), rng, ("bqkv", "bq", "bkv"))
    assert sorted(p) == sorted(p_att.gqa_params(None, cfg))
    shape = (2, 9, cfg.n_kv_heads, cfg.hd)
    _attn_modes(r_att.gqa_apply, p_att.gqa_apply, p, cfg, ("k", "v"), (shape, shape), rng)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_attention_every_mode(fused, mode):
    """Cross-attention attends the whole source without RoPE or a mask, and
    touches no cache, whatever the mode."""
    rng = np.random.default_rng(10)
    ref_cfg, cfg = configs("whisper-base", "float32", qkv_fused=fused, qkv_bias=True)
    p = _randomize(r_att.gqa_params(KEY, ref_cfg), rng, ("bqkv", "bq", "bkv"))
    s = 1 if mode == "decode" else 5
    x = jnp.asarray(rng.normal(size=(2, s, cfg.d_model)), jnp.float32)
    src = jnp.asarray(rng.normal(size=(2, 32, cfg.d_model)), jnp.float32)
    pos = 7 + jnp.arange(s)[None, :]
    ref, rc = r_att.gqa_apply(p, x, ref_cfg, pos, None, kv_input=src, mode=mode)
    got, pc = p_att.gqa_apply(to_torch(p), to_torch(x), cfg, to_torch(pos),
                              None, kv_input=to_torch(src), mode=mode)
    assert rc is None and pc is None
    _close(ref, got)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "deepseek-v2-lite-16b"])
def test_mla_with_and_without_q_lora(arch):
    rng = np.random.default_rng(11)
    ref_cfg, cfg = configs(arch, "float32")
    p = _randomize(r_att.mla_params(KEY, ref_cfg), rng, ("q_norm", "kv_norm"))
    assert sorted(p) == sorted(p_att.mla_params(None, cfg))
    assert ("wdq" in p) == bool(cfg.q_lora_rank)
    shapes = ((2, 9, cfg.kv_lora_rank), (2, 9, cfg.qk_rope_head_dim))
    _attn_modes(r_att.mla_apply, p_att.mla_apply, p, cfg, ("ckv", "kr"), shapes, rng)


def test_cache_overflow_raises():
    _, cfg = configs("qwen2-1.5b", "float32")
    p = p_att.gqa_params(torch.Generator().manual_seed(0), cfg)
    cache = {"k": torch.zeros(1, 4, cfg.n_kv_heads, cfg.hd),
             "v": torch.zeros(1, 4, cfg.n_kv_heads, cfg.hd), "len": 4}
    with pytest.raises(ValueError, match="cannot take positions 4..4"):
        p_att.gqa_apply(p, torch.zeros(1, 1, cfg.d_model), cfg, torch.tensor([[4]]), cache,
                        mode="decode")


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_with_h0_and_padding(with_h0):
    rng = np.random.default_rng(12)
    b, s, h, p, n = 2, 23, 3, 4, 8  # 23 pads to 24 with chunks of 8
    x = jnp.asarray(rng.normal(size=(b, s, h, p)), jnp.float32)
    a_log = jnp.asarray(-np.abs(rng.normal(size=(b, s, h))) * 0.3, jnp.float32)
    B = jnp.asarray(rng.normal(size=(b, s, n)), jnp.float32)
    C = jnp.asarray(rng.normal(size=(b, s, n)), jnp.float32)
    h0 = jnp.asarray(rng.normal(size=(b, h, p, n)), jnp.float32) if with_h0 else None
    y, hN = r_ssm.ssd_chunked(x, a_log, B, C, chunk=8, h0=h0)
    got_y, got_h = p_ssm.ssd_chunked(to_torch(x), to_torch(a_log), to_torch(B), to_torch(C),
                                     chunk=8, h0=None if h0 is None else to_torch(h0))
    _close(y, got_y)
    _close(hN, got_h)
    _close(r_ssm._segsum(a_log[0, :, 0]), p_ssm._segsum(to_torch(a_log[0, :, 0])))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_with_state(with_state):
    rng = np.random.default_rng(13)
    u = jnp.asarray(rng.normal(size=(2, 5, 6)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(4, 6)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(6,)), jnp.float32)
    st = jnp.asarray(rng.normal(size=(2, 3, 6)), jnp.float32) if with_state else None
    out, new = r_ssm._causal_conv(u, w, b, st)
    got, got_new = p_ssm._causal_conv(to_torch(u), to_torch(w), to_torch(b),
                                      None if st is None else to_torch(st))
    _close(out, got)
    _close(new, got_new, atol=0)


def test_mamba2_apply_forward_prefill_and_decode():
    rng = np.random.default_rng(14)
    ref_cfg, cfg = configs("mamba2-1.3b", "float32")
    p = _randomize(r_ssm.mamba2_params(KEY, ref_cfg), rng, ("conv_bx", "conv_bB", "conv_bC",
                                                            "dt_bias"))
    pt = to_torch(p)
    assert sorted(p) == sorted(p_ssm.mamba2_params(None, cfg))
    x = jnp.asarray(rng.normal(size=(2, 11, cfg.d_model)), jnp.float32)
    ref, _ = r_ssm.mamba2_apply(p, x[:, :10], ref_cfg)
    got, _ = p_ssm.mamba2_apply(pt, to_torch(x[:, :10]), cfg)
    _close(ref, got)
    shapes = r_ssm.mamba2_cache_shape(ref_cfg, 2)
    assert shapes == p_ssm.mamba2_cache_shape(cfg, 2)
    rc = {k: jnp.zeros(v, jnp.float32) for k, v in shapes.items()}
    pc = {k: torch.zeros(v) for k, v in shapes.items()}
    for sl in (slice(0, 10), slice(10, 11)):  # a prefill, then one decode step
        ref, rc = r_ssm.mamba2_apply(p, x[:, sl], ref_cfg, rc)
        got, pc = p_ssm.mamba2_apply(pt, to_torch(x[:, sl]), cfg, pc)
        _close(ref, got)
        for k in shapes:
            _close(rc[k], pc[k])


def _moe_setup(cf):
    rng = np.random.default_rng(15)
    ref_cfg, cfg = configs("deepseek-v2-lite-16b", "float32", moe_capacity_factor=cf)
    p = r_moe.moe_params(KEY, ref_cfg)
    x = jnp.asarray(rng.normal(size=(2, 16, cfg.d_model)), jnp.float32)
    return ref_cfg, cfg, p, x


def test_moe_drops_the_references_assignments_at_capacity():
    """At capacity factor 0.5 a quarter of the 64 assignments fit: the same
    ones are kept (a differently dropped assignment moves its token's output
    by a whole expert's contribution), and the aux loss matches."""
    ref_cfg, cfg, p, x = _moe_setup(0.5)
    ref, ref_aux = r_moe.moe_apply(p, x, ref_cfg, mesh=None)
    got, got_aux = p_moe.moe_apply(to_torch(p), to_torch(x), cfg)
    _close(ref, got)
    _close(ref_aux, got_aux, atol=1e-6)
    free, _ = p_moe.moe_apply(to_torch(p), to_torch(x), dataclasses.replace(cfg,
                                                                          moe_capacity_factor=8.0))
    dropped = (np.abs(np32(free) - np32(got)).max(-1) > 1e-4).sum()
    assert dropped > 0, "capacity 0.5 must drop assignments"


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_slices_add_up_to_the_layer(ep):
    """The shares of ``ep`` expert slices (what each device of the
    reference's model axis computes before its psum) add up to the layer,
    with the shared experts counted once."""
    _, cfg, p, x = _moe_setup(1.0)
    pt, xt = to_torch(p), to_torch(x)
    whole, aux = p_moe.moe_apply(pt, xt, cfg)
    shares = [p_moe.moe_slice(pt, xt, cfg, my, ep) for my in range(ep)]
    sh = pt["shared"]
    shared = p_lay.pdot(p_lay.silu(p_lay.pdot(xt, sh["wi"])) * p_lay.pdot(xt, sh["wg"]), sh["wo"])
    _close(whole, sum(y for y, _ in shares) + shared)
    for _, a in shares:
        _close(aux, a, atol=0)
