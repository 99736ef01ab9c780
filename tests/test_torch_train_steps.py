"""Five steps of the port's ``make_train_step`` against the reference's
jitted ``make_train_step`` on the CPU, reduced, float32 weights, the same
synthetic batches: qwen2, mamba2 and deepseek-v2-lite (MoE + MLA), moments
in float32 and bf16, qwen2 with 2 microbatches; and a reference run carried
across mid-run (``lm_params_from_reference`` and
``adamw_state_from_reference``) that continues as the reference does.

Bounds: each step's loss within a relative 1e-5; parameters within 0.5 lr
(AdamW moves a parameter whose gradient is rounding noise by up to lr
either way, so a sign that rounding flips moves it by up to 2 lr); the
gradient norm within a relative 1e-5, or twice the reference's own floor
where that is larger. The floor is how far the reference's grad norm
moves, at that step or an earlier one, when the run starts from weights
whose embedding moved by one float32 ulp: Adam turns noise-level gradient
entries into lr-sized steps, two runs that part do not meet again, and
mamba2 with random weights amplifies the parting (its floor reaches
6.5e-5 at step 3 with float32 moments and 1.1e-4 with bf16; qwen2's and
deepseek's stay under 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import configs, flat, one_ulp, port_model, ref_params
from repro.launch import steps as r_steps
from repro.models.transformer import Model as RefModel
from repro.optim import adamw as r_adamw
from repro_torch.convert import adamw_state_from_reference, lm_params_from_reference
from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from repro_torch.launch import steps
from repro_torch.optim import adamw

LR = 2e-3
STEPS = 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread, so the suite's other
    workers, and the rank processes that other test files run under
    ``nice``, keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Runs:
    """Both packages on one config: the reference's jitted step and its
    state, the port's step and its state, the data."""

    def __init__(self, name, moment_dtype, microbatches, params=None):
        self.ref_cfg, self.cfg = configs(name, "float32")
        self.params = ref_params(self.ref_cfg) if params is None else params
        opt = dict(lr=LR, warmup_steps=2, total_steps=10, moment_dtype=moment_dtype)
        self.r_opt, self.p_opt = r_adamw.AdamWConfig(**opt), adamw.AdamWConfig(**opt)
        self.r_step = jax.jit(r_steps.make_train_step(RefModel(self.ref_cfg), self.r_opt,
                                                      microbatches))
        self.port = port_model(self.cfg, self.params)
        self.p_step = steps.make_train_step(self.port, self.p_opt, microbatches)
        self.data = SyntheticDataset(SyntheticConfig(vocab_size=self.cfg.vocab_size,
                                                     seq_len=16, global_batch=4, seed=3))

    def ref_start(self, params):
        rp = jax.tree.map(jnp.asarray, params)
        return rp, r_adamw.init(self.r_opt, rp)

    def ref_run(self, rp, rs, start, stop):
        out = []
        for i in range(start, stop):
            b = {k: jnp.asarray(v) for k, v in self.data.batch(i).items()}
            rp, rs, m = self.r_step(rp, rs, b)
            out.append((jax.tree.map(np.asarray, rp), {k: float(v) for k, v in m.items()}))
        return rp, rs, out

    def port_run(self, pp, ps, start, stop):
        out = []
        for i in range(start, stop):
            b = {k: torch.from_numpy(v) for k, v in self.data.batch(i).items()}
            pp, ps, m = self.p_step(pp, ps, b)
            out.append(({k: v.detach().clone() for k, v in pp.items()},
                        {k: float(v) for k, v in m.items()}))
        return pp, ps, out


def _hold(ref_out, port_out, floors):
    for i, ((rp, rm), (pp, pm), floor) in enumerate(zip(ref_out, port_out, floors)):
        assert sorted(rm) == sorted(pm), (sorted(rm), sorted(pm))
        assert np.isfinite(rm["loss"])
        np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=1e-5, err_msg=f"step {i}")
        for k in rm:
            if k not in ("loss", "grad_norm"):
                np.testing.assert_allclose(pm[k], rm[k], rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {i} {k}")
        np.testing.assert_allclose(pm["grad_norm"], rm["grad_norm"],
                                   rtol=max(1e-5, 2 * floor), err_msg=f"step {i}")
        for k, v in flat(rp).items():
            np.testing.assert_allclose(pp[k].numpy(), v, rtol=0, atol=0.5 * LR,
                                       err_msg=f"step {i} {k}")


def _floors(runs, ref_out):
    """Per step: the largest relative move of the reference's grad norm
    under a one-ulp embedding move, at that step or before."""
    _, _, moved = runs.ref_run(*runs.ref_start(one_ulp(runs.params)), 0, len(ref_out))
    return np.maximum.accumulate([abs(m["grad_norm"] - r["grad_norm"]) / r["grad_norm"]
                                  for (_, r), (_, m) in zip(ref_out, moved)]).tolist()


@pytest.mark.parametrize("name,moment_dtype,microbatches", [
    ("qwen2-1.5b", "float32", 1), ("qwen2-1.5b", "bfloat16", 1), ("qwen2-1.5b", "bfloat16", 2),
    ("mamba2-1.3b", "float32", 1), ("mamba2-1.3b", "bfloat16", 1),
    ("deepseek-v2-lite-16b", "float32", 1), ("deepseek-v2-lite-16b", "bfloat16", 1)])
def test_five_steps_match_the_references_jitted_step(name, moment_dtype, microbatches):
    runs = Runs(name, moment_dtype, microbatches)
    _, _, ref_out = runs.ref_run(*runs.ref_start(runs.params), 0, STEPS)
    pp = dict(runs.port.named_parameters())
    _, ps, port_out = runs.port_run(pp, adamw.init(runs.p_opt, pp), 0, STEPS)
    assert int(ps.step) == STEPS
    if microbatches > 1:
        assert sorted(port_out[0][1]) == ["ce_loss", "grad_norm", "loss", "lr"]
    _hold(ref_out, port_out, _floors(runs, ref_out))


@pytest.mark.parametrize("name,moment_dtype", [("qwen2-1.5b", "bfloat16"),
                                               ("mamba2-1.3b", "float32")])
def test_a_reference_state_carried_across_mid_run_continues(name, moment_dtype):
    """Three reference steps, then its weights and AdamW state into the
    port, which takes steps 3 and 4 as the reference does."""
    runs = Runs(name, moment_dtype, 1)
    rp, rs, ref_out = runs.ref_run(*runs.ref_start(runs.params), 0, STEPS)
    mid_p, mid_s, _ = runs.ref_run(*runs.ref_start(runs.params), 0, 3)
    lm_params_from_reference(runs.port, jax.tree.map(np.asarray, mid_p))
    ps = adamw_state_from_reference(runs.port, jax.tree.map(np.asarray, mid_s))
    assert int(ps.step) == 3 and ps.step.dtype == torch.int32
    assert next(iter(ps.m.values())).dtype == (
        torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32)
    for k, v in flat(mid_s.v).items():
        np.testing.assert_array_equal(ps.v[k].float().numpy(), np.asarray(v, np.float32))
    _, ps, port_out = runs.port_run(dict(runs.port.named_parameters()), ps, 3, STEPS)
    assert int(ps.step) == STEPS
    _hold(ref_out[3:], port_out, _floors(runs, ref_out)[3:])
