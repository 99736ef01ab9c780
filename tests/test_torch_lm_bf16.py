"""Every arch of ``ARCHS`` at reduced size through the port and the
reference in the configuration's bf16, on the reference's weights:
forward logits, loss, prefill logits and cache, three decode steps.

The tolerances are the reference's own for bf16 (``tests/test_models.py``:
decode against forward, 2e-2 for attention and 3e-2 for an SSM, absolute
and relative), plus the bf16 noise floor of the model: twice the largest
departure of the reference's bf16 logits from its own float32 twin on the
same weights and inputs (two bf16 computations of one function can differ
by the sum of their departures). The reference's tolerances hold at the
one position its test compares; over every logit of a batch, one ulp of a
hidden state moves a few logits near zero past them (0.023 against 0.02).
For the reduced Mamba-2 the floor is large: its gated rms norm meets rows
of rms ~0.05, where one bf16 ulp of a conv or gate output grows to tenths
of a logit, so the reference's bf16 departs from its float32 twin by up
to half a logit. Teacher-forced decode logits are forward logits of the
same positions, so the forward's floor bounds them too. The float32
comparison (``tests/test_torch_lm_models.py``) is the tight one.
"""

import numpy as np
import pytest

from _torch_lm import run_both
from repro.configs.registry import ARCHS, get_arch


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arch_bf16_matches_the_reference(name):
    out = run_both(name, "bfloat16", twin=True)
    floor = float(np.abs(out.pop("twin_logits") - out["logits"][0]).max())
    tol = 3e-2 if get_arch(name).ssm else 2e-2
    for what, (ref, got) in out.items():
        if what.endswith(".len"):
            assert ref == got, what
        else:
            np.testing.assert_allclose(got, ref, rtol=tol, atol=tol + 2 * floor, err_msg=what)
