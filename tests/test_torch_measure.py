"""The port's measurement against the reference's: for the same state,
frame and seed, identical shots; marginals and Pauli expectations within
1e-5 of the reference and of the complex128 oracles."""

import numpy as np
import pytest
import torch

from repro.core.generators import FAMILIES, random_circuit
from repro.core.partition import partition
from repro.sim.engine import ExecutionEngine as RefEngine
from repro.sim.measure import measure_to_result as ref_measure, measurer_for
from repro.sim.statevector import simulate_np
from repro_torch import convert
from repro_torch.sim import measure as tmeasure

OBS = ["Z0 Z1 + 0.5*X2", "Y3 X5 - 0.25*Z7", "X0 Y1 Z2 X6"]
MARGINALS = [(0, 1, 2), (7, 3), (5,)]


def _both(circ, L, R, G, seed):
    plan = partition(circ, L, R, G)
    ref_eng = RefEngine(circ, plan, backend="pjit")
    eng = convert.engine_from_reference(
        circ.to_json(), plan.to_json(),
        {uid: np.asarray(t) for uid, t in ref_eng.consts.items()}, device="cpu")
    ref_res = ref_measure(measurer_for(ref_eng.run_packed(), ref_eng.measurement_frame),
                          backend="pjit", shots=512, seed=seed, marginals=MARGINALS,
                          observables=OBS)
    res = tmeasure.measure_to_result(
        tmeasure.TorchMeasurer(eng.run_packed(), eng.measurement_frame),
        backend="torch-cpu", shots=512, seed=seed, marginals=MARGINALS, observables=OBS)
    return ref_res, res


@pytest.mark.parametrize("name,L,R,G,seed", [("qft", 6, 2, 0, 0), ("ghz", 6, 2, 0, 3),
                                             ("qsvm", 5, 2, 1, 7)])
def test_measurements_match_reference(name, L, R, G, seed):
    circ = FAMILIES[name](8)
    ref_res, res = _both(circ, L, R, G, seed)
    np.testing.assert_array_equal(res.samples, ref_res.samples)
    psi = simulate_np(circ)
    for qs in MARGINALS:
        np.testing.assert_allclose(res.marginals[qs], ref_res.marginals[qs], atol=1e-5)
        np.testing.assert_allclose(res.marginals[qs], tmeasure.marginal_np(psi, qs), atol=1e-5)
    assert res.expectations.keys() == ref_res.expectations.keys()
    for key, obs in zip(res.expectations, OBS):
        assert abs(res.expectations[key] - ref_res.expectations[key]) < 1e-5
        assert abs(res.expectations[key] - tmeasure.expectation_np(psi, obs)) < 1e-5


def test_measurements_with_lazy_flips():
    """Pending flips in the frame: sampled indices, marginals and
    expectation signs are corrected on the host."""
    circ = random_circuit(8, 40, seed=4)
    ref_res, res = _both(circ, 5, 2, 1, seed=11)
    np.testing.assert_array_equal(res.samples, ref_res.samples)
    for key in res.expectations:
        assert abs(res.expectations[key] - ref_res.expectations[key]) < 1e-5


def test_pauli_parser_and_frame_copies():
    ps = tmeasure.PauliSum.parse("Z0 Z1 + 0.5*X2 - Y3")
    assert str(ps) == "1*Z0 Z1 + 0.5*X2 + -1*Y3"
    frame = tmeasure.Frame(n=4, L=2, layout=(2, 0, 3, 1), flip_bits=(1,))
    idx = np.arange(16)
    assert np.array_equal(frame.logical_to_phys(frame.phys_to_logical(idx)), idx)
    with pytest.raises(ValueError):
        tmeasure.PauliSum.parse("Z0 Z0")
    st = torch.zeros(16, dtype=torch.complex64)
    st[3] = 1.0
    m = tmeasure.TorchMeasurer(st, tmeasure.Frame.identity(4, L=2))
    assert np.array_equal(m.sample(5, seed=1), np.full(5, 3))
    np.testing.assert_allclose(m.marginal((0, 1)), [0, 0, 0, 1])
