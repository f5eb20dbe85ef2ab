"""Error mitigation of the port (models/mitigation.py): the cases of
tests/test_mitigation.py on the CPU. The folded circuits, extrapolators
and readout inversion (numpy) equal the JAX package's exactly; the density
executor's raw values equal its to 1e-5; the trajectory executor within
0.08 of the exact one (the JAX file's bound)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.core.density as JD  # noqa: E402
import qubism_tpu.models.circuits as JC  # noqa: E402
import qubism_tpu.models.mitigation as JM  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.density import DensityMatrix, depolarizing, depolarizing2  # noqa: E402
from qubism_torch.core.gates import Prim  # noqa: E402
from qubism_torch.models.amplitude import reflection_prim  # noqa: E402
from qubism_torch.models.circuits import ghz_prims  # noqa: E402
from qubism_torch.models.mitigation import (confusion_matrix, exp_extrapolate,  # noqa: E402
                                            fold_prims, linear_extrapolate, mitigate_counts,
                                            mitigate_z_expectation, richardson_extrapolate,
                                            zne_expectation)
from qubism_torch.ops.fusion import CompiledCircuit  # noqa: E402


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def test_fold_prims_noiseless_identity():
    n = 3
    prims = ghz_prims(n)
    c1, c3 = CompiledCircuit(n, prims), CompiledCircuit(n, fold_prims(prims, 3))
    a1 = c1.state_to_complex(c1(c1.init_state()))
    a3 = c3.state_to_complex(c3(c3.init_state()))
    assert np.linalg.norm(a1 - a3) < 1e-5
    folded = fold_prims(prims, 5)
    want = JM.fold_prims(JC.ghz_prims(n), 5)
    assert len(folded) == 5 * len(prims) == len(want)
    assert all(p.targets == q.targets and np.array_equal(p.u, q.u) for p, q in zip(folded, want))
    with pytest.raises(ValueError):
        fold_prims(prims, 2)


def test_zne_exp_exact_for_depolarizing_and_the_jax_values():
    n = 2
    est, vals = zne_expectation(ghz_prims(n), n, "ZZ", kraus1=depolarizing(0.03),
                                kraus2=depolarizing2(0.05), scales=(1, 3, 5), method="exp")
    assert vals[0] < 0.95 and vals[0] > vals[1] > vals[2]
    assert abs(est - 1.0) < 5e-3, (est, vals)
    jest, jvals = JM.zne_expectation(JC.ghz_prims(n), n, "ZZ", kraus1=JD.depolarizing(0.03),
                                     kraus2=JD.depolarizing2(0.05), scales=(1, 3, 5),
                                     method="exp")
    assert np.abs(np.asarray(vals) - np.asarray(jvals)).max() < 1e-5
    assert abs(est - jest) < 1e-4


def test_zne_richardson_and_linear_improve():
    n = 2
    kw = dict(kraus1=depolarizing(0.02), kraus2=depolarizing2(0.04))
    est_r, vals = zne_expectation(ghz_prims(n), n, "ZZ", scales=(1, 3, 5),
                                  method="richardson", **kw)
    est_l, _ = zne_expectation(ghz_prims(n), n, "ZZ", scales=(1, 3, 5), method="linear", **kw)
    raw_err = abs(vals[0] - 1.0)
    assert abs(est_r - 1.0) < raw_err / 3 and abs(est_l - 1.0) < raw_err
    with pytest.raises(ValueError, match="method"):
        zne_expectation(ghz_prims(n), n, "ZZ", method="cubic", **kw)


def test_zne_trajectories_executor():
    n = 2
    est, vals = zne_expectation(ghz_prims(n), n, "ZZ", kraus1=depolarizing(0.05),
                                scales=(1, 3, 5), method="linear", executor="trajectories",
                                ntraj=1024, seed=1)
    exact_est, exact_vals = zne_expectation(ghz_prims(n), n, "ZZ", kraus1=depolarizing(0.05),
                                            scales=(1, 3, 5), method="linear")
    for v, e in zip(vals, exact_vals):
        assert abs(v - e) < 0.08, (vals, exact_vals)
    assert abs(est - exact_est) < 0.15


def test_zne_refuses_a_prim_without_noise_placement():
    with pytest.raises(ValueError, match="no noise placement"):
        zne_expectation([reflection_prim(3, 1)], 3, "ZII", kraus1=depolarizing(0.1))


def test_extrapolators_on_synthetic_data_equal_jax():
    s = [1, 3, 5]
    for v, fn, jfn, want in (([2 - 0.3 * x + 0.01 * x * x for x in s], richardson_extrapolate,
                              JM.richardson_extrapolate, 2.0),
                             ([1.7 * 0.8 ** x for x in s], exp_extrapolate,
                              JM.exp_extrapolate, 1.7),
                             ([0.5 - 0.1 * x for x in s], linear_extrapolate,
                              JM.linear_extrapolate, 0.5)):
        assert abs(fn(s, v) - want) < 1e-9
        assert fn(s, v) == jfn(s, v)


def test_confusion_matrix_inverse_roundtrip():
    n, p = 3, 0.07
    a = confusion_matrix(n, p)
    assert np.allclose(a.sum(axis=0), 1.0) and np.array_equal(a, JM.confusion_matrix(n, p))
    true = np.zeros(1 << n)
    true[5], true[2] = 0.75, 0.25
    noisy = a @ true
    counts = {format(i, f"0{n}b"): int(round(noisy[i] * 10 ** 7)) for i in range(1 << n)}
    mitigated = mitigate_counts(counts, p)
    assert abs(mitigated.get("101", 0.0) - 0.75) < 1e-5
    assert abs(mitigated.get("010", 0.0) - 0.25) < 1e-5
    assert abs(sum(v for k, v in mitigated.items() if k not in ("101", "010"))) < 1e-4
    assert mitigated == JM.mitigate_counts(counts, p)


def test_mitigate_z_expectation_matches_matrix_form():
    p = 0.06
    z_true = DensityMatrix(2).apply(ghz_prims(2)).expectation("ZZ")
    assert abs(mitigate_z_expectation(z_true * (1 - 2 * p) ** 2, p, weight=2) - z_true) < 1e-12


def test_mitigate_counts_rejects_p_half():
    with pytest.raises(ValueError):
        mitigate_counts({"0": 1}, 0.5)
    assert mitigate_counts({}, 0.1) == {}
    assert Prim  # the prims above are the port's
