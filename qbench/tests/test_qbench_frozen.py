"""The benchmark's frozen copies hold what the port's own functions give
today: the circuit generators, qelib1.inc, the kernel cost, the bound and
the kernel names."""

import math

import numpy as np
import pytest

from qbench import roofline
from qbench.circuits import qft


def _same_gates(ours, prims):
    assert len(ours) == len(prims)
    for (u, targets, diag), p in zip(ours, prims):
        assert tuple(targets) == tuple(p.targets) and diag == p.diag
        np.testing.assert_array_equal(np.asarray(u), np.asarray(p.u))


@pytest.mark.parametrize("n", [1, 4, 9, 30])
def test_qft_copy(n):
    """Without its swaps, the QFT is the port's."""
    from qubism_torch.models.circuits import qft_prims, qft_qasm

    cfg = {"num_qubits": n}
    for seed in range(3):
        p = qft.draw(cfg, seed)
        inputs = tuple(q for q in range(n) if (p["x"] >> (n - 1 - q)) & 1)
        lines = qft.text(cfg, p).splitlines()
        assert lines[2] == qft.SWAP_GATE
        swaps = [f"swap q[{q}],q[{n - 1 - q}];" for q in range(n // 2)]
        assert lines[len(lines) - len(swaps):] == swaps
        assert "\n".join(lines[:2] + lines[3:len(lines) - len(swaps)]) + "\n" == \
            qft_qasm(n, measure=False, inputs=inputs)
    _same_gates(qft.body(cfg)[:len(qft.body(cfg)) - n // 2], qft_prims(n))


def test_qelib1_copy(root):
    assert (root / "qbench" / "qelib1.inc").read_bytes() == \
        (root / "examples" / "qelib1.inc").read_bytes()


def _kernel_cases(n):
    """(name, args) of each kernel on the port's own prepared operands."""
    import torch

    from qubism_torch.ops import kernels

    h = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
    d4 = np.array([1, 1, 1, 1j])
    stages = ((h, 0, ((d4, (0, 1)), (d4, (0, 5)))), (h, 1, ((d4, (1, 5)),)))
    cpu = torch.device("cpu")
    return [("gate", (np.eye(4), (1, 3))), ("layer1q", ((h, 0), (h, 2), (h, 4))),
            ("diag", (((d4, (0, 1)), (np.ones(8), (2, 3, 4))),)), ("lane", (np.eye(1 << min(n, 7)),)),
            ("stage", (kernels.stage_block_prepare(stages, n, cpu),))]


@pytest.mark.parametrize("n", [8, 30])
def test_kernel_cost_copy(n):
    import chip_smoke

    for name, args in _kernel_cases(n):
        assert roofline.kernel_cost(name, args, n) == chip_smoke.kernel_cost(name, args, n), name


def test_kernel_cost_of_prepared_diag():
    import torch

    from qubism_torch.ops import kernels

    factors = ((np.array([1, 1, 1, -1]), (0, 1)), (np.array([1, 1j]), (3,)))
    plan = kernels.diag_prepare(factors, 10, torch.device("cpu"))
    assert roofline.kernel_cost("diag", (plan,), 10) == roofline.kernel_cost("diag", (factors,), 10)


def test_bound_copy():
    from qubism_torch.ops import probes

    assert (roofline.PEAK_BYTES_PER_S, roofline.PEAK_FP32_FLOP_PER_S,
            roofline.PEAK_TF32_FLOP_PER_S) == (probes.PEAK_BYTES_PER_S,
                                               probes.PEAK_FP32_FLOP_PER_S,
                                               probes.PEAK_TF32_FLOP_PER_S)
    for nbytes, flops, tf32 in [(16 << 30, 8 << 30, False), (1 << 20, 1 << 40, False),
                                (16 << 30, 1 << 40, True), (16 << 28, 128 << 31, True)]:
        assert roofline.bound_s(nbytes, flops, tf32) * 1e3 == pytest.approx(
            probes.bound(nbytes, flops, tf32)[0], rel=1e-12)


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::layer1q_kernel<6, false>(float2*, long, float2 const*, Layer1QArgs<6, false>)",
    "lane_wgmma_kernel(float*, long, float4 const*)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<c10::complex<float> >, std::array<char*, 1ul> >(int, at::native::FillFunctor<c10::complex<float> >, std::array<char*, 1ul>)",
    "Memcpy HtoD (Pageable -> Device)",
])
def test_short_name_copy(name):
    from qubism_torch.experiments.profile_circuits import _short

    assert roofline.short_name(name) == _short(name)
