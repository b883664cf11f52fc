"""The paper's planner figures on the card against the same figures on the CPU.

``prng.normal`` and ``prng.uniform`` draw the same bits on CUDA as on the
CPU (every step is one IEEE operation, so no device contracts or
approximates one), and each figure's ``run`` gives the same integers and
speedups on both, with B1 pricing the card's schedules.  The CPU side is
held to the JAX reference in ``tests/test_torch_figures.py``.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither JAX nor the reference package, so it also runs where
only the port is installed:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_figures_cuda.py``.
"""
from __future__ import annotations

import json

import pytest
import torch

from benchmarks_torch import fig5_sws_single as fig5
from benchmarks_torch import fig6_strides as fig6
from benchmarks_torch import fig7_greedy as fig7
from benchmarks_torch import fig8_stucking as fig8
from benchmarks_torch import fig9_p_sweep as fig9
from benchmarks_torch import fig10_columns as fig10
from benchmarks_torch import planner_throughput
from repro_torch import prng
from repro_torch.kernels.hamming import ops as ham_ops
from repro_torch.kernels.hamming import ref as ham_ref

CAP = 20_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B1 has no CPU mode")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.cpu().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
@pytest.mark.parametrize("shape", [(2_000_000,), (7, 11, 13), (45, 2048)])
def test_normal_on_card_equals_cpu(cuda_device, seed, shape):
    key = prng.split(prng.PRNGKey(seed), 3)[1]
    want = prng.normal(key, shape)
    got = prng.normal(key.to(cuda_device), shape)
    assert got.device.type == "cuda"
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", [(-3.5, 2.25), (-1e-3, 1e-3)])
def test_uniform_bounds_on_card_equal_cpu(cuda_device, bounds):
    key = prng.PRNGKey(5)
    want = prng.uniform(key, (1_000_003,), *bounds)
    got = prng.uniform(key.to(cuda_device), (1_000_003,), *bounds)
    assert torch.equal(_bits(got), _bits(want))


FIGURES = {
    "fig5": lambda dev: fig5.run(["alexnet", "deit-tiny"], max_elems=CAP, device=dev),
    "fig6": lambda dev: fig6.run(["alexnet", "deit-tiny"], max_elems=CAP, device=dev),
    "fig7": lambda dev: fig7.run(["alexnet", "vgg16"], max_elems=CAP, device=dev),
    "fig8": lambda dev: fig8.run(["alexnet", "deit-tiny"], max_elems=CAP, device=dev),
    "fig9": lambda dev: fig9.transitions_sweep(("alexnet", "deit-tiny"), max_elems=CAP,
                                               device=dev),
    "fig10": lambda dev: fig10.transitions_sweep(("alexnet",), max_elems=CAP, device=dev),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_on_card_equals_cpu(cuda_device, name):
    want = FIGURES[name]("cpu")
    launches, calls = ham_ops.price_pairs.launches, ham_ref.hamming_pairs.calls
    got = FIGURES[name](cuda_device)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert ham_ref.hamming_pairs.calls == calls
    if name in ("fig6", "fig7"):  # the schedule pricing: B1 on the card
        assert ham_ops.price_pairs.launches > launches


@pytest.mark.cuda
def test_planner_throughput_card_plan_equals_cpu_plan(cuda_device):
    r = planner_throughput.run(max_elems=CAP, layers=1, device=cuda_device)
    assert r["device"] == "cuda" and r["bit_exact"] and r["n_tensors"] == 7
