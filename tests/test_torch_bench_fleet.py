"""The port's fleet-tolerance benchmark against the JAX reference's golden
numbers (``benchmarks_torch/golden/reference.json``, written by
``tools/reference_figures.py``), on the CPU.

Every field that does not depend on the wall clock
(``fleet_tolerance.WALL_FREE``) must be the reference's: each section's
request counts, completions, sheds, degraded admissions, survivors and
parity, every request's status and tokens, the TP rows' plans and tokens,
the kill trace's retries, failovers, restarts and crashes, and the chaos
events (replica, step, kind); the reference's ``--check`` gates must pass.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmarks_torch import fleet_tolerance

GOLDEN = json.loads((Path(__file__).resolve().parents[1] / "benchmarks_torch" / "golden"
                     / "reference.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fleet_tolerance_matches_golden():
    gold = GOLDEN["fleet_tolerance"]
    res = fleet_tolerance.run(seed=gold["seed"], device="cpu")
    assert fleet_tolerance.check(res) == []
    got = fleet_tolerance.wall_free(res)
    for section in fleet_tolerance.WALL_FREE:
        assert got[section] == gold[section], section
    assert res["kill_trace"]["completed"] == res["kill_trace"]["admitted"] == 16
    assert res["admission"]["shed"] > 0 and res["admission"]["degraded"] > 0
