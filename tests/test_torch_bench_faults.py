"""The port's fault-tolerance and integrity-scrub benchmarks against the JAX
reference's golden numbers (``benchmarks_torch/golden/reference.json``, written by
``tools/reference_figures.py``), on the CPU.

Every integer must be the reference's: stuck cells, hotspots, each
fault-curve deployment's pool stats, wear per crossbar and deployed bytes
(leaf sha256), horizons and max writes, every storm and ScrubReport
counter, repair and full-reprogram transitions, and the engine halves'
counters (the hot redeploy's, the engine scrub's, the scrub overhead's
rounds and tiles; the redeploy's stream parity is taken by admission
epoch, where the reference's rule gives False: ROADMAP C.8).  Logit KLs are compared in
float64 (``common.logit_kl_f64``) within 5% relative, the accuracy phase's
rule: the float32 KL at the quantization floor (~4e-7) carries rounding of
its own size, so two float32 KLs of identical weights differ by ~20% there.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmarks_torch import fault_tolerance, integrity_scrub

GOLDEN = json.loads((Path(__file__).resolve().parents[1] / "benchmarks_torch" / "golden"
                     / "reference.json").read_text())
KL_RTOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's engine on the CPU runs thousands of tiny ops: one intra-op
    thread each (the suite's workers share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kl_close(got: float, want: float) -> bool:
    return abs(got - want) <= KL_RTOL * abs(want)


def test_fault_tolerance_matches_golden():
    gold = GOLDEN["fault_tolerance"]
    got = fault_tolerance.run(rates=tuple(gold["rates"]), ref_rate=gold["ref_rate"],
                              device="cpu")
    assert len(got["fault_curve"]) == len(gold["fault_curve"])
    for g, w in zip(got["fault_curve"], gold["fault_curve"]):
        assert {k: g[k] for k in ("rate", "stuck_cells", "hotspots") if k in w} == \
            {k: w[k] for k in ("rate", "stuck_cells", "hotspots") if k in w}
        for lev in ("none", "fault"):
            assert _kl_close(g[f"kl_{lev}_f64"], w[f"kl_{lev}_f64"]), (w["rate"], lev)
    assert got["deploys"] == gold["deploys"]
    assert got["endurance"] == gold["endurance"]
    assert abs(got["recovery_at_ref"] - gold["recovery_at_ref"]) <= 1e-3
    rd = got["redeploy"]
    assert {k: rd[k] for k in fault_tolerance.REDEPLOY_KEYS} == \
        {k: gold["redeploy"][k] for k in fault_tolerance.REDEPLOY_KEYS}
    assert rd["stream_parity"] and not gold["redeploy"]["stream_parity"]
    assert rd["admitted_before_swap"] < rd["n_requests"] // 2  # why the reference's rule fails


def test_integrity_scrub_matches_golden():
    gold = GOLDEN["integrity_scrub"]
    got = integrity_scrub.run(n_requests=gold["n_requests"], kl_rates=tuple(gold["kl_rates"]),
                              device="cpu")
    assert got["storm_repair"] == gold["storm_repair"]
    assert integrity_scrub.check(got, timing=False) == []
    for part, keys in (("engine_scrub", integrity_scrub.ENGINE_SCRUB_KEYS),
                       ("overhead", integrity_scrub.OVERHEAD_KEYS)):
        assert {k: got[part][k] for k in keys} == {k: gold[part][k] for k in keys}, part
    ovh = got["overhead"]
    assert len(ovh["walls_off_s"]) == len(ovh["walls_on_s"]) == ovh["trials"]
    assert sum(ovh["rounds_per_trial"]) <= ovh["scrub_rounds"]
    assert ovh["round_s"] > 0
    for g, w in zip(got["tolerated_kl"], gold["tolerated_kl"], strict=True):
        assert (g["stuck_rate"], g["tolerated"], g["remaps"]) == \
            (w["stuck_rate"], w["tolerated"], w["remaps"])
        assert _kl_close(g["kl_f64"], w["kl_f64"]), w["stuck_rate"]


@pytest.mark.parametrize("module", ["fault_tolerance", "integrity_scrub"])
def test_fault_benchmarks_need_a_card_unless_cpu_is_asked(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {"fault_tolerance": lambda: fault_tolerance.run(rates=(0.0,), ref_rate=0.0),
           "integrity_scrub": lambda: integrity_scrub.run(n_requests=1, kl_rates=())}[module]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
