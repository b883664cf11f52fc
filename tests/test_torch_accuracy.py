"""The accuracy halves of Figs. 9/10 and ``accuracy_e2e`` on the port, on the CPU.

On the reference's trained weights (``golden/trained_lm_seed0.npz``) every
sweep equals the reference's (``golden/reference.json``, written by
``tools/reference_figures.py``): each prediction at every held-out position
(the reference's top-2 gaps are all above its near-tie bound, so none may
differ), every plan total, every accuracy and speedup, and the e2e probes
(top-1 agreement exactly, logit KL within 1e-5; measured 7e-9).  The LM the
port trains itself on the CPU from the reference's key and batches stays
close to the reference's: its 120 losses within 1e-4 relative (measured
6e-6), its fp accuracy within 0.01, each sweep accuracy within 0.02 and
each total speedup within 1% relative.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks_torch import accuracy_e2e, fig9_p_sweep, fig10_columns, trained_lm

GOLDEN = Path(__file__).resolve().parents[1] / "benchmarks_torch" / "golden"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gold():
    return json.loads((GOLDEN / "reference.json").read_text())["accuracy"]


@pytest.fixture(scope="module")
def reference_weights():
    return trained_lm.reference_lm(device="cpu")


@pytest.fixture(scope="module")
def own_weights():
    return trained_lm.get_trained_lm(device="cpu")


def test_golden_weights_file(gold):
    path = GOLDEN / gold["npz"]
    assert hashlib.sha256(path.read_bytes()).hexdigest() == gold["npz_sha256"]
    assert path.stat().st_size == gold["npz_bytes"]
    with np.load(path) as z:
        assert sum(z[k].size for k in z.files) == gold["npz_values"]
        assert all(z[k].dtype == np.float32 for k in z.files)


@pytest.mark.parametrize("fig", ["fig9", "fig10", "e2e"])
def test_sweeps_on_reference_weights_equal_the_reference(gold, reference_weights, fig):
    record: dict = {}
    if fig == "e2e":
        res = accuracy_e2e.run(device="cpu", lm=reference_weights, record=record)
        want = gold["e2e"]
        assert res["logit_kl"] == pytest.approx(want["logit_kl"], abs=1e-5)
        assert {k: v for k, v in res.items() if k != "logit_kl"} == \
            {k: v for k, v in want.items() if k != "logit_kl"}
    else:
        mod = fig9_p_sweep if fig == "fig9" else fig10_columns
        res = mod.accuracy_sweep(device="cpu", lm=reference_weights, record=record)
        assert res == gold[fig]
    assert trained_lm.golden_differences(record, gold[f"{fig}_evals"]) == []


def test_own_training_tracks_the_reference(gold, own_weights):
    losses = trained_lm.train_losses(device="cpu")
    np.testing.assert_allclose(losses, gold["train_losses"], rtol=1e-4)
    cfg, params, batch_fn = own_weights
    assert trained_lm.eval_accuracy(cfg, params, batch_fn) == pytest.approx(
        gold["fig9"]["fp_accuracy"], abs=0.01)


def test_own_weights_sweeps_within_tolerance(gold, own_weights):
    r9 = fig9_p_sweep.accuracy_sweep(device="cpu", lm=own_weights)
    for p, r in r9["per_p"].items():
        want = gold["fig9"]["per_p"][p]
        assert r["accuracy"] == pytest.approx(want["accuracy"], abs=0.02)
        assert r["total_speedup"] == pytest.approx(want["total_speedup"], rel=0.01)
    r10 = fig10_columns.accuracy_sweep(device="cpu", lm=own_weights)
    for c, r in r10["per_cols"].items():
        assert r["accuracy"] == pytest.approx(gold["fig10"]["per_cols"][c]["accuracy"], abs=0.02)
    e2e = accuracy_e2e.run(device="cpu", lm=own_weights)
    assert e2e["accuracy_cim"] == pytest.approx(gold["e2e"]["accuracy_cim"], abs=0.02)
    assert e2e["total_speedup"] == pytest.approx(gold["e2e"]["total_speedup"], rel=0.01)
    assert accuracy_e2e.paper_check(e2e)[0]


def test_golden_differences_flags_a_changed_prediction(gold, reference_weights):
    record: dict = {}
    trained_lm.eval_accuracy(*reference_weights, record=record, label="fp")
    assert trained_lm.golden_differences(record, {"fp": gold["fig9_evals"]["fp"]}) == []
    record["fp"]["preds"] = record["fp"]["preds"].clone()
    record["fp"]["preds"].view(-1)[5] += 1
    assert trained_lm.golden_differences(record, {"fp": gold["fig9_evals"]["fp"]})


def test_sweep_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trained_lm.reference_lm()
