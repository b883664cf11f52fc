"""The port's pool-wear, plane-codec and redeploy-delta benchmarks against
the JAX reference's, on the CPU.

``pool_wear`` at one deployment runs both packages here and must give the
same integers and floats (every float is a ratio of equal integers); the
drift is held bit for bit with the reference's std values from the golden
file (``benchmarks_torch/golden/reference.json``, written by
``tools/reference_figures.py``), whose three-deployment integers the card
run holds.  ``plane_compression``'s transitions and bytes on resnet50 at
4096 weights a tensor must equal the reference's run here; its serving half
(bytes, token parity and the tokens) must equal the golden's.
``redeploy_delta`` on the reference's trained and further-trained weights
(golden npz) must give every golden integer.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import plane_compression as jpc
from benchmarks import pool_wear as jpw
from benchmarks_torch import plane_compression, pool_wear, redeploy_delta
from benchmarks_torch.trained_lm import reference_lm
from repro_torch import tree

GOLDEN = json.loads((Path(__file__).resolve().parents[1] / "benchmarks_torch" / "golden"
                     / "reference.json").read_text())


def test_pool_wear_one_deployment_matches_reference():
    want = jpw.run(deployments=1)
    got = pool_wear.run(deployments=1, device="cpu")
    assert got["levelings"].keys() == want["levelings"].keys()
    for lev, w in want["levelings"].items():
        g = got["levelings"][lev]
        for k in w:
            if k != "seconds":
                assert g[k] == w[k], (lev, k, g[k], w[k])
    assert got["max_wear_reduction_lpt_vs_none"] == want["max_wear_reduction_lpt_vs_none"]


def test_pool_wear_drift_with_golden_stds_is_the_references():
    """With the golden std values every checkpoint equals the reference's
    bit for bit, and the golden values are ``jnp.std``'s."""
    stds = GOLDEN["pool_wear"]["stds"]
    used: list = []
    mine = pool_wear._checkpoints(3, 0, torch.device("cpu"), stds, used)
    for d, (jparams, tparams) in enumerate(zip(jpw._checkpoints(3, 0), mine)):
        jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
        tflat = list(tree.leaves_with_path(tparams))
        assert len(jflat) == len(tflat)
        for (jp, jw), (tp, tw) in zip(jflat, tflat):
            name = tree.path_name(tp)
            assert jax.tree_util.keystr(jp, simple=True, separator="/") == name
            assert np.asarray(jw).tobytes() == tw.numpy().tobytes(), (d, name)
            if jw.ndim >= 2:
                assert stds[d][name] == pool_wear.f32_hex(torch.from_numpy(np.array(jnp.std(jw))))
    assert used == stds[:2]  # zip stops before the port's third drift


def test_pool_wear_own_std_gap_is_reported():
    """The port's own std is within a few float32 ulps of ``jnp.std``."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 64, 96)).astype(np.float32))
    want = pool_wear.f32_hex(torch.from_numpy(np.array(jnp.std(jnp.asarray(w.numpy())))))
    assert pool_wear.ulp_gap(pool_wear.f32_hex(pool_wear.std(w)), want) <= 16
    assert pool_wear.std_gaps([{"a": "3f800000"}], [{"a": "3f800003"}]) == 3


def test_plane_compression_transitions_and_bytes_match_reference():
    want = jpc.run(models=["resnet50"], max_elems=4096, serve=False)
    got = plane_compression.run(models=["resnet50"], max_elems=4096, serve=False, device="cpu")
    assert got == want


def test_plane_compression_serving_matches_golden():
    """Bytes, token parity and the served tokens of every codec equal the
    reference's (the serving half does not depend on the per-tensor cap)."""
    gold = GOLDEN["plane_compression"]["serving"]
    got = plane_compression.serving_traffic(
        list(gold["codecs"]), gen=GOLDEN["plane_compression"]["gen"], device="cpu")
    assert got["tokens_dense"] == gold["tokens_dense"]
    assert got["codecs"] == gold["codecs"]
    assert plane_compression.check({"models": {}, "serving": got}) == []


def test_redeploy_delta_on_reference_weights_matches_golden():
    gold = GOLDEN["redeploy_delta"]
    got = redeploy_delta.run(reference_weights=True, device="cpu")
    assert list(got["tensors"]) == list(gold["tensors"])
    assert got["tensors"] == gold["tensors"]
    _, old, _ = reference_lm(device="cpu")
    new = redeploy_delta.golden_new_weights(device="cpu")
    from repro_torch.core.redeploy import delta_cost

    for name, lo in redeploy_delta.priced_leaves(old):
        rep = delta_cost(lo, new[name], name=name)
        for field, value in gold["reports"][name].items():
            assert getattr(rep, field) == value, (name, field)


@pytest.mark.parametrize("module", ["pool_wear", "plane_compression", "redeploy_delta"])
def test_benchmarks_need_a_card_unless_cpu_is_asked(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {"pool_wear": lambda: pool_wear.run(deployments=1),
           "plane_compression": lambda: plane_compression.run(models=["resnet50"], max_elems=64),
           "redeploy_delta": lambda: redeploy_delta.run(reference_weights=True)}[module]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
