"""The paper's planner figures on the port against the JAX package, on the CPU.

Same inputs through the reference and the port:

* ``prng.uniform`` with bounds and ``prng.normal`` draw the same float32
  bits as ``jax.random.uniform`` / ``jax.random.normal`` (over 10^6 draws
  at three keys, and every value the uniform step can take);
* the bool-plane cost, schedule, stucking and sws functions the figures
  call give the reference's integers and float32 bits, on planes and
  sections fed through numpy;
* each figure's ``run`` (``benchmarks_torch``) at a small cap gives exactly
  the reference's integers and the same speedup floats, and so does
  ``planner_throughput`` (totals, every report integer, every ``w_hat``
  byte);
* ``benchmarks_torch/golden/reference.json`` names every figure and model
  that ``chip_smoke.py`` holds the card to, and its size.

The card's side (the same draws and figures on CUDA) is in
``tests/test_torch_figures_cuda.py``.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from benchmarks import common as rcommon
from benchmarks import fig5_sws_single as rfig5
from benchmarks import fig6_strides as rfig6
from benchmarks import fig7_greedy as rfig7
from benchmarks import fig8_stucking as rfig8
from benchmarks import fig9_p_sweep as rfig9
from benchmarks import fig10_columns as rfig10
from benchmarks import planner_throughput as rplanner
from benchmarks_torch import common
from benchmarks_torch import fig5_sws_single as fig5
from benchmarks_torch import fig6_strides as fig6
from benchmarks_torch import fig7_greedy as fig7
from benchmarks_torch import fig8_stucking as fig8
from benchmarks_torch import fig9_p_sweep as fig9
from benchmarks_torch import fig10_columns as fig10
from benchmarks_torch import planner_throughput
from repro.core import cost as jcost
from repro.core import planner as jplanner
from repro.core import schedule as jsched
from repro.core import stucking as jstuck
from repro.core import sws as jsws
from repro_torch import prng
from repro_torch.core import cost, schedule, stucking, sws

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "benchmarks_torch" / "golden" / "reference.json"
SEEDS = (0, 1, 2**31 - 1)
SMALL_CAP = 4096


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), 3)[1], prng.split(prng.PRNGKey(seed), 3)[1]


# ---------------------------------------------------------------------------
# prng: uniform with bounds and normal, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(-3.5, 2.25), (0.5, 7.0), (-1e-3, 1e-3)])
def test_uniform_bounds_bit_identical(seed, bounds):
    jk, tk = _keys(seed)
    lo, hi = bounds
    want = jax.random.uniform(jk, (400_000,), minval=lo, maxval=hi)
    np.testing.assert_array_equal(_bits(want), _bits(prng.uniform(tk, (400_000,), lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(400_000,), (7, 11, 13), (3, 1001)])
def test_normal_bit_identical(seed, shape):
    """Over 1.2M draws at three keys; 1-D, ragged and 2-D shapes."""
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(_bits(jax.random.normal(jk, shape)),
                                  _bits(prng.normal(tk, shape)))


def test_normal_batched_keys_match_per_key_draws():
    """A batch of keys [4, 2] draws what each key draws alone."""
    jkeys, tkeys = jax.random.split(jax.random.PRNGKey(3), 4), prng.split(prng.PRNGKey(3), 4)
    got = prng.normal(tkeys, (1000,))
    assert got.shape == (4, 1000)
    for i in range(4):
        np.testing.assert_array_equal(_bits(jax.random.normal(jkeys[i], (1000,))), _bits(got[i]))


@jax.jit
def _jax_normal_of_bits(bits):
    """``jax.random.normal``'s arithmetic on given random bits (its
    ``_normal_real``: uniform on [nextafter(-1, 0), 1), then
    ``sqrt(2) * erf_inv``)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    fb = lax.shift_right_logical(bits, jnp.uint32(9)) | jnp.uint32(0x3F800000)
    floats = lax.bitcast_convert_type(fb, jnp.float32) - jnp.float32(1)
    u = lax.max(jnp.float32(lo), floats * (jnp.float32(1) - jnp.float32(lo)) + jnp.float32(lo))
    return lax.mul(np.float32(np.sqrt(2)), lax.erf_inv(u))


def test_normal_every_uniform_value():
    """The uniform step keeps 23 random bits, so a normal draw takes one of
    2^23 values; every 7th of them (both ends included: ``u == lo``, where
    the tail branch of erf_inv runs, and the largest ``u``) equals jax's."""
    mant = np.unique(np.concatenate([np.arange(0, 1 << 23, 7), [(1 << 23) - 1]]))
    bits = (mant.astype(np.uint32) << 9) | 0x1FF  # the dropped low bits must not matter
    want = np.asarray(_jax_normal_of_bits(jnp.asarray(bits)))
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    floats = _t(((bits >> 9) | 0x3F800000).view(np.float32)) - 1.0
    u = torch.maximum(torch.tensor(lo), prng._fma(floats, torch.tensor(2.0), torch.tensor(lo)))
    got = prng._erf_inv(u) * prng._f32(0x3FB504F3, "cpu")
    assert float(u[0]) == lo
    np.testing.assert_array_equal(_bits(want), _bits(got))


def test_fma_rounds_once():
    """``_fma`` is the correctly rounded a * b + c (exact rational check on
    products whose sum a float64 add would round twice)."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * np.exp2(rng.integers(-30, 30, 2000))).astype(np.float32)
    got = prng._fma(_t(a), _t(b), _t(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))]
        best = min(abs(Fraction(float(v)) - exact) for v in cands)
        assert abs(Fraction(float(g)) - exact) == best


def test_model_weights_equal_reference():
    """The figures' weight sets: key schedule, draws and float32 scale."""
    for name in ("alexnet", "yi6b-layer"):
        want = list(rcommon.model_weights(name, max_elems=50_000))
        got = list(common.model_weights(name, max_elems=50_000, device="cpu"))
        assert [n for n, _ in want] == [n for n, _ in got]
        for (_, w), (_, g) in zip(want, got):
            np.testing.assert_array_equal(_bits(w), _bits(g))


# ---------------------------------------------------------------------------
# core: the bool-plane entry points the figures call
# ---------------------------------------------------------------------------

def _planes(s, rows=40, cols=10, seed=0, p=0.4) -> np.ndarray:
    return np.random.default_rng(seed).random((s, rows, cols)) < p


@pytest.mark.parametrize("include_initial", [True, False])
@pytest.mark.parametrize("per_column", [True, False])
@pytest.mark.parametrize("ordered", [True, False])
def test_chain_transitions(include_initial, per_column, ordered):
    planes = _planes(23)
    order = np.random.default_rng(1).permutation(23).astype(np.int32) if ordered else None
    want = jcost.chain_transitions(jnp.asarray(planes),
                                   None if order is None else jnp.asarray(order),
                                   include_initial=include_initial, per_column=per_column)
    got = cost.chain_transitions(_t(planes), None if order is None else _t(order),
                                 include_initial=include_initial, per_column=per_column)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("include_initial", [True, False])
def test_consecutive_costs(include_initial):
    planes = _planes(19, rows=37, seed=2)
    order = np.random.default_rng(3).permutation(19).astype(np.int32)
    for o in (None, order):
        want = jcost.consecutive_costs(jnp.asarray(planes), None if o is None else jnp.asarray(o),
                                       include_initial=include_initial)
        got = cost.consecutive_costs(_t(planes), None if o is None else _t(o),
                                     include_initial=include_initial)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("kind", ["stride1", "strideL"])
@pytest.mark.parametrize("include_initial", [True, False])
def test_schedule_job_costs_and_transitions_on_bool_planes(kind, include_initial):
    planes = _planes(45, rows=128, seed=4)
    chains = jsched.make_chains(45, 4, kind)
    want_jobs = jsched.schedule_job_costs(jnp.asarray(planes), chains,
                                          include_initial=include_initial)
    got_jobs = schedule.schedule_job_costs(_t(planes), schedule.make_chains(45, 4, kind),
                                           include_initial=include_initial)
    np.testing.assert_array_equal(np.asarray(want_jobs), got_jobs.numpy())
    want = jsched.schedule_transitions(jnp.asarray(planes), chains, include_initial=include_initial)
    got = schedule.schedule_transitions(_t(planes), schedule.make_chains(45, 4, kind),
                                        include_initial=include_initial)
    assert int(got) == int(want)


@pytest.mark.parametrize("sort_jobs", [True, False])
@pytest.mark.parametrize("n_jobs", [0, 1, 63, 64, 130, 1000])
def test_lockstep_speedup_float32_bits(sort_jobs, n_jobs):
    jobs = np.random.default_rng(n_jobs).integers(0, 9000, n_jobs).astype(np.int32)
    want = jsched.lockstep_speedup(jnp.asarray(jobs), 64, sort_jobs=sort_jobs)
    got = schedule.lockstep_speedup(_t(jobs), 64, sort_jobs=sort_jobs)
    assert got.dtype == torch.float32
    assert _bits(np.float32(want)) == _bits(got.numpy())


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("kind", ["stride1", "strideL"])
def test_stuck_schedule_total_and_achieved(p, kind):
    planes = _planes(37, rows=100, seed=5, p=0.5)
    chains = jsched.make_chains(37, 6, kind)
    want_t, want_a = jstuck.stuck_schedule(jnp.asarray(planes), chains, p, jax.random.PRNGKey(9))
    got_t, got_a = stucking.stuck_schedule(_t(planes), schedule.make_chains(37, 6, kind), p,
                                           prng.PRNGKey(9))
    assert int(got_t) == int(want_t)
    assert got_a.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(want_a), got_a.numpy())


@pytest.mark.parametrize("p", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("stuck_cols", [1, 3])
def test_expected_saving_fraction(p, stuck_cols):
    planes = _planes(30, rows=64, seed=6, p=0.45)
    order = np.random.default_rng(7).permutation(30).astype(np.int32)
    want = jstuck.expected_saving_fraction(jnp.asarray(planes), jnp.asarray(order), p,
                                           stuck_cols=stuck_cols)
    got = stucking.expected_saving_fraction(_t(planes), _t(order), p, stuck_cols=stuck_cols)
    assert _bits(np.float32(want)) == _bits(got.numpy())


@pytest.mark.parametrize("descending", [False, True])
def test_section_norm_order(descending):
    sec = (np.random.default_rng(8).standard_normal((97, 128)) * 0.05).astype(np.float32)
    sec[10] = sec[3]  # a tie: stable order keeps 3 before 10
    sec[20] = -sec[3]
    want = jsws.section_norm_order(jnp.asarray(sec), descending=descending)
    got = sws.section_norm_order(_t(sec), descending=descending)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# the figures, at a small cap
# ---------------------------------------------------------------------------

FIGURES = {
    "fig5": (lambda: rfig5.run(["alexnet", "deit-tiny", "internlm2-layer"], max_elems=SMALL_CAP),
             lambda: fig5.run(["alexnet", "deit-tiny", "internlm2-layer"], max_elems=SMALL_CAP,
                              device="cpu")),
    "fig6": (lambda: rfig6.run(["alexnet", "deit-tiny"], max_elems=SMALL_CAP),
             lambda: fig6.run(["alexnet", "deit-tiny"], max_elems=SMALL_CAP, device="cpu")),
    "fig7": (lambda: rfig7.run(["alexnet", "vgg16"], max_elems=SMALL_CAP),
             lambda: fig7.run(["alexnet", "vgg16"], max_elems=SMALL_CAP, device="cpu")),
    "fig8": (lambda: rfig8.run(["alexnet", "deit-tiny"], max_elems=SMALL_CAP),
             lambda: fig8.run(["alexnet", "deit-tiny"], max_elems=SMALL_CAP, device="cpu")),
    "fig9": (lambda: rfig9.transitions_sweep(("alexnet", "deit-tiny"), max_elems=SMALL_CAP),
             lambda: fig9.transitions_sweep(("alexnet", "deit-tiny"), max_elems=SMALL_CAP,
                                            device="cpu")),
    "fig10": (lambda: rfig10.transitions_sweep(("alexnet",), max_elems=SMALL_CAP),
              lambda: fig10.transitions_sweep(("alexnet",), max_elems=SMALL_CAP, device="cpu")),
}


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_matches_reference(name):
    """Every integer equal and every speedup the same float (JSON text equal)."""
    ref_fn, port_fn = FIGURES[name]
    assert json.dumps(port_fn(), sort_keys=True) == json.dumps(ref_fn(), sort_keys=True)


def test_fig9_fig10_run_returns_transitions_only():
    res = fig9.run(max_elems=64, device="cpu")
    assert set(res) == {"transitions"} and set(res["transitions"]) == {"vit-base", "resnet50"}
    assert "accuracy_sweep" not in vars(fig9) and "accuracy_sweep" not in vars(fig10)


def test_planner_throughput_matches_reference_packed_plan():
    """1 layer at a small cap: the port plans on the CPU twice (the CUDA
    side is the card's), with the reference's totals, report integers and
    w_hat bytes."""
    import hashlib

    params = rplanner.gemma_scale_params(max_elems=SMALL_CAP, layers=1)
    plan = jplanner.build_deployment(params, jplanner.CrossbarSpec(rows=128, cols=10),
                                     jplanner.PlannerConfig(p_stuck=0.5, min_size=1024,
                                                            impl="packed"))
    got = planner_throughput.run(max_elems=SMALL_CAP, layers=1, device="cpu")
    assert got["bit_exact"] and got["n_tensors"] == len(plan.reports) == 7
    assert got["totals"] == plan.totals()
    assert got["reports"] == {k: {f: getattr(r, f) for f in planner_throughput.REPORT_FIELDS}
                              for k, r in plan.reports.items()}
    assert got["w_hat_sha256"] == {k: hashlib.sha256(np.asarray(w).tobytes()).hexdigest()
                                   for k, w in plan.deployed.items()}


def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda **kw: fig5.run(["alexnet"], max_elems=64, **kw),
                 lambda **kw: next(common.model_weights("alexnet", max_elems=64, **kw)),
                 lambda **kw: planner_throughput.gemma_scale_params(max_elems=64, layers=1, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")


# ---------------------------------------------------------------------------
# the golden file chip_smoke.py holds the card to
# ---------------------------------------------------------------------------

def test_golden_file_names_every_figure_model_and_its_size():
    gold = json.loads(GOLDEN.read_text())
    assert gold["jax_version"] and gold["seed"] == 0 and gold["max_elems"] > 0
    assert gold["sweep_max_elems"] == min(gold["max_elems"], common.SWEEP_CAP)
    assert list(gold["fig5"]) == common.PAPER_DEFAULT_MODELS + ["internlm2-layer", "yi6b-layer"]
    assert list(gold["fig6"]) == ["resnet50", "vit-base"]
    assert list(gold["fig7"]) == list(gold["fig8"]) == common.PAPER_DEFAULT_MODELS
    for fig in ("fig9", "fig10"):
        assert list(gold[fig]) == ["vit-base", "resnet50"]
    assert all(list(e["transitions"]) == [str(p) for p in fig9.PS] for e in gold["fig9"].values())
    assert all(list(e) == [str(c) for c in fig10.COLS_SWEEP] for e in gold["fig10"].values())
    assert all(list(e["strideL"]) == ["1", "2", "4", "8", "16"] for e in gold["fig6"].values())
    pl = gold["planner"]
    assert pl["layers"] >= 1 and pl["max_elems"] > 0 and pl["p_stuck"] == 0.5
    assert len(pl["reports"]) == len(pl["w_hat_sha256"]) == 7 * pl["layers"]
    assert set(pl["totals"]) >= {"transitions_baseline", "transitions_sws", "transitions_final"}
