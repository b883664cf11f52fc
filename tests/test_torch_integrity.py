"""The port's integrity layer (``core/integrity.py``) against the JAX
package, on the CPU.

Every contract of the reference's ``tests/test_integrity.py`` (registration
parity, in-place rewrites of corrupted bits, spare-column remaps, section
migration, tolerated LSB faults, transient classification, pre-existing
faults under a codec) runs on both packages with identical inputs: one
tensor drawn from ``PRNGKey(0)`` planned through a 4-crossbar pool of
64 x 8 crossbars, storms from the same keys.  Checksums, every
``ScrubReport`` counter, ``col_map``, spares, stored cells and masks, the
pool's wear and ``total_writes``, and the ``rebuild`` bytes must be
identical.  The repair budget's progress guarantee is the one place the
port departs (ROADMAP C.3), tested on the port alone.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integrity as jint
from repro.core import nonideal as jni
from repro.core import planner as jplanner
from repro.core import pool as jpool
from repro_torch import prng
from repro_torch.core import integrity, nonideal, planner, pool

ROWS, COLS = 64, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcfg(mod, **kw):
    return mod.PlannerConfig(**{"p_stuck": 1.0, "crossbars": 4, **kw})


def _setup(icfg_kw=None, *, pcfg_kw=None, fault_kw=None, spec=(ROWS, COLS), shape=(40, 20)):
    """The reference's ``_setup`` in both packages: a 4-crossbar lpt pool
    with integrity (and faults), one tensor ``t0`` programmed."""
    icfg_kw, pcfg_kw = icfg_kw or {}, pcfg_kw or {}
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape)) * np.float32(0.05)
    js = jplanner.CrossbarSpec(rows=spec[0], cols=spec[1])
    ts = planner.CrossbarSpec(rows=spec[0], cols=spec[1])
    jp = jpool.CrossbarPool(js, 4, leveling="lpt")
    tp = pool.CrossbarPool(ts, 4, leveling="lpt", device="cpu")
    if fault_kw is not None:
        jp.inject_faults(jni.FaultModel(**fault_kw), jax.random.PRNGKey(5))
        tp.inject_faults(nonideal.FaultModel(**fault_kw), prng.PRNGKey(5))
    jm = jp.enable_integrity(jint.IntegrityConfig(**icfg_kw))
    tm = tp.enable_integrity(integrity.IntegrityConfig(**icfg_kw))
    _, jw = jplanner._analyze_tensor_pool(jnp.asarray(w), js, _pcfg(jplanner, **pcfg_kw),
                                          jax.random.PRNGKey(1), jp, name="t0")
    _, tw = planner.analyze_tensor(torch.from_numpy(w), ts, _pcfg(planner, **pcfg_kw),
                                   prng.PRNGKey(1), name="t0", pool=tp)
    assert np.asarray(jw).tobytes() == tw.numpy().tobytes()
    return (jp, jm, jw), (tp, tm, tw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(jm, tm, *reports):
    """Managers, records and pools identical; pairs of ScrubReports equal."""
    for jr, tr in zip(reports[::2], reports[1::2]):
        assert dataclasses.asdict(jr) == dataclasses.asdict(tr)
    assert jm.summary() == tm.summary()
    assert jm.total_tiles == tm.total_tiles and jm.pending_faults() == tm.pending_faults()
    assert jm.clean == tm.clean and jm.affected() == tm.affected()
    assert jm.transitions_full_affected() == tm.transitions_full_affected()
    for name, jr in jm.tensors.items():
        tr = tm.tensors[name]
        for f in ("reference", "expected", "stored", "stuck0", "stuck1", "spare", "spare_used",
                  "col_map", "parity", "sec_xbar"):
            a, b = getattr(jr, f), getattr(tr, f)
            if a is None:
                assert b is None, f
                continue
            np.testing.assert_array_equal(np.asarray(a), _np(b), err_msg=f)
        np.testing.assert_array_equal(np.asarray(jr.checksums), _np(tr.checksums).astype(np.uint32))
        assert jr.detections == tr.detections and jr.transitions_full == tr.transitions_full
        assert np.asarray(jm.read(jr, transient=False)).tobytes() == \
            tm.read(tr, transient=False).numpy().tobytes()
    np.testing.assert_array_equal(jm.pool.wear, tm.pool.wear)
    assert jm.pool.total_writes == tm.pool.total_writes
    assert jm.spare_writes == tm.spare_writes
    assert jm.verify_all() == tm.verify_all()


def _assert_rebuild(jm, tm, w_hat=None):
    want = np.asarray(jm.rebuild("t0"))
    got = tm.rebuild("t0").numpy()
    assert want.tobytes() == got.tobytes()
    if w_hat is not None:
        assert got.tobytes() == w_hat.numpy().tobytes()


def _storm(jm, tm, seed, **rates):
    js = jm.storm(jax.random.PRNGKey(seed), **rates)
    ts = tm.storm(prng.PRNGKey(seed), **rates)
    assert js == ts
    return ts


def test_integrity_config_validation():
    for bad in (dict(tile_bytes=0), dict(spare_cols=-1), dict(scrub_tiles=0),
                dict(repair_budget=0), dict(tolerate_cols=-1), dict(transient_rate=-0.1),
                dict(transient_rate=1.5)):
        with pytest.raises(ValueError):
            integrity.IntegrityConfig(**bad)
    _, (_, tm, _) = _setup()
    with pytest.raises(ValueError):
        tm.storm(prng.PRNGKey(0), corrupt_rate=2.0)


@pytest.mark.parametrize("tile_bytes", [16, 3])
def test_checksums_match_reference(tile_bytes):
    planes = np.random.default_rng(0).integers(0, 256, (5, 8, 10)).astype(np.uint8)
    want = jint.tile_checksums(planes, tile_bytes)
    got = integrity.tile_checksums(torch.from_numpy(planes), tile_bytes)
    np.testing.assert_array_equal(want, got.numpy().astype(np.uint32))
    zero = torch.zeros((1, 16, 2), dtype=torch.uint8)
    base = integrity.tile_checksums(zero, 16)
    for i in (0, 7, 15):
        mod = zero.clone()
        mod[0, i, 1] ^= 0x10
        assert bool((integrity.tile_checksums(mod, 16) != base).any()), i


def test_register_clean_scrub_and_rebuild_parity():
    (jp, jm, jw), (tp, tm, tw) = _setup()
    assert tm.summary()["tensors"] == 1 and tm.total_tiles > 0 and tm.verify_all()
    jr, tr = jm.scrub_until_clean(), tm.scrub_until_clean()
    assert tr.detections == 0 and tr.repair_transitions == 0 and tm.clean
    _assert_same(jm, tm, jr, tr)
    _assert_rebuild(jm, tm, tw)


@pytest.mark.parametrize("seed,rates", [
    (7, dict(corrupt_rate=5e-3)),
    (9, dict(stuck_rate=1e-3)),
    (7, dict(corrupt_rate=2e-3, stuck_rate=2e-4)),
    (3, dict(corrupt_rate=2e-2, stuck_rate=5e-3)),
])
@pytest.mark.parametrize("icfg_kw", [{}, dict(spare_cols=1, scrub_tiles=5),
                                     dict(parity_col=False, tile_bytes=5)])
def test_storm_scrub_and_repair_match_reference(seed, rates, icfg_kw):
    """Storms, rounds and repairs: every counter and every state identical,
    round by round, then to convergence; the rebuilt weights are the
    reference's bytes."""
    (jp, jm, jw), (tp, tm, tw) = _setup(icfg_kw)
    _storm(jm, tm, seed, **rates)
    _assert_same(jm, tm)
    for _ in range(3):
        _assert_same(jm, tm, jm.scrub_round(), tm.scrub_round())
    _assert_same(jm, tm, jm.scrub_until_clean(), tm.scrub_until_clean())
    assert tm.clean and tm.verify_all()
    _assert_rebuild(jm, tm)


def test_corruption_rewritten_in_place_priced_exactly():
    (jp, jm, jw), (tp, tm, tw) = _setup()
    writes, wear = tp.total_writes, tp.wear.sum()
    st = _storm(jm, tm, 7, corrupt_rate=5e-3)
    assert st["corrupted_bits"] > 0 and not tm.verify_all()
    jr, tr = jm.scrub_until_clean(), tm.scrub_until_clean()
    _assert_same(jm, tm, jr, tr)
    assert tr.rewrites > 0 and tr.remaps == tr.migrations == 0
    assert tr.localized_bits == tr.repair_transitions == st["corrupted_bits"]
    assert tp.total_writes - writes == tp.wear.sum() - wear == st["corrupted_bits"]
    _assert_rebuild(jm, tm, tw)


def test_hard_stuck_remaps_to_spare_columns():
    (jp, jm, jw), (tp, tm, tw) = _setup(dict(spare_cols=2))
    assert _storm(jm, tm, 9, stuck_rate=1e-3)["new_stuck_cells"] > 0
    jr, tr = jm.scrub_until_clean(), tm.scrub_until_clean()
    _assert_same(jm, tm, jr, tr)
    assert tr.remaps > 0 and int((tm.tensors["t0"].col_map >= COLS).sum()) == tr.remaps
    _assert_rebuild(jm, tm, tw)


def test_repair_far_cheaper_than_full_reprogram():
    (jp, jm, jw), (tp, tm, tw) = _setup()
    _storm(jm, tm, 7, corrupt_rate=2e-3, stuck_rate=2e-4)
    jr, tr = jm.scrub_until_clean(), tm.scrub_until_clean()
    _assert_same(jm, tm, jr, tr)
    full = tm.transitions_full_affected()
    assert tr.detections > 0 and full > 0 and tr.repair_transitions <= 0.5 * full


def test_transient_flips_classified_not_repaired():
    """The transient stream is the reference's (``default_rng((seed, ctr))``
    over the whole tensor): the same tiles are classified transient."""
    (jp, jm, _), (tp, tm, _) = _setup(dict(transient_rate=2e-3, scrub_tiles=16))
    before = tm.tensors["t0"].stored.clone()
    jr, tr = jm.scrub_until_clean(max_rounds=50), tm.scrub_until_clean(max_rounds=50)
    _assert_same(jm, tm, jr, tr)
    assert jm._read_ctr == tm._read_ctr
    assert tr.transients > 0 and tr.rewrites == tr.remaps == tr.repair_transitions == 0
    assert torch.equal(tm.tensors["t0"].stored, before)


def _plant(mgrs, cols, bit=0x80):
    """Hard stuck-at-1 faults in section 0, byte 0 of ``cols``, each in
    conflict with the stored 0 (the reference test's edits)."""
    for m in mgrs:
        rec = m.tensors["t0"]
        torch_rec = isinstance(rec.stored, torch.Tensor)
        for c in cols:
            rec.stuck1[0, 0, c] |= bit
            for arr in (rec.expected, rec.reference, rec.stored):
                arr[0, 0, c] &= 0xFF ^ bit
        if torch_rec:
            rec.checksums[0] = integrity.tile_checksums(rec.expected[0:1], m.cfg.tile_bytes)[0]
            if rec.parity is not None:
                rec.parity[0] = integrity._xor_cols(rec.expected[0])
        else:
            rec.checksums[0] = jint.tile_checksums(rec.expected[0:1], m.cfg.tile_bytes)[0]
            if rec.parity is not None:
                rec.parity[0] = np.bitwise_xor.reduce(rec.expected[0], axis=1)


def test_tolerate_cols_leaves_lsb_fault_unrepaired():
    (jp, jm, _), (tp, tm, _) = _setup(dict(spare_cols=1, tolerate_cols=1))
    for m in (jm, tm):
        m.tensors["t0"].stuck1[0, 0, 0] |= 0x80
    jr, tr = jm.scrub_until_clean(), tm.scrub_until_clean()
    _assert_same(jm, tm, jr, tr)
    assert tr.tolerated >= 1 and tr.remaps == 0 and tr.repair_transitions == 0
    assert tm.verify_all() and tm.clean


def test_spare_exhaustion_migrates_section():
    (jp, jm, jw), (tp, tm, tw) = _setup(dict(spare_cols=1))
    _plant((jm, tm), (1, 2, 3))
    jr, tr = jm.scrub_until_clean(), tm.scrub_until_clean()
    _assert_same(jm, tm, jr, tr)
    assert tr.migrations >= 1 and not bool(tm.tensors["t0"].spare_used[0].any())
    assert tm.verify_all() and tm.clean
    _assert_rebuild(jm, tm, tw)


def test_repair_budget_defers_and_prioritizes_significance():
    """C.3: with ``repair_budget=1`` the round's first repair action (the
    MSB-side column 2, whose remap onto a zero spare costs 0 transitions:
    the column is all zeros once bit 0x80 is cleared) proceeds, and the
    second (column 0, 19 transitions) waits for the next round.  The
    reference lets both through (remaps = 2, pending = 0), because its
    guarantee holds while the round has spent 0 transitions."""
    _, (tp, tm, _) = _setup(dict(spare_cols=4, repair_budget=1))
    _plant((tm,), (0, 2))
    rec = tm.tensors["t0"]
    rep1 = tm.scrub_round()
    assert rep1.remaps == 1 and rep1.repair_transitions == 0
    assert rep1.pending > 0 and tm.pending_faults() > 0
    assert int(rec.col_map[0, 2]) >= COLS  # MSB-side fault repaired first
    assert int(rec.col_map[0, 0]) == 0  # LSB-side fault deferred past the budget
    rep2 = tm.scrub_round()
    assert rep2.remaps == 1 and rep2.repair_transitions == 19 and int(rec.col_map[0, 0]) >= COLS
    tm.scrub_until_clean()
    assert tm.pending_faults() == 0 and tm.verify_all() and tm.clean


def test_repair_budget_matches_reference_when_the_first_action_costs():
    """Where the first action of a round costs transitions the two
    guarantees agree: storms under a small budget give the reference's
    counters and state round by round."""
    (jp, jm, jw), (tp, tm, tw) = _setup(dict(repair_budget=4, scrub_tiles=8))
    _storm(jm, tm, 7, corrupt_rate=5e-3)
    for _ in range(6):
        _assert_same(jm, tm, jm.scrub_round(), tm.scrub_round())
    _assert_same(jm, tm, jm.scrub_until_clean(), tm.scrub_until_clean())
    _assert_rebuild(jm, tm, tw)


@pytest.mark.parametrize("codec", ["col_perm", "col_perm_rle", "const_rle"])
def test_registration_with_preexisting_faults_and_codec(codec):
    """Pool faults present at program time are the contract; under a codec
    the stored layout round-trips through repair to the reference's bytes."""
    (jp, jm, jw), (tp, tm, tw) = _setup(
        dict(spare_cols=2), pcfg_kw=dict(p_stuck=0.5, codec=codec),
        fault_kw=dict(stuck0=0.01, stuck1=0.01))
    assert (tm.tensors["t0"].col_order is not None) == codec.startswith("col_perm")
    assert tm.verify_all()
    jr, tr = jm.scrub_until_clean(), tm.scrub_until_clean()
    assert tr.detections == 0
    _assert_same(jm, tm, jr, tr)
    _storm(jm, tm, 3, corrupt_rate=5e-3, stuck_rate=1e-3)
    jr, tr = jm.scrub_until_clean(), tm.scrub_until_clean()
    _assert_same(jm, tm, jr, tr)
    assert tm.verify_all() and tm.clean
    _assert_rebuild(jm, tm, tw)


def test_rebuild_plan_and_missing_aux():
    """``rebuild_plan`` swaps the repaired weights into a plan; a tensor
    registered without the planner's closure cannot be rebuilt."""
    ts = planner.CrossbarSpec(128, 10)
    tp = pool.CrossbarPool(ts, 16, device="cpu")
    tm = tp.enable_integrity(integrity.IntegrityConfig())
    params = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal((64, 96))
                                    .astype(np.float32))}
    plan = planner.build_deployment(params, ts, planner.PlannerConfig(p_stuck=0.5, min_size=64),
                                    pool=tp, device="cpu")
    tm.storm(prng.PRNGKey(1), corrupt_rate=1e-2)
    stormed = tm.rebuild_plan(plan)
    assert stormed.deployed["w"].numpy().tobytes() != plan.deployed["w"].numpy().tobytes()
    tm.scrub_until_clean()
    repaired = tm.rebuild_plan(plan)
    assert repaired.deployed["w"].numpy().tobytes() == plan.deployed["w"].numpy().tobytes()
    packed = torch.zeros((2, 16, 10), dtype=torch.uint8)
    tp.program(packed, [np.array([0, 1])], name="bare")
    with pytest.raises(ValueError, match="no reconstruction aux"):
        tm.rebuild("bare")


def test_many_tensors_round_robin_matches_reference():
    """Three tensors through one pool: the cursor crosses tensors inside a
    round, and every counter and state stays the reference's."""
    rng = np.random.default_rng(4)
    params = {f"w{i}": (rng.standard_normal(shape) * 0.05).astype(np.float32)
              for i, shape in enumerate([(64, 70), (48, 128), (96, 40)])}
    js, ts = jplanner.CrossbarSpec(rows=ROWS, cols=COLS), planner.CrossbarSpec(rows=ROWS, cols=COLS)
    jp = jpool.CrossbarPool(js, 8, leveling="lpt")
    tp = pool.CrossbarPool(ts, 8, leveling="lpt", device="cpu")
    jm = jp.enable_integrity(jint.IntegrityConfig(scrub_tiles=7, spare_cols=1))
    tm = tp.enable_integrity(integrity.IntegrityConfig(scrub_tiles=7, spare_cols=1))
    kw = dict(p_stuck=0.5, crossbars=8, min_size=64)
    jplan = jplanner.build_deployment({k: jnp.asarray(v) for k, v in params.items()}, js,
                                      jplanner.PlannerConfig(**kw), pool=jp)
    tplan = planner.build_deployment({k: torch.from_numpy(v) for k, v in params.items()}, ts,
                                     planner.PlannerConfig(**kw), pool=tp, device="cpu")
    assert list(jm.tensors) == list(tm.tensors) and len(tm.tensors) == 3
    _storm(jm, tm, 11, corrupt_rate=1e-2, stuck_rate=2e-3)
    for _ in range(8):
        _assert_same(jm, tm, jm.scrub_round(), tm.scrub_round())
    _assert_same(jm, tm, jm.scrub_until_clean(), tm.scrub_until_clean())
    jd, td = jm.rebuild_plan(jplan).deployed, tm.rebuild_plan(tplan).deployed
    for name in params:
        assert np.asarray(jd[name]).tobytes() == td[name].numpy().tobytes()
        assert td[name].numpy().tobytes() == tplan.deployed[name].numpy().tobytes()
