"""The port's tensor parallelism against the JAX package's, on the CPU.

* the sharding rule table: ``_resolve`` over every leaf name and shape of
  the reference's reduced ``api.init`` trees (all ten configs) at model axis
  sizes 1, 2, 4 and 16 (and with FSDP over a data axis), ``param_specs``,
  ``data_spec``, ``cache_pspec``;
* ``plan_tp`` and its reasons on the port's configs and, under hypothesis,
  on random head / KV / d_ff / head_dim combinations (the fallback law);
* ``shard_operands`` byte for byte for packed (raw, const_rle, col_perm,
  col_perm_rle, with fault fields) and int8 dicts on both axes, with the
  misaligned-K rejection; ``shard_params`` concatenating back;
* ``tp_generate`` tokens equal to the reference's (``vmap``) and to the
  solo generate at n = 1, 2, 4, dense and packed, greedy and sampled;
* ``build_sharded_deployment``'s reports, ``w_hat`` bytes, owners and wear
  equal to the reference's, and the wear conservation law;
* ``ShardedScrub``'s budget split and summed backlog, and a storm on two
  shard pools scrubbed under an ``Engine(tp=2)``.
"""
from __future__ import annotations

import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.configs import get_arch as jget
from repro.configs import list_archs as jlist
from repro.core import planner as jplanner
from repro.core import pool as jpool
from repro.core import simulator as jsim
from repro.models import api as japi
from repro.parallel import sharding as jsh
from repro.parallel import tp as jtp
from repro_torch import prng, tree
from repro_torch.configs import get_arch
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planner, simulator
from repro_torch.core.integrity import IntegrityConfig
from repro_torch.core.pool import CrossbarPool
from repro_torch.launch import engine as teng
from repro_torch.launch import mesh, serve
from repro_torch.parallel import sharding, tp

DENSE = ("gemma-2b", "yi-6b", "internlm2-1.8b", "phi3-medium-14b")
PLAN = dict(p_stuck=0.5, min_size=1024)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(x):
    return from_numpy_tree(jax.tree.map(np.asarray, x), device="cpu")


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_shapes():
    """(name, shape) of every leaf of the reference's reduced init trees."""
    out = {}
    for arch in jlist():
        cfg = jget(arch, reduced=True)
        shapes = jax.eval_shape(lambda c=cfg: japi.init(jax.random.PRNGKey(0), c))
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        out[arch] = [(jsh._path_name(p), tuple(leaf.shape)) for p, leaf in flat]
    return out


@pytest.mark.parametrize("n", [1, 2, 4, 16])
def test_resolve_matches_reference_on_every_config(ref_shapes, n):
    assert len(ref_shapes) == 10
    for sizes, fsdp in (({"model": n}, False), ({"data": 2, "model": n}, True)):
        for arch, leaves in ref_shapes.items():
            for name, shape in leaves:
                want = tuple(jsh._resolve(name, shape, sizes, fsdp=fsdp, fsdp_min=2**10))
                got = sharding._resolve(name, shape, sizes, fsdp=fsdp, fsdp_min=2**10)
                assert got == want, (arch, name, shape, sizes)


def test_param_specs_and_activation_specs_match_reference():
    # specs read shapes only: zero trees of the reference's init shapes
    shapes = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), jget("yi-6b", reduced=True)))
    jparams = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = _to_torch(jparams)
    fake = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 devices=np.empty((2, 2, 4)))
    want = jax.tree.map(tuple, jsh.param_pspecs(jparams, fake, fsdp=True),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = sharding.param_specs(params, fake, fsdp=True)
    want_flat = {jsh._path_name(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, tuple))[0]}

    def walk(t, prefix=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, prefix + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from walk(v, prefix + (i,))
        else:
            yield tree.path_name(prefix), t

    assert dict(walk(got)) == want_flat
    assert sharding.batch_axes(fake) == jsh.batch_axes(fake)
    sizes = {"pod": 2, "data": 2, "model": 4}
    for b, nd in ((8, 3), (6, 2), (1, 4)):
        assert sharding.data_spec(fake, b, nd) == tuple(jsh.data_spec(fake, b, nd))
    for shape in ((2, 8, 4, 64, 16), (2, 1, 4, 64, 16), (4, 16, 8), (3, 5)):
        assert sharding.cache_pspec(fake, shape, sizes) == tuple(
            jsh.cache_pspec(fake, shape, sizes))
    assert sharding.axis_sizes_of({"model": 4}) == {"model": 4}


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _same_plan(a, b) -> bool:
    return (a.n, a.axis, a.attn, a.mlp, dict(a.rules), dict(a.reasons)) == (
        b.n, b.axis, b.attn, b.mlp, dict(b.rules), dict(b.reasons))


@pytest.mark.parametrize("arch", DENSE)
def test_plan_tp_matches_reference(arch):
    for reduced in (True, False):
        jcfg, cfg = jget(arch, reduced=reduced), get_arch(arch, reduced=reduced)
        for n in range(1, 17):
            for packed in (False, True):
                plan = tp.plan_tp(cfg, n, packed=packed)
                assert _same_plan(plan, jtp.plan_tp(jcfg, n, packed=packed)), (arch, n)
                loc, jloc = tp.local_config(cfg, plan), jtp.local_config(jcfg, plan)
                for f in ("n_heads", "n_kv_heads", "d_ff", "head_dim", "tp_axis", "tp_attn",
                          "tp_mlp"):
                    assert getattr(loc, f) == getattr(jloc, f), f


def test_yi_full_width_shards_both_components_at_4():
    """The smoke run's cell: yi-6b at n = 4 shards attention (8 q / 1 KV
    head) and the MLP (K slices 1024 and 2752 byte-aligned); gemma-2b's MQA
    attention replicates at 2."""
    plan = tp.plan_tp(get_arch("yi-6b"), 4, packed=True)
    assert plan.attn and plan.mlp
    loc = tp.local_config(get_arch("yi-6b"), plan)
    assert (loc.n_heads, loc.n_kv_heads, loc.d_ff, loc.head_dim) == (8, 1, 2752, 128)
    g = tp.plan_tp(get_arch("gemma-2b"), 2, packed=True)
    assert not g.attn and g.mlp and g.reasons["attn"] == "n_kv_heads 1 % 2 != 0"


@given(
    n_heads=st.sampled_from([1, 2, 3, 4, 6, 8]),
    kv_div=st.sampled_from([1, 2, 4]),
    head_dim=st.sampled_from([1, 4, 8, 16]),
    d_ff=st.sampled_from([24, 32, 48, 64, 120, 128]),
    n=st.integers(min_value=1, max_value=5),
    packed=st.booleans(),
)
def test_plan_tp_fallback_law(n_heads, kv_div, head_dim, d_ff, n, packed):
    """Any head / KV / ff combination plans as the reference's does; sharded
    components divide exactly, replicated ones record why."""
    if n_heads % kv_div:
        kv_div = 1
    kw = dict(n_heads=n_heads, n_kv_heads=n_heads // kv_div, head_dim=head_dim, d_ff=d_ff)
    cfg = dataclasses.replace(get_arch("internlm2-1.8b", reduced=True), **kw)
    jcfg = dataclasses.replace(jget("internlm2-1.8b", reduced=True), **kw)
    plan = tp.plan_tp(cfg, n, packed=packed)
    assert _same_plan(plan, jtp.plan_tp(jcfg, n, packed=packed))
    loc = tp.local_config(cfg, plan)
    if plan.attn:
        assert loc.n_heads * n == n_heads and loc.n_kv_heads * n == cfg.n_kv_heads
        if packed:
            assert (loc.n_heads * head_dim) % 8 == 0
    elif n > 1:
        assert "attn" in plan.reasons
    if plan.mlp:
        assert loc.d_ff * n == d_ff and (not packed or loc.d_ff % 8 == 0)
    elif n > 1:
        assert "mlp" in plan.reasons


# ---------------------------------------------------------------------------
# operand slicing
# ---------------------------------------------------------------------------

def _operands(k: int, n_cols: int, materialize: str, codec: str, faults: bool, seed: int):
    """One reference operand dict and its port copy (same bytes)."""
    w = np.random.default_rng(seed).normal(size=(k, n_cols)).astype(np.float32) * 0.05
    scale = float(np.abs(w).max()) / 15
    q = np.clip(np.round(np.abs(w) / scale), 0, 15)
    w_hat = (np.where(np.signbit(w), -q, q) * scale).astype(np.float32)
    op = jsim.operands_from_dense(jnp.asarray(w_hat), scale, 0.0, "sign_magnitude", 4,
                                  materialize=materialize, codec=codec)
    op = dict(op)
    if faults:
        rng = np.random.default_rng(seed + 1)
        if materialize == "packed":
            shp = op["planes_packed"].shape
            op["stuck0_packed"] = jnp.asarray(rng.integers(0, 256, shp, dtype=np.uint8) & 0x11)
            op["stuck1_packed"] = jnp.asarray(rng.integers(0, 256, shp, dtype=np.uint8) & 0x02)
        op["plane_gain"] = jnp.asarray(rng.uniform(0.9, 1.1, (4, n_cols)).astype(np.float32))
        op["row_atten"] = jnp.asarray(rng.uniform(0.95, 1.0, (k,)).astype(np.float32))
    return op, _to_torch(op)


CASES = [("packed", c, f) for c in ("raw", "const_rle", "col_perm", "col_perm_rle")
         for f in (False, True)] + [("planes_int8", "raw", False), ("planes_int8", "raw", True)]


@pytest.mark.parametrize("materialize,codec,faults", CASES)
def test_shard_operands_bytes_match_reference(materialize, codec, faults):
    k, n_cols = 512, 24
    jop, op = _operands(k, n_cols, materialize, codec, faults, seed=len(codec) + faults)
    dense = None
    if materialize == "packed":
        dense = simulator.densify_operands(op)
    for axis in (-1, -2):
        for n in (1, 2, 4):
            for i in range(n):
                got = simulator.shard_operands(op, axis=axis, index=i, n=n)
                want = jsim.shard_operands(jop, axis=axis, index=i, n=n)
                assert sorted(got) == sorted(want)
                for name in got:
                    w = np.asarray(want[name])
                    if name == "plane_gain" and axis == -1 and n > 1:
                        # C.9: the reference passes an N shard the full-width gains
                        step = n_cols // n
                        w = w[..., i * step:(i + 1) * step]
                    assert np.array_equal(got[name].numpy(), w), (name, axis, n, i)
                if dense is not None:
                    size = (n_cols if axis == -1 else k) // n
                    want_d = dense.narrow(axis, i * size, size)
                    assert torch.equal(simulator.densify_operands(got), want_d)


def test_shard_operands_rejects_misaligned_k_slice():
    _, op = _operands(16, 4, "packed", "raw", False, seed=0)
    with pytest.raises(ValueError, match="byte"):
        simulator.shard_operands(op, axis=-2, index=0, n=4)
    with pytest.raises(ValueError):
        simulator.shard_operands(op, axis=-1, index=2, n=2)
    with pytest.raises(ValueError):
        simulator.shard_operands(op, axis=-1, index=0, n=3)
    with pytest.raises(ValueError):
        simulator.shard_operands(op, axis=0, index=0, n=1)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_params_concatenate_back_and_stack(n):
    """Concatenating every shard on its rule axis gives the leaf back;
    replicated leaves are the same tensors; ``shard_stack`` holds the shards
    on the axis after the layer axis and replicated leaves once."""
    cfg = get_arch("internlm2-1.8b", reduced=True)
    params = _to_torch(japi.init(jax.random.PRNGKey(1), jget("internlm2-1.8b", reduced=True)))
    plan = tp.plan_tp(cfg, n)
    shards = [tp.shard_params(params, plan, i) for i in range(n)]
    stacked = tp.shard_stack(params, plan)
    by_name = [dict((tree.path_name(p), x) for p, x in tree.leaves_with_path(s))
               for s in shards]
    st_flat = dict((tree.path_name(p), x) for p, x in tree.leaves_with_path(stacked))
    for path, leaf in tree.leaves_with_path(params):
        name = tree.path_name(path)
        ax = tp._leaf_rule(name, plan)
        pieces = [s[name] for s in by_name]
        if ax is None or n == 1:
            assert all(p is leaf for p in pieces)
            assert st_flat[name] is leaf or n == 1
        else:
            assert torch.equal(torch.cat(pieces, dim=ax), leaf)
            assert torch.equal(st_flat[name], torch.stack(pieces, dim=1))
    with pytest.raises(ValueError):
        tp.shard_params(params, plan, n)


def test_replica_submeshes_rules():
    groups = mesh.replica_submeshes(3, 1, device="cpu")
    assert groups == [[torch.device("cpu")]] * 3
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        groups = mesh.replica_submeshes(2, 2, device="cpu")
    assert groups == [[torch.device("cpu")] * 2] * 2 and any("emulated" in str(x.message)
                                                             for x in w)
    assert mesh.replica_devices(2, device="cpu") == [torch.device("cpu")] * 2
    for bad in ((0, 1), (1, 0)):
        with pytest.raises(ValueError):
            mesh.replica_submeshes(*bad, device="cpu")


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def yi():
    """Reduced yi-6b (4 heads, 2 KV heads, d_ff 160: attention and MLP shard
    at 2, the MLP alone at 4): fp and packed trees on both sides."""
    jcfg, cfg = jget("yi-6b", reduced=True), get_arch("yi-6b", reduced=True)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    p = _to_torch(jp)
    jplan = jplanner.build_deployment(jp, jplanner.CrossbarSpec(), jplanner.PlannerConfig(**PLAN))
    tplan = planner.build_deployment(p, planner.CrossbarSpec(), planner.PlannerConfig(**PLAN),
                                     device="cpu")
    trees = {"fp": (jp, p),
             "packed": (jplanner.deploy_params(jp, jplan, materialize="packed"),
                        planner.deploy_params(p, tplan, materialize="packed"))}
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    return jcfg, cfg, trees, tokens


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("mat", ["fp", "packed"])
def test_tp_generate_matches_reference_and_solo(yi, n, mat):
    jcfg, cfg, trees, tokens = yi
    jp, p = trees[mat]
    for greedy in (True, False):
        want, _ = jtp.tp_generate(jcfg, jp, {"tokens": jnp.asarray(tokens)}, n=n, gen_len=8,
                                  greedy=greedy, seed=5)
        got, _ = tp.tp_generate(cfg, p, {"tokens": torch.from_numpy(tokens)}, n=n, gen_len=8,
                                greedy=greedy, seed=5)
        solo, _ = serve.generate(cfg, p, {"tokens": torch.from_numpy(tokens)}, gen_len=8,
                                 greedy=greedy, seed=5)
        assert np.array_equal(got.numpy(), np.asarray(want)), (n, mat, greedy)
        assert torch.equal(got, solo)
        loop, _ = tp.tp_generate(cfg, p, {"tokens": torch.from_numpy(tokens)}, n=n, gen_len=8,
                                 greedy=greedy, seed=5, loop="python")
        assert torch.equal(loop, got)


def test_tp_prefill_logits_within_tolerance_of_solo(yi):
    """The gate's sum reassociates the row-parallel matmuls: f32 logits stay
    within 1e-5 of the solo forward's."""
    _, cfg, trees, tokens = yi
    _, p = trees["fp"]
    batch = {"tokens": torch.from_numpy(tokens)}
    solo, _ = serve.make_prefill_step(cfg)(p, batch)
    for n in (2, 4):
        plan = tp.plan_tp(cfg, n)
        step = tp.tp_step(serve.make_prefill_step(tp.local_config(cfg, plan)))
        logits, caches = step(tp.prepare_tp_params(p, plan), batch)
        assert (logits - solo).abs().max() <= 1e-5 * solo.abs().max()
        if plan.attn:  # prompt caches carry the shard axis after the layer axis
            assert caches[0]["k"].shape[:2] == (cfg.n_layers, n)


# ---------------------------------------------------------------------------
# sharded deployments and scrub
# ---------------------------------------------------------------------------

class _Pristine(CrossbarPool):
    """Per-tensor pristine accounting: content reset before every program."""

    def program(self, *args, **kwargs):
        self.reset()
        return super().program(*args, **kwargs)


class _JPristine(jpool.CrossbarPool):
    def program(self, *args, **kwargs):
        self.reset()
        return super().program(*args, **kwargs)


@pytest.fixture(scope="module")
def gemma():
    jcfg = jget("gemma-2b", reduced=True)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    return jp, _to_torch(jp)


@pytest.mark.parametrize("pristine", [False, True])
def test_build_sharded_deployment_matches_reference(gemma, pristine):
    jp, p = gemma
    spec, cfg = planner.CrossbarSpec(), planner.PlannerConfig(**PLAN)
    jspec, jcfg = jplanner.CrossbarSpec(), jplanner.PlannerConfig(**PLAN)
    jpools = [(_JPristine if pristine else jpool.CrossbarPool)(jspec, jcfg.crossbars)
              for _ in range(2)]
    pools = [(_Pristine if pristine else CrossbarPool)(spec, cfg.crossbars, device="cpu")
             for _ in range(2)]
    jplan, jpools, jowner = jtp.build_sharded_deployment(jp, jspec, jcfg, 2, pools=jpools)
    plan, pools, owner = tp.build_sharded_deployment(p, spec, cfg, 2, pools=pools)
    assert owner == jowner and set(owner.values()) == {0, 1}
    for name, rep in plan.reports.items():
        jrep = jplan.reports[name]
        for f in dataclasses.fields(rep):
            got, want = getattr(rep, f.name), getattr(jrep, f.name)
            if f.name == "quant_mse":  # a float mean (the port's planner tests' rule)
                assert got == pytest.approx(float(want), rel=1e-6), name
            else:
                assert got == (tuple(want) if f.name == "shape" else want), (name, f.name)
        assert np.array_equal(plan.deployed[name].numpy(), np.asarray(jplan.deployed[name]))
    for a, b in zip(pools, jpools):
        assert np.array_equal(a.wear, np.asarray(b.wear))
    if pristine:  # conservation: partitioning storage loses no writes
        solo = _Pristine(spec, cfg.crossbars, device="cpu")
        ref = planner.build_deployment(p, spec, cfg, pool=solo, device="cpu")
        assert sum(int(q.wear.sum()) for q in pools) == int(solo.wear.sum())
        assert sum(q.tensors_seen for q in pools) == solo.tensors_seen == len(owner)
        for name in ref.deployed:
            assert torch.equal(plan.deployed[name], ref.deployed[name])


def test_sharded_scrub_splits_budget_and_sums_backlog():
    class _Fake:
        def __init__(self):
            self.budgets = []

        def pending_faults(self):
            return 1

        def scrub_round(self, budget_tiles=None):
            self.budgets.append(budget_tiles)
            return dataclasses.make_dataclass(
                "R", ["pending"], namespace={"merge": lambda self, other: None})(pending=2)

    mgrs = [_Fake() for _ in range(3)]
    scrub = tp.ShardedScrub(mgrs)
    rep = scrub.scrub_round(budget_tiles=9)
    assert all(m.budgets == [3] for m in mgrs)
    assert rep.pending == 6
    assert scrub.pending_faults() == 3
    scrub.scrub_round()
    assert all(m.budgets == [3, None] for m in mgrs)
    with pytest.raises(ValueError):
        tp.ShardedScrub([])


def test_sharded_scrub_storm_repaired_under_tp_engine(gemma):
    """A storm on both shard pools, scrubbed by ``ShardedScrub`` between the
    dispatches of an ``Engine(tp=2)``: detected, repaired, refreshed, and the
    tokens after it are the clean deployment's."""
    _, p = gemma
    cfg = get_arch("gemma-2b", reduced=True)
    spec, pcfg = planner.CrossbarSpec(), planner.PlannerConfig(**PLAN)
    pools = [CrossbarPool(spec, pcfg.crossbars, leveling="lpt", device="cpu") for _ in range(2)]
    mgrs = [q.enable_integrity(IntegrityConfig(spare_cols=2, scrub_tiles=1_000_000))
            for q in pools]
    plan, pools, _ = tp.build_sharded_deployment(p, spec, pcfg, 2, pools=pools)
    clean = planner.deploy_params(p, plan, materialize="dense")
    scrub = tp.ShardedScrub(mgrs)
    ecfg = teng.EngineConfig(max_slots=2, page_size=8, max_seq_len=64, prefill_chunk=8,
                             decode_quantum=4)
    eng = teng.Engine(cfg, clean, ecfg, tp=2)
    eng.attach_scrub(scrub, refresh=lambda: planner.deploy_params(
        p, scrub.rebuild_plan(plan), materialize="dense"))
    mgrs[0].storm(prng.PRNGKey(11), corrupt_rate=2e-3, stuck_rate=2e-4)
    mgrs[1].storm(prng.PRNGKey(12), corrupt_rate=2e-3, stuck_rate=2e-4)
    assert scrub.pending_faults() == 0
    assert eng.hot_swap(planner.deploy_params(p, scrub.rebuild_plan(plan), materialize="dense"))
    rng = np.random.default_rng(3)
    reqs = [teng.Request(rid=i, prompt=rng.integers(0, 256, pl).astype(np.int32),
                         max_new_tokens=g) for i, (pl, g) in enumerate([(11, 5), (7, 6)])]
    eng.run(reqs)
    s = eng.stats
    assert s["scrub_rounds"] > 0 and s["scrub_detections"] > 0 and s["scrub_repairs"] > 0
    assert s["scrub_refreshes"] >= 1
    assert scrub.verify_all() and scrub.pending_faults() == 0
    post = teng.Request(rid=10, prompt=rng.integers(0, 256, 9).astype(np.int32),
                        max_new_tokens=6)
    res = eng.run([post])[0]
    solo, _ = serve.generate(cfg, clean, {"tokens": torch.from_numpy(post.prompt)[None]},
                             gen_len=6)
    assert res.tokens == solo[0].tolist()
