"""The MoE family (qwen2-moe-a2.7b) on the port against the JAX package, on the CPU.

Reduced float32 qwen2-moe-a2.7b with params from the reference's
``api.init`` converted through ``convert.from_numpy_tree``, inputs from a
numpy seed, one module-scoped build of both packages' params and plans
(``min_size`` 1024, so the router and the expert stacks are planned).

Tolerances: routing weights ``topw`` and the aux loss within 1e-6
(float32 softmax, exp and mean in another order); ``topi`` and the
assignment ranks identical, ties included (a stable descending sort, as
``jax.lax.top_k`` keeps the lower index first); ``moe_mlp`` and forward
logits within 2e-5 absolute + relative (float32 matmuls summed in another
order, reduced-model values O(1)); decode equals forward within the
reference's own 2e-4 at ``capacity_factor=8.0``; plan reports and ``w_hat``
bytes identical; served greedy token streams identical; the grouped plain
CIM matmuls equal G single calls bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import planner as jplanner
from repro.launch import engine as jengine
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.parallel import tp as jtp
from repro_torch import prng, tree
from repro_torch.configs import MoEConfig, get_arch, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planes, planner, simulator
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.launch import engine as teng
from repro_torch.launch import serve, steps
from repro_torch.models import api, layers, moe
from repro_torch.models.transformer import supports_paged
from repro_torch.parallel import tp

ARCH = "qwen2-moe-a2.7b"
TOL = 2e-5
ROUTE_TOL = 1e-6
PLAN = dict(p_stuck=0.5, min_size=1024)
VARIANTS = (("fp", "raw"), ("dense", "raw"), ("packed", "raw"), ("packed", "const_rle"),
            ("planes_int8", "raw"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def ref():
    """Both packages' reduced qwen2-moe-a2.7b: configs, params, plans, prompt."""
    jcfg, cfg = jget(ARCH, reduced=True), get_arch(ARCH, reduced=True)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    jplan = jplanner.build_deployment(jparams, jplanner.CrossbarSpec(),
                                      jplanner.PlannerConfig(**PLAN))
    tplan = planner.build_deployment(tparams, planner.CrossbarSpec(),
                                     planner.PlannerConfig(**PLAN), device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, tparams=tparams, jplan=jplan, tplan=tplan,
                tokens=tokens)


def _layer0(tree_):
    """Layer 0 of segment 0's MoE MLP params."""
    return jax.tree.map(lambda a: a[0], tree_["segments"][0]["moe"])


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    ours, want = get_arch(ARCH, reduced=reduced), jget(ARCH, reduced=reduced)
    for f in dataclasses.fields(ArchConfig):
        if f.name != "moe":
            assert getattr(ours, f.name) == getattr(want, f.name), f.name
    assert dataclasses.asdict(ours.moe) == dataclasses.asdict(want.moe)
    assert ours.moe.n_alloc == want.moe.n_alloc
    assert [f.name for f in dataclasses.fields(MoEConfig)] == [
        f.name for f in dataclasses.fields(type(want.moe))]
    assert ARCH in list_archs()
    if not reduced:
        assert (ours.moe.n_routed, ours.moe.n_alloc, ours.moe.top_k) == (60, 64, 4)


def test_init_matches_reference_bit_for_bit(ref):
    mine = api.init(prng.PRNGKey(0), ref["cfg"], device="cpu")
    got, want = list(tree.leaves_with_path(mine)), list(tree.leaves_with_path(ref["tparams"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b), path


def _route_case(case):
    """(d, e, k, xf, router): random, or a router with duplicated columns
    (equal logits, so top-k must break ties by the lower index)."""
    rng = np.random.default_rng(3)
    d, e, k = (64, 8, 2) if case != "qwen_k" else (32, 60, 4)
    xf = rng.standard_normal((40, d)).astype(np.float32)
    w = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    if case == "ties":
        w[:, 5] = w[:, 2]
        w[:, 7] = w[:, 0]
        w[:, 3] = w[:, 1]
        xf[:5] = 0.0  # every probability equal
    return d, e, k, xf, w


@pytest.mark.parametrize("case", ["random", "ties", "qwen_k"])
def test_route_matches_reference(case):
    d, e, k, xf, w = _route_case(case)
    m = MoEConfig(n_routed=e, n_shared=0, top_k=k, d_expert=8)
    jm = JMoEConfig(n_routed=e, n_shared=0, top_k=k, d_expert=8)
    jw, ji, ja = jmoe._route({"router": jnp.asarray(w)}, jm, jnp.asarray(xf), e)
    tw, ti, ta = moe._route({"router": _t(w)}, m, _t(xf), e)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=ROUTE_TOL, atol=ROUTE_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=ROUTE_TOL, atol=ROUTE_TOL)
    if case == "ties":
        # all-equal rows pick the lowest experts, in order
        np.testing.assert_array_equal(ti.numpy()[:5], np.tile(np.arange(k), (5, 1)))


@pytest.mark.parametrize("skew", [0.0, 0.9])
def test_assignment_ranks_match_reference(skew):
    """Ranks identical; with 90% of the assignments sent to expert 3 the
    capacity of 8 overflows and the dropped ones are the late arrivals."""
    rng = np.random.default_rng(4)
    e, n, cap = 8, 96, 8
    flat_e = rng.integers(0, e, n)
    flat_e[rng.random(n) < skew] = 3
    want = np.asarray(jmoe._assignment_ranks(jnp.asarray(flat_e, jnp.int32), e))
    got = moe._assignment_ranks(torch.from_numpy(flat_e), e).numpy()
    np.testing.assert_array_equal(got, want)
    if skew:
        keep = got < cap
        assert not keep.all()
        late = np.flatnonzero(flat_e == 3)[cap:]
        assert not keep[late].any() and keep[np.flatnonzero(flat_e == 3)[:cap]].all()


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_mlp_matches_reference(ref, cf):
    """One layer's MoE MLP on the reference's weights: at the config's
    capacity and at a quarter of it (tokens dropped on overflow)."""
    jcfg = dataclasses.replace(ref["jcfg"], moe=dataclasses.replace(ref["jcfg"].moe,
                                                                  capacity_factor=cf))
    cfg = dataclasses.replace(ref["cfg"], moe=dataclasses.replace(ref["cfg"].moe,
                                                                capacity_factor=cf))
    x = np.random.default_rng(5).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_mlp(_layer0(ref["jparams"]), jcfg, jnp.asarray(x))
    p0 = {k: v[0] if isinstance(v, torch.Tensor) else {kk: vv[0] for kk, vv in v.items()}
          for k, v in ref["tparams"]["segments"][0]["moe"].items()}
    ty, taux = moe.moe_mlp(p0, cfg, _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=ROUTE_TOL, atol=ROUTE_TOL)


def test_forward_matches_reference(ref):
    jl, jaux = japi.forward(ref["jparams"], ref["jcfg"], {"tokens": jnp.asarray(ref["tokens"])})
    tl, taux = api.forward(ref["tparams"], ref["cfg"], {"tokens": _t(ref["tokens"]).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=ROUTE_TOL, atol=ROUTE_TOL)


def test_decode_matches_forward(ref):
    """prefill + decode steps reproduce forward's logits (the reference's
    test_models invariant, at its capacity_factor 8.0: no drops)."""
    cfg = dataclasses.replace(ref["cfg"], moe=dataclasses.replace(ref["cfg"].moe,
                                                                capacity_factor=8.0))
    params, b, prompt, gen = ref["tparams"], 2, 12, 4
    tokens = _t(np.random.default_rng(6).integers(0, cfg.vocab_size, (b, prompt + gen))).long()
    full, _ = api.forward(params, cfg, {"tokens": tokens})
    logits, pf = api.prefill(params, cfg, {"tokens": tokens[:, :prompt]})
    cache = api.merge_prefill_cache(cfg, api.init_cache(cfg, b, prompt + gen, device="cpu"), pf)
    np.testing.assert_allclose(logits[:, -1].numpy(), full[:, prompt - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    for i in range(gen):
        logits, cache = api.decode_step(params, cfg, cache, tokens[:, prompt + i:prompt + i + 1],
                                        prompt + i)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, prompt + i].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_plans_match_reference(ref):
    """Both planners plan the same tensors (the [L, d, E] router and the
    [L, E, d, de] expert stacks as one tensor each) with identical reports
    and w_hat bytes."""
    jplan, tplan = ref["jplan"], ref["tplan"]
    assert sorted(tplan.reports) == sorted(jplan.reports)
    assert {"segments/0/moe/router", "segments/0/moe/wi_gate", "segments/0/moe/wo",
            "segments/0/moe/shared/wi_up"} <= set(tplan.reports)
    for name, jr in jplan.reports.items():
        tr = dataclasses.asdict(tplan.reports[name])
        for field, want in dataclasses.asdict(jr).items():
            if field == "quant_mse":
                np.testing.assert_allclose(tr[field], want, rtol=1e-6)
            else:
                assert tuple(tr[field]) == tuple(want) if field == "shape" else tr[field] == want
        assert tplan.deployed[name].numpy().tobytes() == np.asarray(
            jplan.deployed[name]).tobytes(), name


def test_expert_operands_lead_with_the_expert_axis(ref):
    """Per layer slice, the expert stacks' operand dicts are 4-D (experts
    first), with per-expert const_rle tile flags."""
    p = planner.deploy_params(ref["tparams"], ref["tplan"], materialize="packed",
                              codec="const_rle")
    op = p["segments"][0]["moe"]["wi_gate"]
    e, d, de = ref["cfg"].moe.n_alloc, ref["cfg"].d_model, ref["cfg"].moe.d_expert
    assert tuple(op["planes_packed"].shape) == (2, e, 10, d // 8, de)
    assert tuple(op["plane_tile_nz"].shape) == (2, e, 10, -(-d // 128))
    assert tuple(op["scale"].shape) == (2, e)
    i8 = planner.deploy_params(ref["tparams"], ref["tplan"], materialize="planes_int8")
    assert tuple(i8["segments"][0]["moe"]["wo"]["splanes"].shape) == (2, e, 10, de, d)


@pytest.mark.parametrize("materialize,codec", VARIANTS)
def test_generate_tokens_match_reference(ref, materialize, codec):
    jparams, tparams = ref["jparams"], ref["tparams"]
    if materialize != "fp":
        jparams = jplanner.deploy_params(jparams, ref["jplan"], materialize=materialize,
                                         codec=codec)
        tparams = planner.deploy_params(tparams, ref["tplan"], materialize=materialize,
                                        codec=codec)
    jt, _ = jserve.generate(ref["jcfg"], jparams, {"tokens": jnp.asarray(ref["tokens"])},
                            gen_len=5)
    tt, _ = serve.generate(ref["cfg"], tparams, {"tokens": _t(ref["tokens"]).long()}, gen_len=5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_serving_params_cast_experts_once(ref):
    """prepare_serving_params in bf16 casts the dense expert stacks and the
    shared GLU once and leaves the router (an f32 matmul) and operand dicts
    as they are."""
    moe_p = steps.prepare_serving_params(ref["tparams"], torch.bfloat16)["segments"][0]["moe"]
    assert all(moe_p[k].dtype == torch.bfloat16 for k in ("wi_gate", "wi_up", "wo"))
    assert all(v.dtype == torch.bfloat16 for v in moe_p["shared"].values())
    assert moe_p["router"].dtype == torch.float32
    packed = planner.deploy_params(ref["tparams"], ref["tplan"], materialize="planes_int8")
    got = steps.prepare_serving_params(packed, torch.bfloat16)["segments"][0]["moe"]["wi_gate"]
    assert got["splanes"] is packed["segments"][0]["moe"]["wi_gate"]["splanes"]


def test_param_counts_match_reference(ref):
    """param_count equal; active_param_count equal to the reference's on
    the layer-unstacked tree, where its rank-3 rule finds the expert stacks
    (on the stacked tree it counts other leaves: ROADMAP C.10)."""
    jparams, tparams, cfg = ref["jparams"], ref["tparams"], ref["cfg"]
    assert api.param_count(tparams) == japi.param_count(jparams)
    unstacked = dict(jparams, segments=[jax.tree.map(lambda a, i=i: a[i], seg)
                                        for seg in jparams["segments"]
                                        for i in range(cfg.n_layers)])
    assert japi.param_count(unstacked) == japi.param_count(jparams)
    want = japi.active_param_count(unstacked, ref["jcfg"])
    assert api.active_param_count(tparams, cfg) == want
    assert want != japi.active_param_count(jparams, ref["jcfg"])
    routed = sum(v.numel() for k, v in tparams["segments"][0]["moe"].items()
                 if k in ("wi_gate", "wi_up", "wo"))
    m = cfg.moe
    assert want == api.param_count(tparams) - routed + int(routed * m.top_k / m.n_alloc)
    assert api.active_param_count(tparams, get_arch("yi-6b", reduced=True)) == \
        api.param_count(tparams)


def _grouped_packed(g_, k, n, seed, offset=0.0, codec="const_rle"):
    rng = np.random.default_rng(seed)
    q = _t(rng.integers(0, 1024, (g_, k, n)).astype(np.int32))
    s = _t(np.where(rng.random((g_, k, n)) < 0.5, -1, 1).astype(np.int8))
    scale = torch.linspace(1e-4, 3e-4, g_)
    op = simulator.packed_operands(q, s, scale, torch.full((g_,), offset), 10)
    return planes.encode_operands(op, codec), rng


@pytest.mark.parametrize("codec", ["raw", "const_rle", "col_perm"])
def test_grouped_plain_packed_equals_single_calls(codec):
    """The grouped plain version (the CPU side of B2/B4's grouped launch),
    with plane ids and gains, equals G single calls bit for bit."""
    op, rng = _grouped_packed(5, 200, 36, 8, codec=codec)
    x = _t(rng.standard_normal((5, 7, 200)).astype(np.float32))
    gain = _t(rng.uniform(0.9, 1.1, (5, 10, 36)).astype(np.float32))
    for pg in (None, gain):
        args = (op["planes_packed"], op["sign_packed"], op["scale"])
        ids = op.get("plane_ids")
        got = cim_ops.cim_matmul_packed(x, *args, tile_nz=op.get("plane_tile_nz"),
                                        plane_ids=ids, plane_gain=pg)
        want = torch.stack([cim_ops.cim_matmul_packed(
            x[i], *(a[i] for a in args), plane_ids=None if ids is None else ids[i],
            plane_gain=None if pg is None else pg[i]) for i in range(5)])
        assert got.shape == (5, 7, 36) and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["fused_dequant", "planes"])
def test_grouped_plain_planes_equals_single_calls(mode):
    rng = np.random.default_rng(9)
    q = _t(rng.integers(0, 1024, (4, 150, 20)).astype(np.int32))
    s = _t(np.where(rng.random((4, 150, 20)) < 0.5, -1, 1).astype(np.int8))
    op = simulator.int8_plane_operands(q, s, torch.linspace(1e-4, 2e-4, 4), 0.0, 10)
    x = _t(rng.standard_normal((4, 3, 150)).astype(np.float32))
    got = cim_ops.cim_matmul(x, op["splanes"], op["scale"], mode=mode)
    want = torch.stack([cim_ops.cim_matmul(x[i], op["splanes"][i], op["scale"][i], mode=mode)
                        for i in range(4)])
    assert torch.equal(got, want)


def test_cim_linear_groups_with_per_group_offset():
    """cim_linear on grouped operands (an offset per group, as offset_binary
    gives) and layers.linear on an [E, C, K] activation: each group equal
    to its own single call bit for bit."""
    op, rng = _grouped_packed(3, 64, 24, 10, offset=-0.01)
    op["offset"] = torch.tensor([-0.01, 0.0, 0.02])
    x = _t(rng.standard_normal((3, 5, 64)).astype(np.float32))
    got = simulator.cim_linear(x, op)
    for i in range(3):
        one = {k: v[i] for k, v in op.items()}
        assert torch.equal(got[i], simulator.cim_linear(x[i], one))
    y = layers.linear(op, x.reshape(3, 5, 1, 64), torch.float32)
    assert y.shape == (3, 5, 1, 24) and torch.equal(y.reshape(3, 5, 24), got)


def test_sharded_dispatch_is_not_ported(ref):
    """The sharded dispatch is ported now (``tests/test_torch_moe_sharded.py``
    holds it to the reference): on the reference's weights a 1 x 1 host
    mesh gives the unsharded ``moe_mlp`` bit for bit, a (data 2, model 2)
    mesh routes each half of the batch with its own capacity and departs
    where it binds (cf 0.25), and ``None`` restores the unsharded dispatch;
    an object that is not a mesh raises."""
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    cfg = dataclasses.replace(ref["cfg"], moe=dataclasses.replace(ref["cfg"].moe,
                                                                capacity_factor=0.25))
    x = _t(np.random.default_rng(5).standard_normal((2, 24, cfg.d_model)).astype(np.float32))
    p0 = tree.tree_map(lambda v: v[0], ref["tparams"]["segments"][0]["moe"])
    want, want_aux = moe.moe_mlp(p0, cfg, x)
    halves = [moe.moe_mlp(p0, cfg, x[i:i + 1])[0] for i in range(2)]
    try:
        moe.set_moe_distribution(make_host_mesh())
        got, got_aux = moe.moe_mlp(p0, cfg, x)
        assert torch.equal(got, want) and torch.equal(got_aux, want_aux)
        moe.set_moe_distribution(make_mesh((2, 2), ("data", "model")))
        got, got_aux = moe.moe_mlp(p0, cfg, x)
        assert float((got - want).abs().max()) > 1e-3
        np.testing.assert_allclose(got.numpy(), torch.cat(halves).numpy(),
                                   rtol=TOL, atol=TOL)
        with pytest.raises(AttributeError):
            moe.set_moe_distribution(object())
    finally:
        moe.set_moe_distribution(None)
    assert torch.equal(moe.moe_mlp(p0, cfg, x)[0], want)


def test_engine_refuses_moe_as_the_reference_does(ref):
    assert supports_paged(ref["cfg"]) is False
    assert japi.supports_paged(ref["jcfg"]) is False
    with pytest.raises(NotImplementedError):
        jengine.Engine(ref["jcfg"], ref["jparams"])
    with pytest.raises(NotImplementedError, match="pure-attention"):
        teng.Engine(ref["cfg"], ref["tparams"])


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("packed", [False, True])
def test_tp_plan_matches_reference(n, packed):
    """A MoE config has no TP reduction gates: both packages replicate
    every component, for the same reason."""
    for reduced in (True, False):
        want = jtp.plan_tp(jget(ARCH, reduced=reduced), n, packed=packed)
        got = tp.plan_tp(get_arch(ARCH, reduced=reduced), n, packed=packed)
        assert (got.n, got.attn, got.mlp) == (want.n, want.attn, want.mlp) == (n, False, False)
        assert dict(got.reasons) == dict(want.reasons) and dict(got.rules) == dict(want.rules)
        assert tp.local_config(get_arch(ARCH, reduced=reduced), got).tp_axis is None


def test_tp_generate_replicates_moe(ref):
    """tp_generate at n = 2 on the replicated plan serves the solo tokens
    (the reference's contract), which equal the reference's."""
    batch = {"tokens": _t(ref["tokens"]).long()}
    solo, _ = serve.generate(ref["cfg"], ref["tparams"], batch, gen_len=4)
    got, _ = tp.tp_generate(ref["cfg"], ref["tparams"], batch, n=2, gen_len=4)
    assert torch.equal(got, solo)


def test_serve_cli_serves_moe(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
                "6", "--gen", "3", "--cim", "--materialize", "packed", "--codec", "const_rle",
                "--min-size", "1024"])
    out = capsys.readouterr().out
    assert "token agreement" in out and "packed" in out
