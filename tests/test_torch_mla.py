"""MLA and deepseek-v2-236b on the port against the JAX package, on the CPU.

Reduced float32 deepseek-v2-236b with params from the reference's
``api.init`` converted through ``convert.from_numpy_tree``, inputs from a
numpy seed, one module-scoped build of both packages' params and plans
(``min_size`` 512, so every MLA matrix, the router and the expert stacks
are planned) and of the reference's jitted functions.

Tolerances: ``_project_q`` / ``_project_kv_latent`` within 1e-6 (two
float32 matmuls and an rmsnorm summed in another order, values O(1));
``mla_attention_fwd`` (output and latent cache), ``mla_attention_step``
and forward logits within 2e-5 absolute + relative (the attention and the
MoE MLP add float32 sums in another order); decode (absorbed) equals
forward (expanded) within the reference's own 2e-4 at
``capacity_factor=8.0``; the train step's loss within 1e-6, its grad norm
and updated params within 1e-5; plan reports and ``w_hat`` bytes
identical; served greedy token streams identical; dense against packed
forward within 2e-4 (the reference's ``test_cim_packed`` bound).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.core import planner as jplanner
from repro.launch import engine as jengine
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import mla as jmla
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.parallel import tp as jtp
from repro_torch import prng, tree
from repro_torch.configs import MLAConfig, get_arch, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planner
from repro_torch.launch import engine as teng
from repro_torch.launch import serve, steps
from repro_torch.models import api, mla
from repro_torch.models.transformer import supports_paged
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import tp

ARCH = "deepseek-v2-236b"
TOL = 2e-5
PROJ_TOL = 1e-6
PLAN = dict(p_stuck=0.5, min_size=512)
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
    """Both packages' reduced deepseek-v2-236b: configs, params, plans, a
    prompt, and the reference's one jitted forward."""
    jcfg, cfg = jget(ARCH, reduced=True), get_arch(ARCH, reduced=True)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    jplan = jplanner.build_deployment(jparams, jplanner.CrossbarSpec(),
                                      jplanner.PlannerConfig(**PLAN))
    tplan = planner.build_deployment(tparams, planner.CrossbarSpec(),
                                     planner.PlannerConfig(**PLAN), device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    jforward = jax.jit(lambda p, t: japi.forward(p, jcfg, {"tokens": t}))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, tparams=tparams, jplan=jplan, tplan=tplan,
                tokens=tokens, jforward=jforward)


def _layer0_mla(params, torch_tree: bool):
    seg = params["segments"][0]["mla"]
    if torch_tree:
        return {k: v[0] if isinstance(v, torch.Tensor) else {kk: vv[0] for kk, vv in v.items()}
                for k, v in seg.items()}
    return jax.tree.map(lambda a: a[0], seg)


def _x(cfg, s=12, seed=5):
    return np.random.default_rng(seed).standard_normal((2, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    ours, want = get_arch(ARCH, reduced=reduced), jget(ARCH, reduced=reduced)
    for f in dataclasses.fields(ArchConfig):
        if f.name not in ("moe", "mla"):
            assert getattr(ours, f.name) == getattr(want, f.name), f.name
    assert dataclasses.asdict(ours.moe) == dataclasses.asdict(want.moe)
    assert dataclasses.asdict(ours.mla) == dataclasses.asdict(want.mla)
    assert [f.name for f in dataclasses.fields(MLAConfig)] == [
        f.name for f in dataclasses.fields(type(want.mla))]
    assert ARCH in list_archs()
    if not reduced:
        m = ours.mla
        assert (ours.d_model, ours.n_heads, ours.n_layers, ours.vocab_size) == (5120, 128, 60,
                                                                               102400)
        assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
                m.v_head_dim) == (1536, 512, 128, 64, 128)
        assert (ours.moe.n_routed, ours.moe.n_shared, ours.moe.top_k, ours.moe.d_expert) == (
            160, 2, 6, 1536)
        assert not ours.tie_embeddings and ours.block_pattern == (("mla_moe", 1),)


def test_init_matches_reference_bit_for_bit(ref):
    mine = api.init(prng.PRNGKey(0), ref["cfg"], device="cpu")
    got, want = list(tree.leaves_with_path(mine)), list(tree.leaves_with_path(ref["tparams"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b), path
    assert {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo"} == set(
        mine["segments"][0]["mla"])


@pytest.mark.parametrize("offset", [0, 7])
def test_projections_match_reference(ref, offset):
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    x = _x(cfg)
    pos = np.arange(offset, offset + x.shape[1])
    jp, tp_ = _layer0_mla(ref["jparams"], False), _layer0_mla(ref["tparams"], True)
    jq, jkv = jax.jit(lambda p, x_, pos_: (jmla._project_q(p, jcfg, x_, pos_),
                                           jmla._project_kv_latent(p, jcfg, x_, pos_)))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    tq = mla._project_q(tp_, cfg, _t(x), _t(pos))
    tkv = mla._project_kv_latent(tp_, cfg, _t(x), _t(pos))
    for got, want in zip((*tq, *tkv), (*jq, *jkv)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PROJ_TOL, atol=PROJ_TOL)


def test_attention_fwd_and_step_match_reference(ref):
    """The expanded prefill (output and latent cache) and one absorbed
    decode step at position 12 of a 16-long cache holding the prefill."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    x = _x(cfg)
    jp, tp_ = _layer0_mla(ref["jparams"], False), _layer0_mla(ref["tparams"], True)
    jy, jc = jax.jit(lambda p, x_: jmla.mla_attention_fwd(p, jcfg, x_, return_cache=True))(
        jp, jnp.asarray(x))
    ty, tc = mla.mla_attention_fwd(tp_, cfg, _t(x), return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=TOL, atol=TOL)

    s = x.shape[1]
    jcache = jmla.init_mla_cache(jcfg, 2, s + 4, jnp.float32)
    jcache = {k: jcache[k].at[:, :s].set(jc[k]) for k in jcache}
    tcache = mla.init_mla_cache(cfg, 2, s + 4, torch.float32, "cpu")
    for k in tcache:
        tcache[k][:, :s] = _t(np.asarray(jc[k]))
    xs = _x(cfg, s=1, seed=6)
    jy, jcache = jax.jit(lambda p, x_, c: jmla.mla_attention_step(p, jcfg, x_, c, jnp.int32(s)))(
        jp, jnp.asarray(xs), jcache)
    ty = mla.mla_attention_step(tp_, cfg, _t(xs), tcache, torch.tensor(s))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    for k in tcache:  # written in place at position s
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="one position"):
        mla.mla_attention_step(tp_, cfg, _t(xs), tcache, torch.tensor([s, s]))


def test_forward_matches_reference(ref):
    jl, jaux = ref["jforward"](ref["jparams"], jnp.asarray(ref["tokens"]))
    tl, taux = api.forward(ref["tparams"], ref["cfg"], {"tokens": _t(ref["tokens"]).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)


def test_decode_matches_forward_and_cache_matches_reference(ref):
    """prefill + merge + absorbed decode steps reproduce the expanded
    forward's logits (the reference's test_models invariant, at its
    capacity_factor 8.0), and the merged latent cache equals the
    reference's: c_kv (count, B, S, r) and k_rope (count, B, S, dr) are
    written at [..., :S, :] like K/V."""
    cfg = dataclasses.replace(ref["cfg"], moe=dataclasses.replace(ref["cfg"].moe,
                                                                capacity_factor=8.0))
    jcfg = dataclasses.replace(ref["jcfg"], moe=dataclasses.replace(ref["jcfg"].moe,
                                                                  capacity_factor=8.0))
    params, b, prompt, gen = ref["tparams"], 2, 12, 4
    tok_np = np.random.default_rng(6).integers(0, cfg.vocab_size, (b, prompt + gen))
    tokens = _t(tok_np).long()
    full, _ = api.forward(params, cfg, {"tokens": tokens})
    logits, pf = api.prefill(params, cfg, {"tokens": tokens[:, :prompt]})
    cache = api.merge_prefill_cache(cfg, api.init_cache(cfg, b, prompt + gen, device="cpu"), pf)
    assert set(cache[0]) == {"c_kv", "k_rope"}
    m = cfg.mla
    assert tuple(cache[0]["c_kv"].shape) == (cfg.n_layers, b, prompt + gen, m.kv_lora_rank)
    assert tuple(cache[0]["k_rope"].shape) == (cfg.n_layers, b, prompt + gen,
                                               m.qk_rope_head_dim)
    _, jpf = japi.prefill(ref["jparams"], jcfg, {"tokens": jnp.asarray(tok_np[:, :prompt],
                                                                       jnp.int32)})
    jcache = japi.merge_prefill_cache(jcfg, japi.init_cache(jcfg, b, prompt + gen), jpf)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[0][k].numpy(), np.asarray(jcache[0][k]), rtol=TOL,
                                   atol=TOL)
        assert not cache[0][k][:, :, prompt:].any()
    np.testing.assert_allclose(logits[:, -1].numpy(), full[:, prompt - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    for i in range(gen):
        logits, cache = api.decode_step(params, cfg, cache, tokens[:, prompt + i:prompt + i + 1],
                                        torch.tensor(prompt + i))
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, prompt + i].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_plans_match_reference(ref):
    """Both planners plan the same tensors (every MLA matrix, the router,
    the expert stacks and the head) with identical reports and w_hat bytes."""
    jplan, tplan = ref["jplan"], ref["tplan"]
    assert sorted(tplan.reports) == sorted(jplan.reports)
    want = {f"segments/0/mla/{w}" for w in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo")}
    want |= {f"segments/0/moe/{w}" for w in ("router", "wi_gate", "wi_up", "wo")}
    assert want | {"head/w"} <= set(tplan.reports)
    for name, jr in jplan.reports.items():
        tr = dataclasses.asdict(tplan.reports[name])
        for field, w in dataclasses.asdict(jr).items():
            if field == "quant_mse":
                np.testing.assert_allclose(tr[field], w, rtol=1e-6)
            else:
                assert tuple(tr[field]) == tuple(w) if field == "shape" else tr[field] == w
        assert tplan.deployed[name].numpy().tobytes() == np.asarray(
            jplan.deployed[name]).tobytes(), name


def test_absorbed_weights_stay_dense(ref):
    """wk_b / wv_b are served as their dense w_hat under every
    materialization; the other MLA matrices become operand dicts."""
    for mat in ("packed", "planes_int8"):
        p = planner.deploy_params(ref["tparams"], ref["tplan"], materialize=mat)["segments"][0]
        for w in ("wk_b", "wv_b"):
            assert torch.equal(p["mla"][w], ref["tplan"].deployed[f"segments/0/mla/{w}"])
        assert all(isinstance(p["mla"][w], dict) for w in ("wq_a", "wq_b", "wkv_a", "wo"))


def _reference_tokens(ref, materialize):
    """The reference's greedy tokens (gen 5) of one materialization, once a
    module.  On the CPU the reference serves packed operands, raw or
    codec-encoded, as the dense w_hat they decode to (``_serving_params``,
    ``src/repro/launch/steps.py:53``), so its packed and const_rle tokens
    are its dense ones; int8 planes run its per-step simulation."""
    cache = ref.setdefault("jtokens", {})
    if materialize not in cache:
        jparams = ref["jparams"]
        if materialize != "fp":
            jparams = jplanner.deploy_params(jparams, ref["jplan"], materialize=materialize)
        cache[materialize] = np.asarray(jserve.generate(
            ref["jcfg"], jparams, {"tokens": jnp.asarray(ref["tokens"])}, gen_len=5)[0])
    return cache[materialize]


@pytest.mark.parametrize("materialize,codec", VARIANTS)
def test_generate_tokens_match_reference(ref, materialize, codec):
    tparams = ref["tparams"]
    if materialize != "fp":
        tparams = planner.deploy_params(tparams, ref["tplan"], materialize=materialize,
                                        codec=codec)
    tt, _ = serve.generate(ref["cfg"], tparams, {"tokens": _t(ref["tokens"]).long()}, gen_len=5)
    want = _reference_tokens(ref, "dense" if materialize == "packed" else materialize)
    np.testing.assert_array_equal(tt.numpy(), want)


def test_dense_and_packed_forward_agree(ref):
    """The packed operands' forward equals the dense w_hat forward within
    the reference's 2e-4 (``tests/test_cim_packed.py``'s bound)."""
    batch = {"tokens": _t(ref["tokens"]).long()}
    logits = {}
    for mat in ("dense", "packed"):
        p = steps.prepare_serving_params(
            planner.deploy_params(ref["tparams"], ref["tplan"], materialize=mat))
        logits[mat], _ = api.forward(p, ref["cfg"], batch)
    np.testing.assert_allclose(logits["packed"].numpy(), logits["dense"].numpy(), rtol=2e-4,
                               atol=2e-4)


def test_serving_params_cast_mla_once(ref):
    """prepare_serving_params in bf16 casts the MLA matmul weights (wk_b /
    wv_b included) once and leaves its norm gains and the router in f32."""
    layer = steps.prepare_serving_params(ref["tparams"], torch.bfloat16)["segments"][0]
    for w in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo"):
        assert layer["mla"][w].dtype == torch.bfloat16, w
    for g in ("q_norm", "kv_norm"):
        assert layer["mla"][g]["g"].dtype == torch.float32
        assert layer["mla"][g]["g"] is ref["tparams"]["segments"][0]["mla"][g]["g"]
    assert layer["moe"]["router"].dtype == torch.float32
    assert layer["ln1"]["g"].dtype == torch.float32


def test_param_counts_match_reference(ref):
    """param_count equal; active_param_count equal to the reference's on
    the layer-unstacked tree; MLA's wo is never counted as routed."""
    jparams, tparams, cfg = ref["jparams"], ref["tparams"], ref["cfg"]
    assert api.param_count(tparams) == japi.param_count(jparams)
    unstacked = dict(jparams, segments=[jax.tree.map(lambda a, i=i: a[i], seg)
                                        for seg in jparams["segments"]
                                        for i in range(cfg.n_layers)])
    want = japi.active_param_count(unstacked, ref["jcfg"])
    assert api.active_param_count(tparams, cfg) == want
    routed = sum(tparams["segments"][0]["moe"][k].numel() for k in ("wi_gate", "wi_up", "wo"))
    m = cfg.moe
    assert want == api.param_count(tparams) - routed + int(routed * m.top_k / m.n_alloc)


def test_train_step_matches_reference(ref):
    """One make_train_step step (loss_fn with the routers' aux loss,
    blockwise attention, AdamW) against the reference's."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig()))
    jp, _, jm = jstep(ref["jparams"], jadamw_init(ref["jparams"]), {"tokens": jnp.asarray(toks)})
    tstep = steps.make_train_step(cfg, AdamWConfig())
    tp_, _, tm = tstep(ref["tparams"], adamw_init(ref["tparams"]), {"tokens": _t(toks).long()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5,
                               atol=1e-5)
    want = dict(tree.leaves_with_path(from_numpy_tree(jax.tree.map(np.asarray, jp),
                                                      device="cpu")))
    for path, leaf in tree.leaves_with_path(tp_):
        np.testing.assert_allclose(leaf.numpy(), want[path].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=str(path))


def test_engine_refuses_mla_as_the_reference_does(ref):
    assert supports_paged(ref["cfg"]) is False
    assert japi.supports_paged(ref["jcfg"]) is False
    with pytest.raises(NotImplementedError):
        jengine.Engine(ref["jcfg"], ref["jparams"])
    with pytest.raises(NotImplementedError, match="pure-attention"):
        teng.Engine(ref["cfg"], ref["tparams"])


@pytest.mark.parametrize("packed", [False, True])
def test_tp_plan_replicates_as_the_reference_does(packed):
    """mla_moe has no TP reduction gates: both packages replicate every
    component, for the same reason."""
    for n in (1, 2, 4):
        for reduced in (True, False):
            want = jtp.plan_tp(jget(ARCH, reduced=reduced), n, packed=packed)
            got = tp.plan_tp(get_arch(ARCH, reduced=reduced), n, packed=packed)
            assert (got.n, got.attn, got.mlp) == (want.n, want.attn, want.mlp) == (n, False,
                                                                                   False)
            assert dict(got.reasons) == dict(want.reasons)
            assert "no TP reduction gates" in got.reasons["attn"]


def test_tp_generate_replicates_mla(ref):
    batch = {"tokens": _t(ref["tokens"]).long()}
    solo, _ = serve.generate(ref["cfg"], ref["tparams"], batch, gen_len=4)
    got, _ = tp.tp_generate(ref["cfg"], ref["tparams"], batch, n=2, gen_len=4)
    assert torch.equal(got, solo)


def test_serve_cli_serves_deepseek(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
                "6", "--gen", "3", "--cim", "--materialize", "packed", "--min-size", "512"])
    out = capsys.readouterr().out
    assert "token agreement" in out and "packed" in out
