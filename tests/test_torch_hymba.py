"""hymba-1.5b on the port against the JAX package, on the CPU.

Reduced float32 hymba-1.5b (window 16, 8 meta tokens) with params from the
reference's ``api.init`` converted through ``convert.from_numpy_tree``,
inputs from a numpy seed, one module-scoped build of both packages' params
and plans (``min_size`` 512 and 256) and of the reference's jitted
functions.

Tolerances: ``causal_conv`` / ``causal_conv_step`` and
``_mamba_scan_chunked`` within 1e-6 absolute + relative (the same products
and sums, the scan's inside a chunk associated in order where the
reference's associative scan pairs them); ``mamba_fwd`` / ``mamba_step``,
``hymba_block_fwd``, forward logits, decode and ``banded_swa_attention``
within 2e-5 (float32 matmuls and attention sums in another order); the
train step's loss within 1e-6 and its grad norm within 1e-5; plan reports
and ``w_hat`` bytes identical; served greedy token streams identical.
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
from repro.models import attention as jattn
from repro.models import hybrid as jhybrid
from repro.models import ssm as jssm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.parallel import tp as jtp
from repro_torch import prng, tree
from repro_torch.configs import SSMConfig, get_arch, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planner
from repro_torch.launch import engine as teng
from repro_torch.launch import serve, steps
from repro_torch.models import api, attention, hybrid, ssm
from repro_torch.models.transformer import segments_of, supports_paged
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import tp

ARCH = "hymba-1.5b"
TOL = 2e-5
SCAN_TOL = 1e-6
PLANS = (512, 256)
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


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def ref():
    """Both packages' reduced hymba-1.5b: configs, params, plans at each
    ``min_size`` of PLANS, a prompt, and the reference's jitted forward."""
    jcfg, cfg = jget(ARCH, reduced=True), get_arch(ARCH, reduced=True)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    jplans, tplans = {}, {}
    for m in PLANS:
        pc = dict(p_stuck=0.5, min_size=m)
        jplans[m] = jplanner.build_deployment(jparams, jplanner.CrossbarSpec(),
                                              jplanner.PlannerConfig(**pc))
        tplans[m] = planner.build_deployment(tparams, planner.CrossbarSpec(),
                                             planner.PlannerConfig(**pc), device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    jforward = jax.jit(lambda p, t: japi.forward(p, jcfg, {"tokens": t}))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, tparams=tparams, jplans=jplans,
                tplans=tplans, tokens=tokens, jforward=jforward)


def _layer(params, seg: int, torch_tree: bool):
    """Layer 0 of segment ``seg`` (unstacked)."""
    if torch_tree:
        from repro_torch.models.transformer import layer_slice
        return layer_slice(params["segments"][seg], 0)
    return jax.tree.map(lambda a: a[0], params["segments"][seg])


def _x(cfg, s, seed=5, width=None):
    return np.random.default_rng(seed).standard_normal(
        (2, s, width or cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    ours, want = get_arch(ARCH, reduced=reduced), jget(ARCH, reduced=reduced)
    for f in dataclasses.fields(ArchConfig):
        if f.name != "ssm":
            assert getattr(ours, f.name) == getattr(want, f.name), f.name
    assert dataclasses.asdict(ours.ssm) == dataclasses.asdict(want.ssm)
    assert [f.name for f in dataclasses.fields(SSMConfig)] == [
        f.name for f in dataclasses.fields(type(want.ssm))]
    assert ARCH in list_archs()
    kinds = [k for k, _ in segments_of(ours)]
    assert set(kinds) == {"hymba_global", "hymba_swa"}
    if not reduced:
        assert (ours.d_model, ours.n_heads, ours.n_kv_heads, ours.head_dim, ours.d_ff,
                ours.vocab_size, ours.n_layers) == (1600, 25, 5, 64, 5504, 32001, 32)
        assert (ours.attn_window, ours.n_meta_tokens, ours.ssm.chunk_size) == (1024, 128, 16)
        cut = dataclasses.replace(ours, n_layers=4)
        assert cut.layer_kinds() == ["hymba_global", "hymba_swa", "hymba_swa", "hymba_swa"]


def test_init_matches_reference_bit_for_bit(ref):
    mine = api.init(prng.PRNGKey(0), ref["cfg"], device="cpu")
    got, want = list(tree.leaves_with_path(mine)), list(tree.leaves_with_path(ref["tparams"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32)), path
    assert "meta" in mine and {"dt_bias", "a_log", "d_skip", "conv"} <= set(
        mine["segments"][1]["mamba"])


def test_init_deterministic_leaves_at_full_width():
    """dt_bias and a_log at hymba's d_inner 3200 and N 16: XLA:CPU's
    linspace / exp / log bytes."""
    full = get_arch(ARCH)
    di, n = full.ssm.expand * full.d_model, full.ssm.state_size
    want_dt = np.asarray(jnp.log(jnp.exp(jnp.linspace(1e-3, 1e-1, di)) - 1.0)
                         .astype(jnp.float32))
    want_a = np.asarray(jnp.log(jnp.tile(jnp.arange(1, n + 1, dtype=jnp.float32), (di, 1))))
    dt_bias, a_log = ssm.mamba_constants(full, "cpu")
    assert dt_bias.shape == (di,) and a_log.shape == (di, n)
    assert dt_bias.numpy().tobytes() == want_dt.tobytes()
    assert a_log.numpy().tobytes() == want_a.tobytes()


def test_conv_matches_reference(ref):
    cfg = ref["cfg"]
    di = cfg.ssm.expand * cfg.d_model
    jp = _layer(ref["jparams"], 0, False)["mamba"]["conv"]
    tp_ = _layer(ref["tparams"], 0, True)["mamba"]["conv"]
    x = _x(cfg, 11, width=di)
    _close(ssm.causal_conv(tp_, _t(x)), jax.jit(jssm.causal_conv)(jp, jnp.asarray(x)), SCAN_TOL)
    state, x1 = x[:, :3], x[:, 3:4]
    jst, jy = jax.jit(jssm.causal_conv_step)(jp, jnp.asarray(state), jnp.asarray(x1))
    tst, ty = ssm.causal_conv_step(tp_, _t(state), _t(x1))
    _close(ty, jy, SCAN_TOL)
    _close(tst, jst, SCAN_TOL)


@pytest.mark.parametrize("s", [13, 16])
def test_scan_matches_reference(s):
    """The chunked selective scan at an S that is (16) and is not (13) a
    multiple of the chunk, from a nonzero state."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 6, 4)).astype(np.float32)
    bx = rng.standard_normal((2, s, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    jhs, jh = jax.jit(lambda a_, b_, h_: jssm._mamba_scan_chunked(a_, b_, h_, 8))(
        jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    ths, th = ssm._mamba_scan_chunked(_t(a), _t(bx), _t(h0), 8)
    assert tuple(ths.shape) == (2, s, 6, 4)
    _close(ths, jhs, SCAN_TOL)
    _close(th, jh, SCAN_TOL)


def test_mamba_fwd_and_step_match_reference(ref):
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    jp = _layer(ref["jparams"], 1, False)["mamba"]
    tp_ = _layer(ref["tparams"], 1, True)["mamba"]
    x = _x(cfg, 13)
    jy, jc = jax.jit(lambda p, x_: jssm.mamba_fwd(p, jcfg, x_, return_cache=True))(
        jp, jnp.asarray(x))
    ty, tc = ssm.mamba_fwd(tp_, cfg, _t(x), return_cache=True)
    _close(ty, jy)
    for k in ("state", "conv"):
        _close(tc[k], jc[k])
    x1 = _x(cfg, 1, seed=6)
    jy, jc2 = jax.jit(lambda p, x_, c: jssm.mamba_step(p, jcfg, x_, c))(jp, jnp.asarray(x1), jc)
    ty = ssm.mamba_step(tp_, cfg, _t(x1), tc)  # the cache is written in place
    _close(ty, jy)
    for k in ("state", "conv"):
        _close(tc[k], jc2[k])


@pytest.mark.parametrize("kind,s", [("swa", 12), ("swa", 21), ("causal", 12), ("causal", 21)])
def test_hymba_block_fwd_matches_reference(ref, kind, s):
    """Both kinds below (12) and past (21) the window of 16: the output and
    the prompt cache (the swa kind's ring rolled so slot pos % 16 holds pos)."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    seg = 1 if kind == "swa" else 0
    jp, tp_ = _layer(ref["jparams"], seg, False), _layer(ref["tparams"], seg, True)
    window = cfg.attn_window if kind == "swa" else None
    x = _x(cfg, s)
    jy, jc = jax.jit(lambda p, x_: jhybrid.hymba_block_fwd(
        p, jcfg, x_, kind=kind, window=window, return_cache=True))(jp, jnp.asarray(x))
    ty, tc = hybrid.hymba_block_fwd(tp_, cfg, _t(x), kind=kind, window=window,
                                    return_cache=True)
    _close(ty, jy)
    want_len = cfg.attn_window if kind == "swa" else s
    assert tc["k"].shape[2] == want_len
    for k in ("k", "v"):
        _close(tc[k], jc[k])
    for k in ("state", "conv"):
        _close(tc["ssm"][k], jc["ssm"][k])


def test_forward_matches_reference(ref):
    jl, _ = ref["jforward"](ref["jparams"], jnp.asarray(ref["tokens"]))
    tl, taux = api.forward(ref["tparams"], ref["cfg"], {"tokens": _t(ref["tokens"]).long()})
    assert tuple(tl.shape) == (2, 10, ref["cfg"].vocab_size)
    _close(tl, jl)
    assert float(taux) == 0.0


def test_decode_past_ring_wrap_matches_reference_and_forward(ref):
    """prefill (8 meta + 6 prompt) then 12 decode steps to 26 positions,
    past the window of 16: the ring wraps.  Each step's logits equal the
    reference's decode and the port's own forward over the whole sequence;
    the merged cache equals the reference's, its ring and SSM state copied
    in place."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    params, b, prompt, gen = ref["tparams"], 2, 6, 12
    assert cfg.n_meta_tokens + prompt + gen > cfg.attn_window
    tok_np = np.random.default_rng(6).integers(0, cfg.vocab_size, (b, prompt + gen))
    tok_np = tok_np.astype(np.int32)
    tokens = _t(tok_np).long()
    full, _ = api.forward(params, cfg, {"tokens": tokens})
    logits, pf = api.prefill(params, cfg, {"tokens": tokens[:, :prompt]})
    cache = api.init_cache(cfg, b, prompt + gen, device="cpu")
    held = [c["ssm"]["state"] for c in cache]
    cache = api.merge_prefill_cache(cfg, cache, pf)
    assert all(c["ssm"]["state"] is h for c, h in zip(cache, held))
    assert cache[0]["k"].shape[-2] == cfg.n_meta_tokens + prompt + gen
    assert cache[1]["k"].shape[-2] == cfg.attn_window

    jpf_logits, jpf = jax.jit(lambda p, t: japi.prefill(p, jcfg, {"tokens": t}))(
        ref["jparams"], jnp.asarray(tok_np[:, :prompt]))
    jcache = japi.merge_prefill_cache(jcfg, japi.init_cache(jcfg, b, prompt + gen), jpf)
    for got, want in zip(cache, jcache):
        for path, leaf in tree.leaves_with_path(got):
            w = want
            for k in path:
                w = w[k]
            _close(leaf, w)
    _close(logits, jpf_logits)
    _close(logits[:, -1], full[:, prompt - 1])
    jdecode = jax.jit(lambda p, c, t, pos: japi.decode_step(p, jcfg, c, t, pos))
    for i in range(gen - 1):
        tok = tok_np[:, prompt + i:prompt + i + 1]
        logits, cache = api.decode_step(params, cfg, cache, _t(tok).long(),
                                        torch.tensor(prompt + i))
        jl, jcache = jdecode(ref["jparams"], jcache, jnp.asarray(tok), jnp.int32(prompt + i))
        _close(logits, jl)
        _close(logits[:, 0], full[:, prompt + i])


@pytest.mark.parametrize("min_size", PLANS)
def test_plans_match_reference(ref, min_size):
    jplan, tplan = ref["jplans"][min_size], ref["tplans"][min_size]
    assert sorted(tplan.reports) == sorted(jplan.reports)
    for name, jr in jplan.reports.items():
        tr = dataclasses.asdict(tplan.reports[name])
        for field, w in dataclasses.asdict(jr).items():
            if field == "quant_mse":
                np.testing.assert_allclose(tr[field], w, rtol=1e-6)
            else:
                assert tuple(tr[field]) == tuple(w) if field == "shape" else tr[field] == w
        assert tplan.deployed[name].numpy().tobytes() == np.asarray(
            jplan.deployed[name]).tobytes(), name
    planned = set(tplan.reports)
    assert {"meta", "segments/0/mamba/x_proj", "segments/1/mamba/dt_proj"} <= planned
    if min_size == 256:  # C.12: the stacked 1-D leaves pass min_size
        assert {"segments/1/mamba/dt_bias", "segments/1/mamba/d_skip"} <= planned


def _reference_tokens(ref, materialize):
    """The reference's greedy tokens (gen 5) at min_size 512, once a module,
    for "fp" and "dense".  Its deployed variants serve exact re-encodings of
    its dense w_hat, and their tokens equal its dense tokens (pinned by its
    own ``tests/test_cim_packed.py``, and true here: its planes_int8 run
    gives the dense run's tokens), so the port's packed, const_rle and
    planes_int8 tokens are held to the reference's dense ones."""
    cache = ref.setdefault("jtokens", {})
    if materialize not in cache:
        jparams = ref["jparams"]
        if materialize == "dense":
            jparams = jplanner.deploy_params(jparams, ref["jplans"][512], materialize="dense")
        cache[materialize] = np.asarray(jserve.generate(
            ref["jcfg"], jparams, {"tokens": jnp.asarray(ref["tokens"])}, gen_len=5)[0])
    return cache[materialize]


@pytest.mark.parametrize("materialize,codec", VARIANTS)
def test_generate_tokens_match_reference(ref, materialize, codec):
    tparams = ref["tparams"]
    if materialize != "fp":
        tparams = planner.deploy_params(tparams, ref["tplans"][512], materialize=materialize,
                                        codec=codec)
        for w in ("conv", "a_log", "dt_bias", "d_skip"):
            assert isinstance(tparams["segments"][1]["mamba"][w], (torch.Tensor, dict))
        assert isinstance(tparams["meta"], torch.Tensor)
    tt, _ = serve.generate(ref["cfg"], tparams, {"tokens": _t(ref["tokens"]).long()}, gen_len=5)
    want = _reference_tokens(ref, "fp" if materialize == "fp" else "dense")
    np.testing.assert_array_equal(tt.numpy(), want)


def test_packed_serves_the_stacked_vectors_dense(ref):
    """ROADMAP C.12: at min_size 256 the swa segment's stacked dt_bias and
    d_skip are planned; the reference's packed forward then hands them to
    the model as operand dicts and raises, the port serves them as dense
    w_hat and its packed tokens equal its dense tokens."""
    plan = ref["tplans"][256]
    batch = {"tokens": _t(ref["tokens"]).long()}
    toks = {}
    for mat in ("dense", "packed"):
        p = planner.deploy_params(ref["tparams"], plan, materialize=mat)
        mamba = p["segments"][1]["mamba"]
        for w in ("dt_bias", "d_skip", "a_log"):
            assert isinstance(mamba[w], torch.Tensor), w
        if mat == "packed":
            assert isinstance(mamba["x_proj"], dict) and isinstance(mamba["dt_proj"], dict)
        toks[mat], _ = serve.generate(ref["cfg"], p, batch, gen_len=5)
    assert torch.equal(toks["packed"], toks["dense"])
    # the reference's packed deploy of just the two stacked vectors: they
    # become operand dicts, every other leaf stays as initialized
    jplan = ref["jplans"][256]
    vecs = ("segments/1/mamba/dt_bias", "segments/1/mamba/d_skip")
    jplan = dataclasses.replace(jplan, reports={n: jplan.reports[n] for n in vecs},
                                deployed={n: jplan.deployed[n] for n in vecs})
    jp = jplanner.deploy_params(ref["jparams"], jplan, materialize="packed")
    assert isinstance(jp["segments"][1]["mamba"]["d_skip"], dict)
    with pytest.raises(IndexError):
        japi.forward(jp, ref["jcfg"], {"tokens": jnp.asarray(ref["tokens"])})


@pytest.mark.parametrize("q_offset,block_q", [(0, 8), (5, 4)])
def test_banded_swa_matches_reference(q_offset, block_q):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 19, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 19 + q_offset, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 19 + q_offset, 16)).astype(np.float32)
    want = jattn.banded_swa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=6,
                                      q_offset=q_offset, block_q=block_q)
    got = attention.banded_swa_attention(_t(q), _t(k), _t(v), window=6, q_offset=q_offset,
                                         block_q=block_q)
    _close(got, want)
    # and the blockwise swa it stands for
    _close(got, attention.blockwise_attention(_t(q), _t(k), _t(v), kind="swa", window=6,
                                              q_offset=q_offset))
    # the dispatcher keeps swa on blockwise (B3 on the card): no switch routes it away
    assert not hasattr(attention, "set_attention_impl")
    calls = attention.blockwise_attention.calls
    attention.attention(_t(q), _t(k), _t(v), kind="swa", window=6, q_offset=q_offset)
    assert attention.blockwise_attention.calls == calls + 1


def test_train_step_matches_reference(ref):
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig()))
    _, _, jm = jstep(ref["jparams"], jadamw_init(ref["jparams"]), {"tokens": jnp.asarray(toks)})
    tstep = steps.make_train_step(cfg, AdamWConfig())
    _, _, tm = tstep(ref["tparams"], adamw_init(ref["tparams"]), {"tokens": _t(toks).long()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5,
                               atol=1e-5)


def test_serving_params_cast_mamba_once(ref):
    """prepare_serving_params in bf16 casts the Mamba projections, conv taps
    and dt_bias once and keeps a_log, d_skip, the norms and meta in f32."""
    src = ref["tparams"]
    layer = steps.prepare_serving_params(src, torch.bfloat16)["segments"][1]
    for w in ("in_proj", "x_proj", "dt_proj", "out_proj", "dt_bias"):
        assert layer["mamba"][w].dtype == torch.bfloat16, w
    assert layer["mamba"]["conv"]["w"].dtype == torch.bfloat16
    for w in ("a_log", "d_skip"):
        assert layer["mamba"][w] is src["segments"][1]["mamba"][w]
    for g in ("ln1", "norm_attn", "norm_ssm", "ln2"):
        assert layer[g]["g"].dtype == torch.float32


def test_engine_refuses_hymba_as_the_reference_does(ref):
    assert supports_paged(ref["cfg"]) is False
    assert japi.supports_paged(ref["jcfg"]) is False
    with pytest.raises(NotImplementedError):
        jengine.Engine(ref["jcfg"], ref["jparams"])
    with pytest.raises(NotImplementedError, match="pure-attention"):
        teng.Engine(ref["cfg"], ref["tparams"])


@pytest.mark.parametrize("packed", [False, True])
def test_tp_plan_replicates_hymba_as_the_reference_does(packed):
    for n in (1, 2, 4):
        for reduced in (True, False):
            want = jtp.plan_tp(jget(ARCH, reduced=reduced), n, packed=packed)
            got = tp.plan_tp(get_arch(ARCH, reduced=reduced), n, packed=packed)
            assert (got.n, got.attn, got.mlp) == (want.n, want.attn, want.mlp) == (n, False,
                                                                                   False)
            assert dict(got.reasons) == dict(want.reasons)
            assert "no TP reduction gates" in got.reasons["attn"]


def _swa_cfg():
    """Reduced yi-6b as a plain ``swa`` stack with a 4-position window."""
    return dataclasses.replace(get_arch("yi-6b", reduced=True), n_layers=2,
                               block_pattern=(("swa", 1),), attn_window=4)


@pytest.fixture(scope="module")
def swa():
    cfg = _swa_cfg()
    return cfg, api.init(prng.PRNGKey(0), cfg, device="cpu")


def test_swa_decode_keeps_its_window(swa):
    """ROADMAP C.11: the plain ``swa`` kind decodes equal to its own forward
    past the window (the reference's decode drops the window and departs
    from position 4 on)."""
    cfg, params = swa
    b, prompt, gen = 2, 3, 9
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (b, prompt + gen))).long()
    full, _ = api.forward(params, cfg, {"tokens": tokens})
    logits, pf = api.prefill(params, cfg, {"tokens": tokens[:, :prompt]})
    cache = api.merge_prefill_cache(cfg, api.init_cache(cfg, b, prompt + gen, device="cpu"), pf)
    _close(logits[:, -1], full[:, prompt - 1])
    for i in range(gen - 1):
        logits, cache = api.decode_step(params, cfg, cache, tokens[:, prompt + i:prompt + i + 1],
                                        torch.tensor(prompt + i))
        _close(logits[:, 0], full[:, prompt + i])
    # per-row positions take the same window
    rows = torch.tensor([prompt + gen - 2, prompt + gen - 2])
    c2 = api.merge_prefill_cache(cfg, api.init_cache(cfg, b, prompt + gen, device="cpu"), pf)
    for i in range(gen - 1):
        lr, c2 = api.decode_step(params, cfg, c2, tokens[:, prompt + i:prompt + i + 1],
                                 rows * 0 + prompt + i)
    _close(lr, logits)


def test_swa_engine_stream_equals_solo_generate(swa):
    """The port's engine serves a ``swa`` stack (supports_paged) with the
    window in its chunk and decode steps: each stream equals the request's
    solo generate, past the window."""
    cfg, params = swa
    assert supports_paged(cfg)
    eng = teng.Engine(cfg, params, teng.EngineConfig(max_slots=2, page_size=4, max_seq_len=24,
                                                     prefill_chunk=4, decode_quantum=3))
    reqs = [teng.Request(rid=r, prompt=np.random.default_rng(10 + r).integers(
        0, cfg.vocab_size, plen).astype(np.int32), max_new_tokens=gen)
        for r, (plen, gen) in enumerate(((7, 9), (3, 12), (10, 5)))]
    for res, req in zip(sorted(eng.run(reqs), key=lambda r: r.rid), reqs):
        solo, _ = serve.generate(cfg, params, {"tokens": torch.from_numpy(req.prompt)[None].long()},
                                 gen_len=req.max_new_tokens)
        assert res.tokens == solo[0].tolist(), req.rid


def test_serve_cli_serves_hymba(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
                "6", "--gen", "3", "--cim", "--materialize", "packed", "--min-size", "512"])
    out = capsys.readouterr().out
    assert "token agreement" in out and "packed" in out
