"""xlstm-350m on the port against the JAX package, on the CPU.

Reduced float32 xlstm-350m (three mLSTM layers and one sLSTM, chunk 8)
with params from the reference's ``api.init`` converted through
``convert.from_numpy_tree``, inputs from a numpy seed, and one
module-scoped build of both packages' params, of one plan each at
``min_size`` 256 (which admits ``w_if`` [3, 64, 8] and the sLSTM's ``r``
[1, 4, 16, 64]) and of the reference's jitted forward.

Tolerances: ``mlstm_cell`` within 1e-5 absolute + relative (float32 einsums
and exps in another order); the mLSTM / sLSTM blocks and steps, forward
logits and decode within 2e-5; the port's decode after a 1- or 2-token
prompt within 2e-5 of its own forward (ROADMAP C.13: the reference departs
by ~5 there); the train step's loss within 1e-6, its grad norm within 1e-5
and each gradient leaf within 1e-5 of the largest of its leaf; plan reports
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
from repro.models import ssm as jssm
from repro.optim.adamw import global_norm as jglobal_norm
from repro.parallel import tp as jtp
from repro_torch import prng, tree
from repro_torch.configs import SSMConfig, get_arch, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planner
from repro_torch.launch import engine as teng
from repro_torch.launch import serve, steps
from repro_torch.models import api, ssm
from repro_torch.models.transformer import layer_slice, segments_of, supports_paged
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import tp

ARCH = "xlstm-350m"
TOL = 2e-5
CELL_TOL = 1e-5
MIN_SIZE = 256
VARIANTS = (("fp", "raw"), ("dense", "raw"), ("packed", "raw"), ("packed", "const_rle"),
            ("planes_int8", "raw"))
MLSTM, SLSTM = 0, 1  # the reduced config's segments: 3 mlstm layers, then 1 slstm


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
    """Both packages' reduced xlstm-350m: configs, params, one plan each at
    MIN_SIZE, a prompt, and the reference's jitted forward."""
    jcfg, cfg = jget(ARCH, reduced=True), get_arch(ARCH, reduced=True)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    pc = dict(p_stuck=0.5, min_size=MIN_SIZE)
    jplan = jplanner.build_deployment(jparams, jplanner.CrossbarSpec(),
                                      jplanner.PlannerConfig(**pc))
    tplan = planner.build_deployment(tparams, planner.CrossbarSpec(),
                                     planner.PlannerConfig(**pc), device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    jforward = jax.jit(lambda p, t: japi.forward(p, jcfg, {"tokens": t}))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, tparams=tparams, jplan=jplan,
                tplan=tplan, tokens=tokens, jforward=jforward)


def _layer(ref, seg: int, torch_tree: bool):
    """Layer 0 of segment ``seg`` (unstacked)."""
    if torch_tree:
        return layer_slice(ref["tparams"]["segments"][seg], 0)
    return jax.tree.map(lambda a: a[0], ref["jparams"]["segments"][seg])


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
    assert {k for k, _ in segments_of(ours)} == {"mlstm", "slstm"}
    if not reduced:
        assert (ours.d_model, ours.n_heads, ours.vocab_size, ours.n_layers, ours.d_ff) == (
            1024, 4, 50304, 24, 0)
        assert (ours.ssm.chunk_size, ours.ssm.conv_width, ours.ssm.expand) == (256, 4, 2)
        cut = dataclasses.replace(ours, n_layers=8)
        assert segments_of(cut) == [("mlstm", 7), ("slstm", 1)]


def test_init_matches_reference_bit_for_bit(ref):
    mine = api.init(prng.PRNGKey(0), ref["cfg"], device="cpu")
    got, want = list(tree.leaves_with_path(mine)), list(tree.leaves_with_path(ref["tparams"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32)), path
    assert set(mine["segments"][MLSTM]) == {"ln", "w_up", "conv", "wq", "wk", "wv", "w_if",
                                            "w_down"}
    assert set(mine["segments"][SLSTM]) == {"ln", "w", "r", "w_out"}
    assert tuple(mine["segments"][SLSTM]["r"].shape) == (1, 4, 16, 64)


@pytest.mark.parametrize("s", [16, 13])
def test_mlstm_cell_matches_reference(s):
    """The chunkwise cell at an S that is (16) and is not (13) a multiple
    of the chunk of 8 (the tail padded with identity steps), from a nonzero
    state: outputs, state and normaliser in float32."""
    rng = np.random.default_rng(s)
    b, h, dh = 2, 3, 4
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(3))
    i_l, f_l = (rng.standard_normal((b, s, h)).astype(np.float32) for _ in range(2))
    st = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    nm = rng.standard_normal((b, h, dh)).astype(np.float32)
    want = jax.jit(lambda *a: jssm.mlstm_cell(*a, 8))(*map(jnp.asarray, (q, k, v, i_l, f_l, st,
                                                                         nm)))
    got = ssm.mlstm_cell(*map(_t, (q, k, v, i_l, f_l, st, nm)), 8)
    assert tuple(got[0].shape) == (b, s, h, dh) and got[0].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w, CELL_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_fwd_and_step_match_reference(ref, kind):
    """A block over 11 positions (the mLSTM's second chunk padded) with its
    prompt cache, then one decode step from that cache: the outputs and
    every cache leaf (the step's written in place)."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    seg = MLSTM if kind == "mlstm" else SLSTM
    jp, tp_ = _layer(ref, seg, False), _layer(ref, seg, True)
    jfwd, jstep = ((jssm.mlstm_block_fwd, jssm.mlstm_block_step) if kind == "mlstm"
                   else (jssm.slstm_block_fwd, jssm.slstm_block_step))
    tfwd, tstep = ((ssm.mlstm_block_fwd, ssm.mlstm_block_step) if kind == "mlstm"
                   else (ssm.slstm_block_fwd, ssm.slstm_block_step))
    x = _x(cfg, 11)
    jy, jc = jax.jit(lambda p, x_: jfwd(p, jcfg, x_, return_cache=True))(jp, jnp.asarray(x))
    ty, tc = tfwd(tp_, cfg, _t(x), return_cache=True)
    _close(ty, jy)
    assert set(tc) == set(jc)
    for k in tc:
        _close(tc[k], jc[k])
    x1 = _x(cfg, 1, seed=6)
    jy, jc2 = jax.jit(lambda p, x_, c: jstep(p, jcfg, x_, c, 11))(jp, jnp.asarray(x1), jc)
    held = {k: v for k, v in tc.items()}
    ty = tstep(tp_, cfg, _t(x1), tc, 11)
    _close(ty, jy)
    for k in tc:
        assert tc[k] is held[k]
        _close(tc[k], jc2[k])


def test_forward_matches_reference(ref):
    jl, _ = ref["jforward"](ref["jparams"], jnp.asarray(ref["tokens"]))
    tl, taux = api.forward(ref["tparams"], ref["cfg"], {"tokens": _t(ref["tokens"]).long()})
    assert tuple(tl.shape) == (2, 10, ref["cfg"].vocab_size)
    _close(tl, jl)
    assert float(taux) == 0.0


def _decode_against_forward(params, cfg, tok_np, prompt):
    """Prefill ``prompt`` tokens, merge into a zero cache, teacher-force the
    rest: the merged cache (its leaves written in place), every step's
    logits, and forward's logits over the whole sequence."""
    b, total = tok_np.shape
    tokens = _t(tok_np).long()
    full, _ = api.forward(params, cfg, {"tokens": tokens})
    logits, pf = api.prefill(params, cfg, {"tokens": tokens[:, :prompt]})
    cache = api.init_cache(cfg, b, total, device="cpu")
    held = [c["state"] if "state" in c else c["h"] for c in cache]
    cache = api.merge_prefill_cache(cfg, cache, pf)
    assert all((c["state"] if "state" in c else c["h"]) is h for c, h in zip(cache, held))
    steps_ = [logits[:, -1]]
    for i in range(prompt, total - 1):
        logits, cache = api.decode_step(params, cfg, cache, tokens[:, i:i + 1], torch.tensor(i))
        steps_.append(logits[:, 0])
    return pf, steps_, full


def test_decode_matches_reference_and_forward(ref):
    """A 6-token prompt then 8 decode steps: the merged cache equals the
    reference's, each step's logits equal the reference's decode and the
    port's own forward at that position."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    prompt, total = 6, 14
    tok_np = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, total)).astype(np.int32)
    pf, got, full = _decode_against_forward(ref["tparams"], cfg, tok_np, prompt)
    for i, lg in enumerate(got):
        _close(lg, full[:, prompt - 1 + i])

    jpf_logits, jpf = jax.jit(lambda p, t: japi.prefill(p, jcfg, {"tokens": t}))(
        ref["jparams"], jnp.asarray(tok_np[:, :prompt]))
    for got_c, want_c in zip(pf, jpf):
        assert set(got_c) == set(want_c)
        for k in got_c:
            _close(got_c[k], want_c[k])
    _close(got[0], jpf_logits[:, -1])
    jcache = japi.merge_prefill_cache(jcfg, japi.init_cache(jcfg, 2, total), jpf)
    jdecode = jax.jit(lambda p, c, t, pos: japi.decode_step(p, jcfg, c, t, pos))
    for i in range(prompt, total - 1):
        jl, jcache = jdecode(ref["jparams"], jcache, jnp.asarray(tok_np[:, i:i + 1]),
                             jnp.int32(i))
        _close(got[i - prompt + 1], jl[:, 0])


@pytest.mark.parametrize("prompt", [1, 2])
def test_short_prompt_decode_equals_forward(ref, prompt):
    """ROADMAP C.13: after a prompt shorter than conv_width - 1 the merged
    conv state holds the prompt last, zeros before it, and the decode
    equals forward."""
    cfg = ref["cfg"]
    tok_np = np.random.default_rng(prompt).integers(0, cfg.vocab_size, (2, prompt + 5))
    pf, got, full = _decode_against_forward(ref["tparams"], cfg, tok_np.astype(np.int32), prompt)
    w = cfg.ssm.conv_width
    conv = pf[MLSTM]["conv"]
    assert tuple(conv.shape[-2:]) == (w - 1, cfg.ssm.expand * cfg.d_model)
    assert not conv[:, :, :w - 1 - prompt].any()
    for i, lg in enumerate(got):
        _close(lg, full[:, prompt - 1 + i])


def test_mamba_conv_tail_is_padded():
    """ROADMAP C.13 in the Mamba block: at S = 2 ``mamba_fwd``'s conv tail
    is (B, W - 1, d_inner), a zero row before the reference's 2-row tail
    (the block's weights drawn by the port, handed to both)."""
    jcfg, cfg = jget("hymba-1.5b", reduced=True), get_arch("hymba-1.5b", reduced=True)
    tp_ = ssm.init_mamba(prng.PRNGKey(0), cfg)
    jp = jax.tree.map(jnp.asarray, tree.tree_map(lambda a: a.numpy(), tp_))
    x = _x(cfg, 2)
    jy, jc = jax.jit(lambda p, x_: jssm.mamba_fwd(p, jcfg, x_, return_cache=True))(
        jp, jnp.asarray(x))
    ty, tc = ssm.mamba_fwd(tp_, cfg, _t(x), return_cache=True)
    _close(ty, jy)
    di = cfg.ssm.expand * cfg.d_model
    assert tuple(jc["conv"].shape) == (2, 2, di)
    assert tuple(tc["conv"].shape) == (2, cfg.ssm.conv_width - 1, di)
    assert not tc["conv"][:, 0].any()
    _close(tc["conv"][:, 1:], jc["conv"])
    _close(tc["state"], jc["state"])


def test_plans_match_reference(ref):
    jplan, tplan = ref["jplan"], ref["tplan"]
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
    assert {"segments/0/w_if", "segments/1/r", "segments/0/conv/w", "head/w"} <= set(
        tplan.reports)
    assert tuple(tplan.reports["segments/1/r"].shape) == (1, 4, 16, 64)


def _reference_tokens(ref, materialize):
    """The reference's greedy tokens (gen 5), once a module, for "fp" and
    "dense".  Its packed and planes_int8 deployments serve exact
    re-encodings of its dense w_hat, and their tokens equal its dense
    tokens on this config, so the port's packed, const_rle and planes_int8
    tokens are held to the reference's dense ones."""
    cache = ref.setdefault("jtokens", {})
    if materialize not in cache:
        jparams = ref["jparams"]
        if materialize == "dense":
            jparams = jplanner.deploy_params(jparams, ref["jplan"], materialize="dense")
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
    want = _reference_tokens(ref, "fp" if materialize == "fp" else "dense")
    np.testing.assert_array_equal(tt.numpy(), want)


@pytest.mark.parametrize("materialize", ["packed", "planes_int8"])
def test_recurrent_kernel_served_dense(ref, materialize):
    """``r`` and the conv taps are planned and served as their dense w_hat;
    ``w_if`` (N = 8) and the other projections as operand dicts."""
    plan = ref["tplan"]
    p = planner.deploy_params(ref["tparams"], plan, materialize=materialize)
    r = p["segments"][SLSTM]["r"]
    assert isinstance(r, torch.Tensor)
    assert r.numpy().tobytes() == plan.deployed["segments/1/r"].numpy().tobytes()
    assert isinstance(p["segments"][MLSTM]["conv"]["w"], torch.Tensor)
    for w in ("w_up", "wq", "wk", "wv", "w_if", "w_down"):
        assert isinstance(p["segments"][MLSTM][w], dict), w
    for w in ("w", "w_out"):
        assert isinstance(p["segments"][SLSTM][w], dict), w


def test_train_step_matches_reference(ref):
    """The port's train step (remat "full") against the reference's loss
    and gradients (one compiled ``value_and_grad`` of its ``loss_fn``): the
    loss, the global grad norm the optimizer clips by, and every gradient
    leaf of the port's ``loss_fn``."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)})[0]))(ref["jparams"])
    tstep = steps.make_train_step(cfg, AdamWConfig())
    _, _, tm = tstep(ref["tparams"], adamw_init(ref["tparams"]), {"tokens": _t(toks).long()})
    np.testing.assert_allclose(float(tm["loss"]), float(jloss), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jglobal_norm(jgrads)), rtol=1e-5,
                               atol=1e-5)
    p = tree.tree_map(lambda x: x.detach().requires_grad_(True), ref["tparams"])
    with torch.enable_grad():
        loss, _ = steps.loss_fn(p, cfg, {"tokens": _t(toks).long()})
        grads = torch.autograd.grad(loss, tree.leaves(p))
    want = from_numpy_tree(jax.tree.map(np.asarray, jgrads), device="cpu")
    for (path, w), g in zip(tree.leaves_with_path(want), grads):
        assert torch.isfinite(g).all(), path
        scale = max(float(w.abs().max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale, rtol=0, atol=1e-5,
                                   err_msg=str(path))


def test_serving_params_cast_once(ref):
    """prepare_serving_params in bf16 casts the mLSTM's and the sLSTM's
    projections and the conv taps once, and keeps ``r`` (its einsum takes
    the float32 state), the norm gains, the embedding and the head."""
    src = ref["tparams"]
    served = steps.prepare_serving_params(src, torch.bfloat16)
    m, s = served["segments"][MLSTM], served["segments"][SLSTM]
    for w in ("w_up", "wq", "wk", "wv", "w_if", "w_down"):
        assert m[w].dtype == torch.bfloat16, w
    assert m["conv"]["w"].dtype == torch.bfloat16
    for w in ("w", "w_out"):
        assert s[w].dtype == torch.bfloat16, w
    assert s["r"] is src["segments"][SLSTM]["r"]
    assert m["ln"]["g"].dtype == s["ln"]["g"].dtype == torch.float32
    assert served["head"]["w"] is src["head"]["w"]


def test_engine_refuses_xlstm_as_the_reference_does(ref):
    assert supports_paged(ref["cfg"]) is False
    assert japi.supports_paged(ref["jcfg"]) is False
    with pytest.raises(NotImplementedError):
        jengine.Engine(ref["jcfg"], ref["jparams"])
    with pytest.raises(NotImplementedError, match="pure-attention"):
        teng.Engine(ref["cfg"], ref["tparams"])


@pytest.mark.parametrize("packed", [False, True])
def test_tp_plan_replicates_xlstm_as_the_reference_does(packed):
    for n in (1, 2, 4):
        for reduced in (True, False):
            want = jtp.plan_tp(jget(ARCH, reduced=reduced), n, packed=packed)
            got = tp.plan_tp(get_arch(ARCH, reduced=reduced), n, packed=packed)
            assert (got.n, got.attn, got.mlp) == (want.n, want.attn, want.mlp) == (n, False,
                                                                                   False)
            assert dict(got.reasons) == dict(want.reasons)
            assert "no TP reduction gates" in got.reasons["attn"]


def test_serve_cli_serves_xlstm(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
                "6", "--gen", "3", "--cim", "--materialize", "packed", "--min-size", "256"])
    out = capsys.readouterr().out
    assert "token agreement" in out and "packed" in out
