"""seamless-m4t-medium (the encoder-decoder) on the port against the JAX
package, on the CPU.

Reduced float32 seamless-m4t-medium (two encoder and two decoder layers,
d_model 64, 4 heads) with params from the reference's ``api.init``
converted through ``convert.from_numpy_tree``, inputs from the
reference's ``make_batch`` (the port's equal bit for bit), and one
module-scoped build of both packages' params and of one plan each at
``min_size`` 256.

Tolerances: forward logits within 1e-5 of the reference's largest logit;
the prefill cache and each decode step within 2e-5 (absolute + relative)
of the reference's, and within 2e-5 of the port's own forward; the train
step's loss within 1e-6 and its grad norm within 1e-5; init leaves, batch
draws, plan reports (``quant_mse`` within 1e-6) and ``w_hat`` bytes
identical; served greedy token streams identical.
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
from repro.optim.adamw import global_norm as jglobal_norm
from repro.parallel import tp as jtp
from repro_torch import prng, tree
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planner
from repro_torch.launch import engine as teng
from repro_torch.launch import serve, steps
from repro_torch.models import api, encdec
from repro_torch.models.transformer import supports_paged
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import tp

ARCH = "seamless-m4t-medium"
TOL = 2e-5
LOGIT_RTOL = 1e-5
MIN_SIZE = 256
PROMPT = 10


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


def _tbatch(jbatch) -> dict:
    out = {k: _t(v) for k, v in jbatch.items()}
    out["tokens"] = out["tokens"].long()
    return out


@pytest.fixture(scope="module")
def ref():
    """Both packages' reduced seamless-m4t-medium: configs, params, one plan
    each at MIN_SIZE and the reference's batch of PROMPT source frames and
    tokens."""
    jcfg, cfg = jget(ARCH, reduced=True), get_arch(ARCH, reduced=True)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    pc = dict(p_stuck=0.5, min_size=MIN_SIZE)
    jplan = jplanner.build_deployment(jparams, jplanner.CrossbarSpec(),
                                      jplanner.PlannerConfig(**pc))
    tplan = planner.build_deployment(tparams, planner.CrossbarSpec(),
                                     planner.PlannerConfig(**pc), device="cpu")
    jbatch = japi.make_batch(jcfg, jax.random.PRNGKey(3), 2, PROMPT)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, tparams=tparams, jplan=jplan,
                tplan=tplan, jbatch=jbatch, batch=_tbatch(jbatch))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    ours, want = get_arch(ARCH, reduced=reduced), jget(ARCH, reduced=reduced)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(ours, f.name) == getattr(want, f.name), f.name
    assert ARCH in list_archs() and ours.encdec
    if not reduced:
        assert (ours.d_model, ours.n_heads, ours.n_kv_heads, ours.resolved_head_dim, ours.d_ff,
                ours.vocab_size, ours.n_layers, ours.n_enc_layers) == (
            1024, 16, 16, 64, 4096, 256206, 12, 12)


def test_arch_config_fields_are_the_references_read_ones():
    """The port's ArchConfig is the reference's less ``norm`` and
    ``global_layer_every``, which no module of the reference reads."""
    ours = {f.name for f in dataclasses.fields(ArchConfig)}
    theirs = {f.name for f in dataclasses.fields(type(jget(ARCH)))}
    assert theirs - ours == {"norm", "global_layer_every"} and ours <= theirs


def test_init_matches_reference_bit_for_bit(ref):
    mine = api.init(prng.PRNGKey(0), ref["cfg"], device="cpu")
    got, want = list(tree.leaves_with_path(mine)), list(tree.leaves_with_path(ref["tparams"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32)), path
    assert set(mine) == {"src_proj", "embed", "encoder", "enc_norm", "decoder", "final_norm",
                         "head"}
    assert set(mine["decoder"]) == {"ln1", "self", "ln_x", "cross", "ln2", "mlp"}
    assert tuple(mine["decoder"]["cross"]["wk"].shape) == (2, 64, 64)


def test_make_batch_matches_reference(ref):
    cfg = ref["cfg"]
    got = api.make_batch(cfg, prng.PRNGKey(3), 2, PROMPT, device="cpu")
    assert set(got) == {"tokens", "src_embeds"}
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(ref["jbatch"]["tokens"]))
    assert got["src_embeds"].shape == (2, PROMPT, cfg.d_model)
    assert got["src_embeds"].numpy().tobytes() == np.asarray(
        ref["jbatch"]["src_embeds"]).tobytes()


def test_forward_matches_reference(ref):
    jl, _ = jax.jit(lambda p, b: japi.forward(p, ref["jcfg"], b))(ref["jparams"], ref["jbatch"])
    tl, taux = api.forward(ref["tparams"], ref["cfg"], ref["batch"])
    assert tuple(tl.shape) == (2, PROMPT, ref["cfg"].vocab_size) and tl.dtype == torch.float32
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= LOGIT_RTOL * np.abs(jl).max()
    assert float(taux) == 0.0


def test_decode_matches_reference_and_forward(ref):
    """The source and a 4-token prompt, then six decode steps teacher-forced
    over the rest: the prefill cache (self and cross K/V) and each step's
    logits against the reference's, and against the port's own forward at
    that position; the merged cache is written in place and decode_step
    returns the same objects."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    prompt, b = 4, 2
    tokens = ref["batch"]["tokens"]
    pbatch = {"tokens": tokens[:, :prompt], "src_embeds": ref["batch"]["src_embeds"]}
    full, _ = api.forward(ref["tparams"], cfg, ref["batch"])
    logits, pf = api.prefill(ref["tparams"], cfg, pbatch)
    cache = api.init_cache(cfg, b, PROMPT, device="cpu", src_len=PROMPT)
    held = (cache["self"]["k"], cache["cross_k"], cache["cross_v"])
    assert api.merge_prefill_cache(cfg, cache, pf) is cache
    assert all(a is b for a, b in zip((cache["self"]["k"], cache["cross_k"], cache["cross_v"]),
                                      held))

    jpbatch = {"tokens": ref["jbatch"]["tokens"][:, :prompt],
               "src_embeds": ref["jbatch"]["src_embeds"]}
    jlogits, jpf = jax.jit(lambda p, bt: japi.prefill(p, jcfg, bt))(ref["jparams"], jpbatch)
    _close(pf["cross_k"], jpf["cross_k"])
    _close(pf["cross_v"], jpf["cross_v"])
    _close(pf["self"]["k"], jpf["self"]["k"])
    _close(pf["self"]["v"], jpf["self"]["v"])
    _close(logits[:, -1], jlogits[:, -1])
    _close(logits[:, -1], full[:, prompt - 1])
    jcache = japi.merge_prefill_cache(jcfg, japi.init_cache(jcfg, b, PROMPT, src_len=PROMPT),
                                      jpf)
    jdecode = jax.jit(lambda p, c, t, pos: japi.decode_step(p, jcfg, c, t, pos))
    for i in range(prompt, PROMPT):
        logits, out = api.decode_step(ref["tparams"], cfg, cache, tokens[:, i:i + 1],
                                      torch.tensor(i))
        assert out is cache
        jl, jcache = jdecode(ref["jparams"], jcache, ref["jbatch"]["tokens"][:, i:i + 1],
                             jnp.int32(i))
        _close(logits[:, 0], jl[:, 0])
        _close(logits[:, 0], full[:, i])
    _close(cache["self"]["k"], jcache["self"]["k"])


def test_plans_match_reference(ref):
    """The port plans the reference's tensors, in the reference's order,
    with identical reports and w_hat bytes."""
    jplan, tplan = ref["jplan"], ref["tplan"]
    assert list(tplan.reports) == list(jplan.reports)
    for name, jr in jplan.reports.items():
        tr = dataclasses.asdict(tplan.reports[name])
        for field, w in dataclasses.asdict(jr).items():
            if field == "quant_mse":
                np.testing.assert_allclose(tr[field], w, rtol=1e-6)
            else:
                assert tuple(tr[field]) == tuple(w) if field == "shape" else tr[field] == w
        assert tplan.deployed[name].numpy().tobytes() == np.asarray(
            jplan.deployed[name]).tobytes(), name
    assert {"src_proj/w", "encoder/attn/wq", "encoder/mlp/wo", "decoder/self/wk",
            "decoder/cross/wv", "decoder/mlp/wi_up", "head/w"} <= set(tplan.reports)


def _reference_tokens(ref, materialize):
    """The reference's greedy tokens (gen 5) from its own deployment of its
    plan, once a module for each materialization."""
    cache = ref.setdefault("jtokens", {})
    if materialize not in cache:
        jparams = ref["jparams"]
        if materialize != "fp":
            jparams = jplanner.deploy_params(jparams, ref["jplan"], materialize=materialize)
        cache[materialize] = np.asarray(jserve.generate(ref["jcfg"], jparams, ref["jbatch"],
                                                        gen_len=5)[0])
    return cache[materialize]


@pytest.mark.parametrize("loop", ["scan", "python"])
@pytest.mark.parametrize("materialize", ["fp", "dense", "packed", "planes_int8"])
def test_generate_tokens_match_reference(ref, materialize, loop):
    tparams = ref["tparams"]
    if materialize != "fp":
        tparams = planner.deploy_params(tparams, ref["tplan"], materialize=materialize)
    tt, _ = serve.generate(ref["cfg"], tparams, ref["batch"], gen_len=5, loop=loop)
    np.testing.assert_array_equal(tt.numpy(), _reference_tokens(ref, materialize))


def test_deployed_matmuls_served_as_operands(ref):
    """``src_proj`` and every encoder and decoder projection are served from
    operand dicts (a CIM launch each on the card); the norm gains dense."""
    p = planner.deploy_params(ref["tparams"], ref["tplan"], materialize="packed")
    assert isinstance(p["src_proj"]["w"], dict)
    for w in ("wq", "wk", "wv", "wo"):
        assert isinstance(p["encoder"]["attn"][w], dict)
        assert isinstance(p["decoder"]["self"][w], dict)
        assert isinstance(p["decoder"]["cross"][w], dict)
    assert isinstance(p["decoder"]["ln_x"]["g"], torch.Tensor)


def test_train_step_matches_reference(ref):
    """The port's train step (remat "full") against the reference's loss
    and global grad norm (one compiled ``value_and_grad`` of its
    ``loss_fn``)."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, jcfg, ref["jbatch"])[0]))(ref["jparams"])
    tstep = steps.make_train_step(cfg, AdamWConfig())
    _, _, tm = tstep(ref["tparams"], adamw_init(ref["tparams"]), ref["batch"])
    np.testing.assert_allclose(float(tm["loss"]), float(jloss), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jglobal_norm(jgrads)), rtol=1e-5,
                               atol=1e-5)


def test_serving_params_cast_once(ref):
    """prepare_serving_params in bf16 casts ``src_proj``, the encoder's and
    the decoder's (self, cross, MLP) matmul weights once; the norm gains,
    the embedding and the head stay float32."""
    src = ref["tparams"]
    served = steps.prepare_serving_params(src, torch.bfloat16)
    assert served["src_proj"]["w"].dtype == torch.bfloat16
    for block, subs in (("encoder", ("attn", "mlp")), ("decoder", ("self", "cross", "mlp"))):
        for sub in subs:
            for name, w in served[block][sub].items():
                assert w.dtype == torch.bfloat16, (block, sub, name)
    assert served["decoder"]["ln_x"]["g"].dtype == torch.float32
    assert served["encoder"]["ln1"]["g"].dtype == torch.float32
    assert served["head"]["w"] is src["head"]["w"]
    assert served["embed"]["table"] is src["embed"]["table"]


def test_engine_and_paged_pools_refuse_encdec(ref):
    assert supports_paged(ref["cfg"]) is False
    assert japi.supports_paged(ref["jcfg"]) is False
    with pytest.raises(NotImplementedError):
        jengine.Engine(ref["jcfg"], ref["jparams"])
    with pytest.raises(NotImplementedError, match="pure-attention"):
        teng.Engine(ref["cfg"], ref["tparams"])
    with pytest.raises(NotImplementedError, match="decoder-only"):
        api.init_paged_pools(ref["cfg"], 64, device="cpu")


@pytest.mark.parametrize("packed", [False, True])
def test_tp_plan_refuses_encdec_as_the_reference_does(packed):
    for n in (1, 2, 4):
        for reduced in (True, False):
            want = jtp.plan_tp(jget(ARCH, reduced=reduced), n, packed=packed)
            got = tp.plan_tp(get_arch(ARCH, reduced=reduced), n, packed=packed)
            assert (got.n, got.attn, got.mlp) == (want.n, want.attn, want.mlp) == (n, False,
                                                                                   False)
            assert dict(got.reasons) == dict(want.reasons)


def test_cross_cache_is_read_only_after_the_prefill(ref):
    """A decode step writes one self-attention position and leaves the cross
    K/V as the prefill merged them."""
    cfg = ref["cfg"]
    logits, pf = api.prefill(ref["tparams"], cfg, ref["batch"])
    cache = api.merge_prefill_cache(
        cfg, api.init_cache(cfg, 2, PROMPT + 2, device="cpu", src_len=PROMPT), pf)
    before = {k: cache[k].clone() for k in ("cross_k", "cross_v")}
    self_k = cache["self"]["k"].clone()
    tok = logits.argmax(-1)
    encdec.decode_step(ref["tparams"], cfg, cache, tok, PROMPT)
    for k, v in before.items():
        assert torch.equal(cache[k], v)
    changed = (cache["self"]["k"] != self_k).any(dim=(0, 1, 2, 4))
    assert changed.tolist() == [False] * PROMPT + [True, False]


def test_serve_cli_serves_seamless(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
                "6", "--gen", "3", "--cim", "--materialize", "packed", "--min-size", "256"])
    out = capsys.readouterr().out
    assert "token agreement" in out and "packed" in out
