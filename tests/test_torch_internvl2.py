"""internvl2-76b (a dense decoder behind a modality-stub prefix) on the
port against the JAX package, on the CPU.

Reduced float32 internvl2-76b (two layers, d_model 64, 4 heads over 2 KV
heads, ``stub_prefix_len`` 8) with params from the reference's
``api.init`` converted through ``convert.from_numpy_tree``, inputs from the
reference's ``make_batch`` (tokens and ``prefix_embeds``, the port's equal
bit for bit), and one module-scoped build of both packages' params and of
one plan each at ``min_size`` 256.

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
from repro_torch import prng, tree
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planner
from repro_torch.launch import engine as teng
from repro_torch.launch import serve, steps
from repro_torch.models import api
from repro_torch.models.transformer import supports_paged
from repro_torch.optim import AdamWConfig, adamw_init

ARCH = "internvl2-76b"
TOL = 2e-5
LOGIT_RTOL = 1e-5
MIN_SIZE = 256
PROMPT = 14  # 8 prefix positions + 6 text tokens


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
    """Both packages' reduced internvl2-76b: configs, params, one plan each
    at MIN_SIZE and the reference's batch of PROMPT positions."""
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
    assert ARCH in list_archs() and not ours.encdec
    if not reduced:
        assert (ours.d_model, ours.n_heads, ours.n_kv_heads, ours.resolved_head_dim, ours.d_ff,
                ours.vocab_size, ours.n_layers, ours.stub_prefix_len) == (
            8192, 64, 8, 128, 28672, 128256, 80, 256)


def test_init_matches_reference_bit_for_bit(ref):
    mine = api.init(prng.PRNGKey(0), ref["cfg"], device="cpu")
    got, want = list(tree.leaves_with_path(mine)), list(tree.leaves_with_path(ref["tparams"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32)), path


def test_make_batch_matches_reference(ref):
    cfg = ref["cfg"]
    got = api.make_batch(cfg, prng.PRNGKey(3), 2, PROMPT, device="cpu")
    assert set(got) == {"tokens", "prefix_embeds"}
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(ref["jbatch"]["tokens"]))
    assert got["prefix_embeds"].shape == (2, cfg.stub_prefix_len, cfg.d_model)
    assert got["prefix_embeds"].numpy().tobytes() == np.asarray(
        ref["jbatch"]["prefix_embeds"]).tobytes()


def test_forward_matches_reference(ref):
    jl, _ = jax.jit(lambda p, b: japi.forward(p, ref["jcfg"], b))(ref["jparams"], ref["jbatch"])
    tl, _ = api.forward(ref["tparams"], ref["cfg"], ref["batch"])
    assert tuple(tl.shape) == (2, PROMPT, ref["cfg"].vocab_size)
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= LOGIT_RTOL * np.abs(jl).max()


def test_prefix_replaces_the_first_positions(ref):
    """The first stub_prefix_len positions read the batch's prefix_embeds,
    not the tokens there: other tokens under the prefix give the same
    logits, another prefix other logits."""
    cfg, p = ref["cfg"], ref["tparams"]
    base, _ = api.forward(p, cfg, ref["batch"])
    other = dict(ref["batch"])
    other["tokens"] = other["tokens"].clone()
    other["tokens"][:, :cfg.stub_prefix_len] = 0
    same, _ = api.forward(p, cfg, other)
    assert torch.equal(same, base)
    other["prefix_embeds"] = other["prefix_embeds"] * 2
    moved, _ = api.forward(p, cfg, other)
    assert not torch.allclose(moved, base)


def test_decode_matches_reference_and_forward(ref):
    """The prefix and 2 text tokens, then four decode steps teacher-forced
    over the rest: the prefill cache and each step's logits against the
    reference's, and against the port's own forward at that position."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    prompt, b = cfg.stub_prefix_len, 2
    prompt += 2
    tokens = ref["batch"]["tokens"]
    pbatch = {"tokens": tokens[:, :prompt], "prefix_embeds": ref["batch"]["prefix_embeds"]}
    full, _ = api.forward(ref["tparams"], cfg, ref["batch"])
    logits, pf = api.prefill(ref["tparams"], cfg, pbatch)
    cache = api.merge_prefill_cache(cfg, api.init_cache(cfg, b, PROMPT, device="cpu"), pf)
    jpbatch = {"tokens": ref["jbatch"]["tokens"][:, :prompt],
               "prefix_embeds": ref["jbatch"]["prefix_embeds"]}
    jlogits, jpf = jax.jit(lambda p, bt: japi.prefill(p, jcfg, bt))(ref["jparams"], jpbatch)
    _close(pf[0]["k"], jpf[0]["k"])
    _close(pf[0]["v"], jpf[0]["v"])
    _close(logits[:, -1], jlogits[:, -1])
    _close(logits[:, -1], full[:, prompt - 1])
    jcache = japi.merge_prefill_cache(jcfg, japi.init_cache(jcfg, b, PROMPT), jpf)
    jdecode = jax.jit(lambda p, c, t, pos: japi.decode_step(p, jcfg, c, t, pos))
    assert PROMPT - prompt == 4
    for i in range(prompt, PROMPT):
        logits, cache = api.decode_step(ref["tparams"], cfg, cache, tokens[:, i:i + 1],
                                        torch.tensor(i))
        jl, jcache = jdecode(ref["jparams"], jcache, ref["jbatch"]["tokens"][:, i:i + 1],
                             jnp.int32(i))
        _close(logits[:, 0], jl[:, 0])
        _close(logits[:, 0], full[:, i])


def test_decode_six_positions_equal_forward(ref):
    """A 10-position prompt's last logits and five decode steps, six
    positions past the reference batch's length: each within 2e-5 of the
    port's forward over the 16 positions."""
    cfg, p = ref["cfg"], ref["tparams"]
    batch = api.make_batch(cfg, prng.PRNGKey(4), 2, 16, device="cpu")
    tokens = batch["tokens"].long()
    full, _ = api.forward(p, cfg, {**batch, "tokens": tokens})
    logits, pf = api.prefill(p, cfg, {**batch, "tokens": tokens[:, :10]})
    cache = api.merge_prefill_cache(cfg, api.init_cache(cfg, 2, 16, device="cpu"), pf)
    _close(logits[:, -1], full[:, 9])
    for i in range(10, 15):
        logits, cache = api.decode_step(p, cfg, cache, tokens[:, i:i + 1], torch.tensor(i))
        _close(logits[:, 0], full[:, i])


def test_short_prompt_is_refused_where_the_reference_serves_it(ref):
    """ROADMAP C.14: a prompt shorter than stub_prefix_len.  The reference
    serves 4 tokens as the 8 prefix positions alone (every text token
    dropped): a (2, 1, V) logit and a k/v cache of 8 positions, decode then
    starting at position 4, inside the prefix.  The port raises in
    make_batch, prefill, forward and generate, naming both lengths; at 12
    positions it serves."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    short = japi.make_batch(jcfg, jax.random.PRNGKey(5), 2, 4)
    jl, jc = japi.prefill(ref["jparams"], jcfg, short)
    assert jl.shape == (2, 1, cfg.vocab_size) and jc[0]["k"].shape[3] == cfg.stub_prefix_len
    tshort = _tbatch(short)
    msg = "prompt of 4 positions is shorter than the stub_prefix_len of 8"
    with pytest.raises(ValueError, match=msg):
        api.make_batch(cfg, prng.PRNGKey(5), 2, 4, device="cpu")
    with pytest.raises(ValueError, match=msg):
        api.prefill(ref["tparams"], cfg, tshort)
    with pytest.raises(ValueError, match=msg):
        api.forward(ref["tparams"], cfg, tshort)
    with pytest.raises(ValueError, match=msg):
        serve.generate(cfg, ref["tparams"], tshort, gen_len=3)
    ok = api.make_batch(cfg, prng.PRNGKey(5), 2, 12, device="cpu")
    toks, _ = serve.generate(cfg, ref["tparams"], ok, gen_len=3)
    assert toks.shape == (2, 3)


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
    assert {"segments/0/attn/wq", "segments/0/mlp/wi_gate", "head/w"} <= set(tplan.reports)


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


def test_train_step_matches_reference(ref):
    """The port's train step (remat "full") against the reference's loss
    and global grad norm, the stub positions masked out of both."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, jcfg, ref["jbatch"])[0]))(ref["jparams"])
    tstep = steps.make_train_step(cfg, AdamWConfig())
    _, _, tm = tstep(ref["tparams"], adamw_init(ref["tparams"]), ref["batch"])
    np.testing.assert_allclose(float(tm["loss"]), float(jloss), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jglobal_norm(jgrads)), rtol=1e-5,
                               atol=1e-5)


def test_loss_masks_the_stub_positions(ref):
    """The loss is the mean NLL over the positions from stub_prefix_len on:
    the same as the reference's, and equal to the mean of the unmasked
    NLL's tail computed here by hand."""
    cfg, p, batch = ref["cfg"], ref["tparams"], ref["batch"]
    loss, parts = steps.loss_fn(p, cfg, batch)
    jloss, _ = jsteps.loss_fn(ref["jparams"], ref["jcfg"], ref["jbatch"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6, atol=1e-6)
    logits, _ = api.forward(p, cfg, batch)
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(lp, -1, batch["tokens"][:, 1:, None])[..., 0]
    tail = nll[:, cfg.stub_prefix_len:].mean()
    np.testing.assert_allclose(float(parts["nll"]), float(tail), rtol=1e-6)
    assert abs(float(tail) - float(nll.mean())) > 1e-4


def test_engine_refuses_stub_prefix_as_the_reference_does(ref):
    assert supports_paged(ref["cfg"]) is False
    assert japi.supports_paged(ref["jcfg"]) is False
    with pytest.raises(NotImplementedError):
        jengine.Engine(ref["jcfg"], ref["jparams"])
    with pytest.raises(NotImplementedError, match="pure-attention"):
        teng.Engine(ref["cfg"], ref["tparams"])


def test_serve_cli_serves_internvl2(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
                "12", "--gen", "3", "--cim", "--materialize", "planes_int8", "--min-size",
                "256"])
    out = capsys.readouterr().out
    assert "token agreement" in out and "planes_int8" in out
