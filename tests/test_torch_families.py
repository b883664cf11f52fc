"""The dense GQA + SwiGLU decoders (yi-6b, internlm2-1.8b, phi3-medium-14b)
on the port against the JAX package, on the CPU.

Reduced float32 configs with params from the reference's ``api.init``
converted through ``convert.from_numpy_tree``; plans by both planners (the
untied ``head/w`` is planned and served, as in the reference).  Tolerances:
forward logits agree within 2e-5 absolute + relative (float32 matmuls and
attention sum in another order in XLA and torch; reduced-model logits are
O(1)); served greedy token streams must be identical for fp, dense, packed
and planes_int8.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import planner as jplanner
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import layers as jlayers
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planner
from repro_torch.launch import serve
from repro_torch.models import api, layers

ARCHS = ("yi-6b", "internlm2-1.8b", "phi3-medium-14b")
MATERIALIZATIONS = ("fp", "dense", "packed", "planes_int8")
LOGIT_TOL = 2e-5
PLAN = dict(p_stuck=0.5, min_size=1024)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def family():
    """Per arch, built on first use: (jax cfg, jax params, jax plan, port
    cfg, port params, port plan, prompt tokens)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_get_arch(arch, reduced=True)
            jparams = japi.init(jax.random.PRNGKey(0), jcfg)
            tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
            jplan = jplanner.build_deployment(
                jparams, jplanner.CrossbarSpec(), jplanner.PlannerConfig(**PLAN))
            tplan = planner.build_deployment(
                tparams, planner.CrossbarSpec(), planner.PlannerConfig(**PLAN), device="cpu")
            tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
            cache[arch] = (jcfg, jparams, jplan, get_arch(arch, reduced=True), tparams, tplan,
                           tokens)
        return cache[arch]

    return get


def _deployed(family, arch, materialize):
    jcfg, jparams, jplan, cfg, tparams, tplan, tokens = family(arch)
    if materialize != "fp":
        jparams = jplanner.deploy_params(jparams, jplan, materialize=materialize)
        tparams = planner.deploy_params(tparams, tplan, materialize=materialize)
    return jcfg, jparams, cfg, tparams, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """The port's copies carry the reference's values for every field the
    port has, full and reduced."""
    for reduced in (False, True):
        ours, ref = get_arch(arch, reduced=reduced), jax_get_arch(arch, reduced=reduced)
        for f in dataclasses.fields(ArchConfig):
            assert getattr(ours, f.name) == getattr(ref, f.name), (arch, reduced, f.name)
    assert arch in list_archs()


def test_default_activation_is_the_references():
    from repro.configs.base import ArchConfig as JaxArchConfig

    fields = {f.name: f.default for f in dataclasses.fields(JaxArchConfig)}
    assert {f.name: f.default for f in dataclasses.fields(ArchConfig)}["act"] == fields["act"]


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_glu_mlp_matches_reference(act):
    rng = np.random.default_rng(0)
    p = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in (("wi_gate", (16, 40)), ("wi_up", (16, 40)), ("wo", (40, 16)))}
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = jlayers.glu_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act,
                           jnp.float32)
    got = layers.glu_mlp({k: _t(v) for k, v in p.items()}, _t(x), act, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    with pytest.raises(ValueError, match="unknown act"):
        layers.glu_mlp({k: _t(v) for k, v in p.items()}, _t(x), "relu", torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_untied_head_is_planned_and_served(family, arch):
    """``head/w`` is deployed like the reference's and, packed, reaches the
    logits as an operand dict."""
    jcfg, jparams, jplan, cfg, tparams, tplan, _ = family(arch)
    assert "head/w" in jplan.reports and "head/w" in tplan.reports
    assert sorted(tplan.reports) == sorted(jplan.reports)
    assert tplan.deployed["head/w"].numpy().tobytes() == np.asarray(jplan.deployed["head/w"]).tobytes()
    packed = planner.deploy_params(tparams, tplan, materialize="packed")
    assert "planes_packed" in packed["head"]["w"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("materialize", MATERIALIZATIONS)
def test_forward_logits_match_reference(family, arch, materialize):
    jcfg, jparams, cfg, tparams, tokens = _deployed(family, arch, materialize)
    jl, _ = japi.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    tl, _ = api.forward(tparams, cfg, {"tokens": _t(tokens).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("materialize", MATERIALIZATIONS)
def test_generate_tokens_match_reference(family, arch, materialize):
    """The acceptance contract: greedy tokens identical to the reference's
    ``serve.generate`` for every serving representation."""
    jcfg, jparams, cfg, tparams, tokens = _deployed(family, arch, materialize)
    jt, _ = jserve.generate(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, gen_len=5)
    tt, _ = serve.generate(cfg, tparams, {"tokens": _t(tokens).long()}, gen_len=5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_accepts_the_family(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "6", "--gen", "3", "--cim", "--materialize", "planes_int8"])
    out = capsys.readouterr().out
    assert "token agreement" in out and "planes_int8" in out
