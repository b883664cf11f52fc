"""The port's decode loop and sampled decode against the JAX package, on the CPU.

``prng._log`` / ``gumbel`` / ``categorical`` must equal ``jnp.log`` /
``jax.random.gumbel`` / ``jax.random.categorical`` on XLA:CPU bit for bit;
sampled token streams (``greedy=False``) must equal the reference's
``serve.generate`` on the reduced float32 configs, with params converted
from the reference's ``api.init``.  Within the port: ``loop="scan"`` and
``loop="python"`` give the same tokens, a tensor decode position gives the
bits of a Python-int one, and casting the matmul weights once per
deployment gives the bits of casting them at every call.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import serving_throughput as jbench
from benchmarks_torch import serving_throughput as bench
from repro.configs import get_arch as jax_get_arch
from repro.core import planner as jplanner
from repro.launch import serve as jserve
from repro.models import api as japi
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planner
from repro_torch.launch import serve, steps
from repro_torch.models import api

PLAN = dict(p_stuck=0.5, min_size=1024)
GEN = 6
TINY = np.finfo(np.float32).tiny


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# prng: log, gumbel, categorical
# ---------------------------------------------------------------------------

def _pattern_range(lo: int, hi: int) -> np.ndarray:
    return np.arange(lo, hi, dtype=np.int64).astype(np.int32).view(np.float32)


@pytest.mark.parametrize("span", ["below_one", "above_one", "near_one", "specials"])
def test_log_bit_identical(span):
    """``prng._log`` == XLA:CPU's ``jnp.log`` on millions of float32 values."""
    rng = np.random.default_rng(0)
    a = {
        "below_one": np.exp(rng.uniform(np.log(TINY), 0.0, 2_000_000)),
        "above_one": np.exp(rng.uniform(0.0, np.log(2.0**20), 2_000_000)),
        # every float32 within 2^13 ulps of 1, both sides
        "near_one": np.concatenate([_pattern_range(0x3F800000 - 8192, 0x3F800000),
                                    _pattern_range(0x3F800000, 0x3F800000 + 8192)]),
        "specials": np.array([TINY, 0.0, -0.0, -1.0, np.inf, 1.0, 2.0**-149, -(2.0**-140),
                              TINY * (1 - 2**-23), np.nan, -np.inf, 1 - 2**-24,
                              1 - 2**-23, 87.33655, np.float32(3.4e38)]),
    }[span].astype(np.float32)
    want = _bits(jax.jit(jnp.log)(a))
    got = _bits(prng._log(torch.from_numpy(a)).numpy())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("shape", [(4, 256), (2, 1000)])
def test_gumbel_bit_identical(seed, shape):
    want = _bits(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = _bits(prng.gumbel(prng.PRNGKey(seed), shape).numpy())
    np.testing.assert_array_equal(got, want)


def test_gumbel_at_the_ends_of_the_uniform():
    """The noise at u = tiny (all-zero bits) and u just below 1 (all-one
    bits): ``-log(-log(u))`` as XLA:CPU evaluates it."""
    bits = torch.tensor([0, 0x1FF, 0x200, 0xFFFFFFFF, 0xFFFFFE00], dtype=torch.int64)
    u = prng._uniform_from_bits(bits, float(TINY), 1.0)
    np.testing.assert_array_equal(
        _bits(u.numpy()), _bits(np.array([TINY, TINY, 2.0**-23, 1 - 2**-23, 1 - 2**-23])))
    want = _bits(jax.jit(lambda x: -jnp.log(-jnp.log(x)))(u.numpy()))
    np.testing.assert_array_equal(_bits((-prng._log(-prng._log(u))).numpy()), want)
    assert np.isfinite(want.view(np.float32)).all()


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("shape", [(4, 256), (2, 1000)])
def test_categorical_matches_reference(seed, shape):
    logits = (np.random.default_rng(seed).standard_normal(shape) * 2).astype(np.float32)
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed), jnp.asarray(logits)))
    got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits))
    assert got.shape == shape[:-1]
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError):
        prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits).bfloat16())


# ---------------------------------------------------------------------------
# Sampled decode against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """Per arch, built on first use: (jax cfg, jax params, jax plan, port
    cfg, port params, port plan, prompt tokens) of the reduced config."""
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
            tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
            cache[arch] = (jcfg, jparams, jplan, get_arch(arch, reduced=True), tparams, tplan,
                           tokens)
        return cache[arch]

    return get


def _deployed(models, arch, materialize):
    jcfg, jparams, jplan, cfg, tparams, tplan, tokens = models(arch)
    if materialize != "fp":
        jparams = jplanner.deploy_params(jparams, jplan, materialize=materialize)
        tparams = planner.deploy_params(tparams, tplan, materialize=materialize)
    return jcfg, jparams, cfg, tparams, tokens


@pytest.mark.parametrize("arch,materialize", [
    ("gemma-2b", "dense"), ("gemma-2b", "packed"), ("yi-6b", "fp"),
])
def test_sampled_generate_matches_reference(models, arch, materialize):
    """``generate(greedy=False, seed=7)``: the reference's tokens, bit for bit."""
    jcfg, jparams, cfg, tparams, tokens = _deployed(models, arch, materialize)
    jt, _ = jserve.generate(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, gen_len=GEN,
                            greedy=False, seed=7)
    tt, tps = serve.generate(cfg, tparams, {"tokens": _t(tokens).long()}, gen_len=GEN,
                             greedy=False, seed=7)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tps > 0
    greedy, _ = serve.generate(cfg, tparams, {"tokens": _t(tokens).long()}, gen_len=GEN)
    assert not torch.equal(greedy, tt)  # the sampled path really sampled


@pytest.mark.parametrize("greedy", [True, False])
def test_scan_loop_equals_python_loop(models, greedy):
    """The counterpart of the reference's scan-vs-python check: both loops
    give the same tokens, greedy and sampled, and every run repeats them."""
    _, _, cfg, tparams, tokens = _deployed(models, "gemma-2b", "packed")
    batch = {"tokens": _t(tokens).long()}
    runs = {loop: serve.make_generator(cfg, tparams, batch, gen_len=GEN, greedy=greedy,
                                       seed=11, loop=loop) for loop in serve.LOOPS}
    toks = {loop: [r()[0] for _ in range(2)] for loop, r in runs.items()}
    assert toks["scan"][0].shape == (2, GEN)
    for t in toks["scan"][1:] + toks["python"]:
        np.testing.assert_array_equal(t.numpy(), toks["scan"][0].numpy())
    with pytest.raises(ValueError, match="decode loop"):
        serve.make_generator(cfg, tparams, batch, gen_len=GEN, loop="while")


def test_decode_loop_key_schedule():
    """A sampled loop splits the key once a step, the reference's
    schedule; a greedy loop consumes none."""
    logits = torch.randn(2, 1, 50, generator=torch.Generator().manual_seed(0))
    key = prng.PRNGKey(5)
    tok, k2 = steps.pick(logits, key, greedy=True)
    assert torch.equal(k2, key) and torch.equal(tok, logits.argmax(-1))
    tok, k2 = steps.pick(logits, key, greedy=False)
    jkey, jsub = jax.random.split(jax.random.PRNGKey(5))
    np.testing.assert_array_equal(k2.numpy(), np.asarray(jkey).astype(np.int64))
    want = jax.random.categorical(jsub, jnp.asarray(logits[:, -1].numpy()))
    np.testing.assert_array_equal(tok[:, 0].numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Tensor positions and cast-once serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_tensor_position_bit_identical(models, dtype):
    """``decode_step`` at a 0-d tensor position == at a Python int, in the
    logits and in every cache bit."""
    _, _, cfg, tparams, tokens = _deployed(models, "gemma-2b", "fp")
    cfg = dataclasses.replace(cfg, dtype=dtype)
    _, pf = api.prefill(tparams, cfg, {"tokens": _t(tokens).long()})
    tok = _t(tokens[:, :1]).long()
    out = {}
    for kind, pos in (("int", 10), ("tensor", torch.tensor(10))):
        cache = api.merge_prefill_cache(cfg, api.init_cache(cfg, 2, 14, device="cpu"), pf)
        logits, cache = api.decode_step(tparams, cfg, cache, tok, pos)
        logits, cache = api.decode_step(tparams, cfg, cache, tok, pos + 1)
        out[kind] = (logits, cache)
    assert out["int"][0].numpy().tobytes() == out["tensor"][0].numpy().tobytes()
    for a, b in zip(out["int"][1], out["tensor"][1]):
        for name in ("k", "v"):
            assert torch.equal(a[name].view(torch.int16 if dtype == "bfloat16" else torch.int32),
                               b[name].view(torch.int16 if dtype == "bfloat16" else torch.int32))
    assert out["int"][1][0]["k"][:, :, :, 11].abs().sum() > 0  # both steps wrote their rows


@pytest.mark.parametrize("arch", ["gemma-2b", "yi-6b"])
def test_cast_once_bit_identical(models, arch):
    """bf16 compute: the weights cast once per deployment give the logits
    and tokens of the per-call casts; the embedding table, the norm gains
    and yi's head stay float32."""
    _, _, cfg, tparams, tokens = _deployed(models, arch, "dense")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    prepared = steps.prepare_serving_params(tparams, torch.bfloat16)
    seg = prepared["segments"][0]
    assert prepared["embed"]["table"].dtype == torch.float32
    assert seg["ln1"]["g"].dtype == seg["ln2"]["g"].dtype == torch.float32
    assert prepared["final_norm"]["g"].dtype == torch.float32
    assert all(seg[b][w].dtype == torch.bfloat16 for b in ("attn", "mlp") for w in seg[b])
    if "head" in prepared:
        assert prepared["head"]["w"].dtype == torch.float32
    batch = {"tokens": _t(tokens).long()}
    lp = [api.prefill(p, cfg, batch)[0] for p in (tparams, prepared)]
    assert lp[0].numpy().tobytes() == lp[1].numpy().tobytes()
    decode = steps.make_decode_loop(cfg, GEN - 1)
    toks = []
    for p in (tparams, prepared):
        logits, pf = api.prefill(p, cfg, batch)
        cache = api.merge_prefill_cache(cfg, api.init_cache(cfg, 2, 10 + GEN, device="cpu"), pf)
        toks.append(decode(p, cache, steps.greedy_pick(logits), prng.PRNGKey(0), 10)[0])
    np.testing.assert_array_equal(toks[0].numpy(), toks[1].numpy())


# ---------------------------------------------------------------------------
# The serving benchmark and the CLI
# ---------------------------------------------------------------------------

def test_weight_traffic_matches_reference(models):
    _, _, jplan, _, _, tplan, _ = models("gemma-2b")
    assert bench.weight_traffic(tplan) == jbench.weight_traffic(jplan)
    for shape, rep in (((4, 300, 24), "packed_codec"), ((37, 5), "planes_int8")):
        assert bench.cim_weight_bytes(shape, 10, rep, tile_density=0.3) == \
            jbench.cim_weight_bytes(shape, 10, rep, tile_density=0.3)


def test_serving_benchmark_quick_on_cpu(monkeypatch):
    monkeypatch.setattr(bench, "save_json", lambda name, res: None)
    res = bench.run(batch=2, prompt_len=8, gen=3, repeats=1, device="cpu")
    assert set(res["tok_s"]) == set(bench.VARIANTS)
    assert all(v > 0 for by_loop in res["tok_s"].values() for v in by_loop.values())
    assert all(res["tokens_equal_across_loops"].values())
    assert res["device_busy"] == {} and res["device"] == "cpu"


@pytest.mark.parametrize("loop", ["python", "scan"])
def test_serve_cli_loop_on_cpu(capsys, loop):
    serve.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4", "--loop", loop])
    assert "fp weights" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--loop", "scanned"])
