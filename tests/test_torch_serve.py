"""The port's serving path against the JAX package, on the CPU.

Packed matmuls, the model and greedy generation on the reduced gemma-2b
config (float32), with params converted from the reference's ``api.init``.
Tolerances: float32 matmuls and attention sum in another order in XLA and
torch, so logits agree to 2e-5 (absolute + relative; reduced-model logits
are O(1)); served token streams must be identical.  The serve CLI with
faults, fault leveling and a scrubbed storm prints the reference CLI's
report (golden ``serve_faults``).  The package rules
(no JAX in the port, no silent CPU fallback) are checked here too, and the
kernels against their plain versions in tests marked ``cuda`` (skipped
without a card).
"""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import bitslice as jbits
from repro.core import planes as jplanes
from repro.core import planner as jplanner
from repro.core import pool as jpool
from repro.core import simulator as jsim
from repro.kernels.cim_matmul import ops as jcim_ops
from repro.kernels.cim_matmul import ref as jcim
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import layers as jlayers
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.convert import from_numpy_tree
from repro_torch.core import bitslice, planes, planner, pool, simulator
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul import ref as cim_ref
from repro_torch.kernels.hamming import ops as ham_ops
from repro_torch.kernels.hamming import ref as ham_ref
from repro_torch.launch import serve
from repro_torch.models import api, layers

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "benchmarks_torch" / "golden" / "reference.json"
LOGIT_TOL = 2e-5
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _operands(shape, seed=0):
    """A quantized weight and its packed operands in both packages."""
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
    qt = jbits.quantize(jnp.asarray(w), 10)
    w_hat = np.array(jbits.dequantize(qt)).reshape(shape)
    w_hat.reshape(-1)[:4] = -0.0  # q = 0 cells with a negative sign
    jop = jsim.operands_from_dense(jnp.asarray(w_hat), qt.scale, qt.offset, "sign_magnitude", 10)
    top = simulator.operands_from_dense(_t(w_hat), float(qt.scale), 0.0, "sign_magnitude", 10)
    return w_hat, jop, top


def _matmul_bound(x, w):
    """|delta| <= 2 * eps * K * (|x| @ |w|): both sides sum K float32
    products in different orders (each within K * eps * |x||w| of exact)."""
    return 2 * F32_EPS * x.shape[-1] * (np.abs(x) @ np.abs(w))


# ---------------------------------------------------------------------------
# Packed operands and the packed matmul (plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 37, 20)])
def test_operands_from_dense_bytes(shape):
    _, jop, top = _operands(shape)
    for k in ("planes_packed", "sign_packed", "scale", "offset"):
        np.testing.assert_array_equal(np.asarray(jop[k]), top[k].numpy())
    assert top["kdim"].shape == jop["kdim"].shape
    assert np.asarray(jsim.densify_operands(jop)).tobytes() == \
        simulator.densify_operands(top).numpy().tobytes()


@pytest.mark.parametrize("m,k,n", [(1, 64, 32), (5, 37, 130)])
def test_cim_matmul_packed_plain_matches_reference(m, k, n):
    w_hat, jop, top = _operands((k, n), seed=k)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jcim.cim_matmul_packed(
        jnp.asarray(x), jop["planes_packed"], jop["sign_packed"], jop["scale"]))
    got = cim_ops.cim_matmul_packed(_t(x), top["planes_packed"], top["sign_packed"], top["scale"])
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert np.all(np.abs(got.numpy() - want) <= _matmul_bound(x, np.abs(w_hat)))
    np.testing.assert_array_equal(
        cim_ref.unpack_weights(top["planes_packed"], top["sign_packed"], k).numpy(),
        np.asarray(jcim.unpack_weights(jop["planes_packed"], jop["sign_packed"], k)),
    )


@pytest.mark.parametrize("m,k,n", [(1, 2048, 256), (4, 2048, 16384), (128, 16384, 2048), (5, 1001, 333)])
def test_cim_launch_plan_covers_k(m, k, n):
    """Split-K pieces are whole packed bytes and cover K exactly once."""
    mt, splits, k_per_split = cim_ops.launch_plan(m, k, n, sms=132)
    assert mt in (4, 16) and k_per_split % 8 == 0 and splits >= 1
    assert (splits - 1) * k_per_split < k <= splits * k_per_split


def test_cim_linear_with_offset():
    """The rank-1 offset term: y = x @ (Q*scale) + sum(x) * offset."""
    w_hat, jop, top = _operands((48, 24), seed=3)
    jop = dict(jop, offset=jnp.float32(0.125))
    top = dict(top, offset=torch.tensor(0.125))
    x = np.random.default_rng(4).standard_normal((6, 48)).astype(np.float32)
    want = np.asarray(jsim.cim_linear(jnp.asarray(x), jop))
    got = simulator.cim_linear(_t(x), top).numpy()
    bound = _matmul_bound(x, np.abs(w_hat)) + 2 * F32_EPS * 48 * np.abs(x).sum(-1, keepdims=True) * 0.125
    assert np.all(np.abs(got - want) <= bound)


def test_linear_stacked_operands():
    """Stacked operand dicts pair their leading axis with x's."""
    w_hat, jop, top = _operands((3, 32, 16), seed=5)
    x = np.random.default_rng(6).standard_normal((3, 5, 32)).astype(np.float32)
    want = np.asarray(jlayers.linear(jop, jnp.asarray(x), jnp.float32))
    got = layers.linear(top, _t(x), torch.float32).numpy()
    np.testing.assert_allclose(got, np.einsum("eck,ekn->ecn", x, w_hat), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _int8_operands(shape, seed):
    """A quantized weight as int8 signed planes in both packages."""
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
    qt = jbits.quantize(jnp.asarray(w), 10)
    w_hat = np.array(jbits.dequantize(qt)).reshape(shape)
    kw = dict(materialize="planes_int8")
    jop = jsim.operands_from_dense(jnp.asarray(w_hat), qt.scale, qt.offset, "sign_magnitude", 10, **kw)
    top = simulator.operands_from_dense(_t(w_hat), float(qt.scale), 0.0, "sign_magnitude", 10, **kw)
    return w_hat, jop, top


@pytest.mark.parametrize("m,k,n", [(1, 64, 32), (5, 37, 130)])
@pytest.mark.parametrize("mode", ["fused_dequant", "planes"])
def test_cim_matmul_int8_plain_matches_reference(mode, m, k, n):
    """B5's plain version against the reference kernel (interpret mode, the
    same mode) and its jnp oracle, within the B2 matmul tolerance."""
    w_hat, jop, top = _int8_operands((k, n), seed=k + n)
    np.testing.assert_array_equal(np.asarray(jop["splanes"]), top["splanes"].numpy())
    assert top["splanes"].dtype == torch.int8
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    got = cim_ops.cim_matmul(_t(x), top["splanes"], top["scale"], mode=mode)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    bound = _matmul_bound(x, np.abs(w_hat))
    for want in (
        np.asarray(jcim_ops.cim_matmul(jnp.asarray(x), jop["splanes"], jop["scale"], mode=mode,
                                       interpret=True)),
        np.asarray(jcim.cim_matmul(jnp.asarray(x), jop["splanes"], jop["scale"])),
    ):
        assert np.all(np.abs(got.numpy() - want) <= bound)
    y = simulator.cim_linear(_t(x), top).numpy()
    assert np.all(np.abs(y - np.asarray(jsim.cim_linear(jnp.asarray(x), jop))) <= bound)


@pytest.mark.parametrize("m,k,n", [(3, 300, 24), (4, 256, 130)])
@pytest.mark.parametrize("codec", ["const_rle", "col_perm", "col_perm_rle"])
def test_cim_matmul_packed_codecs_plain_matches_reference(codec, m, k, n):
    """Codec-encoded packed operands (``tile_nz``, ``plane_ids``) through the
    port's wrapper against the reference's ``cim_linear`` and its skip
    kernel (interpret mode), within the B2 matmul tolerance."""
    w = (np.random.default_rng(k).standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:128] *= 1e-2  # zero high-plane tiles in the first K block
    scale = np.float32(0.15 / 1023)
    jop = jsim.operands_from_dense(jnp.asarray(w), scale, 0.0, "sign_magnitude", 10, codec=codec)
    top = simulator.operands_from_dense(_t(w), float(scale), 0.0, "sign_magnitude", 10, codec=codec)
    w_hat = simulator.densify_operands(top).numpy()
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    bound = _matmul_bound(x, np.abs(w_hat))
    got = cim_ops.cim_matmul_packed(
        _t(x), top["planes_packed"], top["sign_packed"], top["scale"],
        tile_nz=top.get("plane_tile_nz"), plane_ids=top.get("plane_ids"))
    assert np.all(np.abs(got.numpy() - np.asarray(jsim.cim_linear(jnp.asarray(x), jop))) <= bound)
    np.testing.assert_array_equal(
        cim_ref.unpack_weights(top["planes_packed"], top["sign_packed"], k, top.get("plane_ids")).numpy(),
        np.asarray(jcim.unpack_weights(jop["planes_packed"], jop["sign_packed"], k, None,
                                       jop.get("plane_ids"))),
    )
    if "plane_tile_nz" in jop and "plane_ids" not in jop:
        want = jcim_ops.cim_matmul_packed(
            jnp.asarray(x), jop["planes_packed"], jop["sign_packed"], jop["scale"],
            tile_nz=jop["plane_tile_nz"], interpret=True)
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)


def test_cim_wrappers_reject_bad_codec_operands():
    _, _, top = _operands((64, 16), seed=1)
    x = torch.zeros(2, 64)
    args = (x, top["planes_packed"], top["sign_packed"], top["scale"])
    with pytest.raises(ValueError):
        cim_ops.cim_matmul_packed(*args, tile_nz=torch.ones(10, 2, dtype=torch.uint8))
    with pytest.raises(ValueError):
        cim_ops.cim_matmul_packed(*args, plane_ids=torch.arange(9, dtype=torch.int32))
    with pytest.raises(ValueError):
        cim_ops.cim_matmul(x, torch.zeros(10, 64, 16, dtype=torch.int8), top["scale"], mode="dot")


def test_linear_stacked_int8_and_codec_operands():
    """Stacked int8-plane and codec-encoded dicts slice every entry per layer."""
    w = (np.random.default_rng(7).standard_normal((3, 256, 16)) * 0.05).astype(np.float32)
    x = np.random.default_rng(8).standard_normal((3, 5, 256)).astype(np.float32)
    for kw in ({"materialize": "planes_int8"}, {"codec": "col_perm_rle"}):
        jop = jsim.operands_from_dense(jnp.asarray(w), np.float32(1e-4), 0.0, "sign_magnitude", 10, **kw)
        top = simulator.operands_from_dense(_t(w), 1e-4, 0.0, "sign_magnitude", 10, **kw)
        want = np.asarray(jlayers.linear(jop, jnp.asarray(x), jnp.float32))
        np.testing.assert_allclose(layers.linear(top, _t(x), torch.float32).numpy(), want,
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Model and generation on the reduced gemma-2b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma():
    jcfg = jax_get_arch("gemma-2b", reduced=True)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jplan = jplanner.build_deployment(
        jparams, jplanner.CrossbarSpec(), jplanner.PlannerConfig(p_stuck=0.5, min_size=1024))
    tplan = planner.build_deployment(
        tparams, planner.CrossbarSpec(), planner.PlannerConfig(p_stuck=0.5, min_size=1024),
        device="cpu")
    return jcfg, jparams, jplan, get_arch("gemma-2b", reduced=True), tparams, tplan, tokens


@pytest.mark.parametrize("materialize", ["fp", "dense", "packed"])
def test_forward_prefill_decode_logits(gemma, materialize):
    jcfg, jparams, jplan, cfg, tparams, tplan, tokens = gemma
    if materialize != "fp":
        jparams = jplanner.deploy_params(jparams, jplan, materialize=materialize)
        tparams = planner.deploy_params(tparams, tplan, materialize=materialize)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": _t(tokens).long()}
    jl, _ = japi.forward(jparams, jcfg, jb)
    tl, _ = api.forward(tparams, cfg, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)

    jl, jcache = japi.prefill(jparams, jcfg, jb)
    tl, tcache = api.prefill(tparams, cfg, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(tcache[0]["k"].numpy(), np.asarray(jcache[0]["k"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)

    jfull = japi.merge_prefill_cache(jcfg, japi.init_cache(jcfg, 2, 16), jcache)
    tfull = api.merge_prefill_cache(cfg, api.init_cache(cfg, 2, 16, device="cpu"), tcache)
    tok = tokens[:, :1]
    jl, _ = japi.decode_step(jparams, jcfg, jfull, jnp.asarray(tok), jnp.int32(12))
    tl, _ = api.decode_step(tparams, cfg, tfull, _t(tok).long(), 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("materialize", ["dense", "packed"])
def test_generate_tokens_match_reference(gemma, materialize):
    """The acceptance contract: greedy tokens identical to the reference's
    ``serve.generate`` for the dense and packed materializations."""
    jcfg, jparams, jplan, cfg, tparams, tplan, tokens = gemma
    jt, _ = jserve.generate(
        jcfg, jplanner.deploy_params(jparams, jplan, materialize=materialize),
        {"tokens": jnp.asarray(tokens)}, gen_len=6)
    tt, tps = serve.generate(
        cfg, planner.deploy_params(tparams, tplan, materialize=materialize),
        {"tokens": _t(tokens).long()}, gen_len=6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tps > 0


def test_serve_cli_reduced_on_cpu(capsys):
    serve.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4", "--cim", "--materialize", "packed"])
    out = capsys.readouterr().out
    assert "token agreement" in out and "sws" in out


@pytest.fixture(scope="module")
def pool_plans(gemma):
    """Plans of the reduced gemma through a fresh pool per codec, both
    packages, built on first use."""
    jcfg, jparams, _, cfg, tparams, _, _ = gemma
    cache = {}

    def get(codec):
        if codec not in cache:
            kw = dict(p_stuck=0.5, min_size=1024, codec=codec)
            jp = jpool.CrossbarPool(jplanner.CrossbarSpec(), 16)
            tp = pool.CrossbarPool(planner.CrossbarSpec(), 16, device="cpu")
            cache[codec] = (
                jplanner.build_deployment(jparams, jplanner.CrossbarSpec(),
                                          jplanner.PlannerConfig(**kw), pool=jp),
                planner.build_deployment(tparams, planner.CrossbarSpec(),
                                         planner.PlannerConfig(**kw), pool=tp, device="cpu"),
            )
        return cache[codec]

    return get


@pytest.mark.parametrize("materialize,codec", [
    ("dense", "raw"), ("planes_int8", "raw"), ("packed", "raw"), ("packed", "const_rle"),
    ("packed", "col_perm"), ("packed", "col_perm_rle"),
])
def test_generate_through_pool_matches_reference(gemma, pool_plans, materialize, codec):
    """Greedy tokens identical to the reference's for every serving
    representation and codec, the deployment planned through a pool."""
    jcfg, jparams, _, cfg, tparams, _, tokens = gemma
    jplan, tplan = pool_plans(codec)
    jt, _ = jserve.generate(
        jcfg, jplanner.deploy_params(jparams, jplan, materialize=materialize, codec=codec),
        {"tokens": jnp.asarray(tokens)}, gen_len=6)
    tp = planner.deploy_params(tparams, tplan, materialize=materialize, codec=codec)
    tt, _ = serve.generate(cfg, tp, {"tokens": _t(tokens).long()}, gen_len=6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    if materialize == "planes_int8":
        assert "splanes" in tp["segments"][0]["mlp"]["wo"]


def _cli_numbers(out: str) -> list[str]:
    """The plan's lines of a serve CLI report (speedups, wear, horizon)."""
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("token agreement", "pool wear", "endurance horizon"))]
    lines[0] = lines[0].split("reprog speedup:")[1].split("   plan:")[0].strip()
    return lines


def test_serve_cli_pool_numbers_match_reference(monkeypatch, capsys):
    """``--cim --codec const_rle`` through a pool prints the reference's
    speedups, pool wear and endurance horizon (the same weights: the port's
    CLI is handed the reference's init)."""
    argv = ["--arch", "gemma-2b", "--reduced", "--batch", "2", "--prompt-len", "8",
            "--gen", "3", "--cim", "--codec", "const_rle", "--materialize", "packed",
            "--pool-leveling", "lpt"]
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    jserve.main()
    want = _cli_numbers(capsys.readouterr().out)
    jparams = japi.init(jax.random.PRNGKey(0), jax_get_arch("gemma-2b", reduced=True))
    monkeypatch.setattr(serve.api, "init", lambda cfg, seed, device: from_numpy_tree(
        jax.tree.map(np.asarray, jparams), device=device))
    serve.main(argv + ["--device", "cpu"])
    got = _cli_numbers(capsys.readouterr().out)
    assert len(want) == 3 and got == want


def test_serve_cli_codec_validation():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--codec", "const_rle"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--cim",
                    "--codec", "col_perm", "--materialize", "planes_int8"])


def _report(lines: list[str]) -> list[str]:
    """A serve report without its timings (tok/s and the planning wall)."""
    return [re.sub(r"\s+plan: .*$", "", re.sub(r"\s+[\d.]+ tok/s", " _ tok/s", ln)).rstrip()
            for ln in lines if ln.strip()]


def test_serve_cli_faults_and_scrub_match_reference(capsys):
    """``--fault-rate --fault-hotspot --pool-leveling fault --scrub
    --scrub-storm`` on the reduced gemma-2b prints the reference CLI's
    report: stuck cells and hotspots, tokens, speedups, wear, horizon,
    registered tiles, storm and scrub counters and the repair cost."""
    gold = json.loads(GOLDEN.read_text())["serve_faults"]
    serve.main(gold["args"] + ["--device", "cpu"])
    got = _report(capsys.readouterr().out.splitlines())
    want = _report(gold["lines"])
    assert len(want) == 9 and got == want


def test_serve_cli_fault_flag_validation():
    base = ["--arch", "gemma-2b", "--reduced", "--device", "cpu"]
    with pytest.raises(SystemExit):
        serve.main(base + ["--scrub"])  # needs --cim
    with pytest.raises(SystemExit):
        serve.main(base + ["--cim", "--scrub-storm", "1e-3"])  # needs --scrub


# ---------------------------------------------------------------------------
# Package rules
# ---------------------------------------------------------------------------

def _port_sources():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            + sorted((ROOT / "benchmarks_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"])


def test_port_imports_no_jax_and_no_reference():
    """No port source (``src/repro_torch``, ``benchmarks_torch``,
    ``chip_smoke.py``) imports jax, the reference package or the reference's
    benchmarks."""
    sources = _port_sources()
    assert len(sources) > 20
    assert ROOT / "benchmarks_torch" / "common.py" in sources
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "benchmarks"), (
                    f"{path}: imports {mod}")


def test_serve_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma-2b", "--reduced"])


@pytest.mark.parametrize("entry", ["init", "make_batch", "init_cache", "from_numpy_tree"])
def test_model_entry_points_need_a_card(monkeypatch, entry):
    """Without ``device="cpu"`` the constructors of params, batches, caches
    and converted params ask for the card, and raise when there is none."""
    cfg = get_arch("gemma-2b", reduced=True)
    calls = {
        "init": lambda **kw: api.init(prng.PRNGKey(0), cfg, **kw),
        "make_batch": lambda **kw: api.make_batch(cfg, prng.PRNGKey(0), 2, 8, **kw),
        "init_cache": lambda **kw: api.init_cache(cfg, 2, 8, **kw),
        "from_numpy_tree": lambda **kw: from_numpy_tree({"w": np.zeros((2, 3), np.float32)}, **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    leaves = calls[entry](device="cpu")
    while isinstance(leaves, (dict, list)):
        leaves = next(iter(leaves.values() if isinstance(leaves, dict) else leaves))
    assert leaves.device.type == "cpu"


# ---------------------------------------------------------------------------
# Kernels against their plain versions (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0, 1, 37, 4096])
def test_hamming_kernel_matches_plain(cuda_device, t):
    g = torch.Generator(device=cuda_device).manual_seed(t)
    a = torch.randint(0, 256, (t, 16, 10), dtype=torch.uint8, device=cuda_device, generator=g)
    b = torch.randint(0, 256, (t, 16, 10), dtype=torch.uint8, device=cuda_device, generator=g)
    assert torch.equal(ham_ops.price_pairs(a, b), ham_ref.hamming_pairs(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (128, 2048, 256), (5, 1001, 333)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cim_kernel_matches_plain(cuda_device, m, k, n, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=cuda_device, generator=g)
    s = torch.where(torch.rand(k, n, device=cuda_device, generator=g) < 0.5, -1, 1).to(torch.int8)
    planes, signs = bitslice.pack_linear_planes(q, 10), bitslice.pack_linear_sign(s)
    scale = torch.tensor(1e-3, device=cuda_device)
    x = torch.randn(m, k, device=cuda_device, generator=g).to(dtype)
    got = cim_ops.cim_matmul_packed(x, planes, signs, scale)
    want = cim_ref.cim_matmul_packed(x, planes, signs, scale)
    w = cim_ref.unpack_weights(planes, signs, k).abs() * scale
    bound = 2 * F32_EPS * k * (x.float().abs() @ w)
    assert bool(((got - want).abs() <= bound).all())


def _codec_operands(k, n, device, seed, zero_share=0.0):
    """Random packed operands on ``device`` with ``plane_tile_nz`` flags; a
    share of the (plane, K-block) tiles is zeroed (and flagged)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=device, generator=g)
    s = torch.where(torch.rand(k, n, device=device, generator=g) < 0.5, -1, 1).to(torch.int8)
    op = simulator.packed_operands(q, s, 1e-3, 0.0, 10)
    if zero_share:
        nt = -(-k // 128)
        dead = torch.rand(10, nt, device=device, generator=g) < zero_share
        rows = dead.repeat_interleave(16, dim=1)[:, : op["planes_packed"].shape[1]]
        op["planes_packed"] = op["planes_packed"] * (~rows)[:, :, None]
    return planes.encode_operands(op, "const_rle")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 2048, 256), (4, 2048, 2048), (128, 1001, 333)])
@pytest.mark.parametrize("zero_share", [0.0, 0.5])
@pytest.mark.parametrize("permuted", [False, True])
def test_skip_kernel_equals_packed_kernel_bit_for_bit(cuda_device, m, k, n, zero_share, permuted):
    op = _codec_operands(k, n, cuda_device, seed=m + k, zero_share=zero_share)
    ids = None
    if permuted:
        ids = torch.randperm(10, generator=torch.Generator().manual_seed(k)).to(
            device=cuda_device, dtype=torch.int32)
    x = torch.randn(m, k, device=cuda_device).to(torch.bfloat16)
    args = (x, op["planes_packed"], op["sign_packed"], op["scale"])
    b2 = cim_ops.cim_matmul_packed(*args, plane_ids=ids)
    b4 = cim_ops.cim_matmul_packed(*args, tile_nz=op["plane_tile_nz"], plane_ids=ids)
    assert torch.equal(b2, b4)
    want = cim_ref.cim_matmul_packed(*args, plane_ids=ids)
    w = cim_ref.unpack_weights(op["planes_packed"], op["sign_packed"], k, ids).abs() * 1e-3
    assert bool(((b4 - want).abs() <= 2 * F32_EPS * k * (x.float().abs() @ w)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (128, 2048, 256), (5, 1001, 333)])
@pytest.mark.parametrize("mode", ["fused_dequant", "planes"])
def test_int8_plane_kernel_matches_plain(cuda_device, m, k, n, mode):
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=cuda_device, generator=g)
    s = torch.where(torch.rand(k, n, device=cuda_device, generator=g) < 0.5, -1, 1).to(torch.int8)
    op = simulator.int8_plane_operands(q, s, 1e-3, 0.0, 10)
    x = torch.randn(m, k, device=cuda_device, generator=g)
    got = cim_ops.cim_matmul(x, op["splanes"], op["scale"], mode=mode)
    want = cim_ref.cim_matmul(x, op["splanes"], op["scale"], mode)
    bound = 2 * F32_EPS * k * (x.abs() @ (q.float() * 1e-3))
    assert bool(((got - want).abs() <= bound).all())
