"""The port's serving path against the JAX package, on the CPU.

Packed matmuls, the model and greedy generation on the reduced gemma-2b
config (float32), with params converted from the reference's ``api.init``.
Tolerances: float32 matmuls and attention sum in another order in XLA and
torch, so logits agree to 2e-5 (absolute + relative; reduced-model logits
are O(1)); served token streams must be identical.  The package rules
(no JAX in the port, no silent CPU fallback) are checked here too, and the
kernels against their plain versions in tests marked ``cuda`` (skipped
without a card).
"""
from __future__ import annotations

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import bitslice as jbits
from repro.core import planner as jplanner
from repro.core import simulator as jsim
from repro.kernels.cim_matmul import ref as jcim
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import layers as jlayers
from repro_torch.configs import get_arch
from repro_torch.convert import from_numpy_tree
from repro_torch.core import bitslice, planner, simulator
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul import ref as cim_ref
from repro_torch.kernels.hamming import ops as ham_ops
from repro_torch.kernels.hamming import ref as ham_ref
from repro_torch.launch import serve
from repro_torch.models import api, layers

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 2e-5
F32_EPS = float(np.finfo(np.float32).eps)


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


# ---------------------------------------------------------------------------
# Package rules
# ---------------------------------------------------------------------------

def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_reference():
    sources = _port_sources()
    assert len(sources) > 20
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
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


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
        "init": lambda **kw: api.init(cfg, **kw),
        "make_batch": lambda **kw: api.make_batch(cfg, 2, 8, **kw),
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
