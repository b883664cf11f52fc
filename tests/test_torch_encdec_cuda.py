"""seamless-m4t-medium's and internvl2-76b's paths on the card: B3 ``bidir``
at head dim 64 with a GQA group of 1 (the encoder's self-attention,
16 heads over 16 KV heads), the FMA B2 / B4 / B5 at seamless's LM head
width N = 256206 (N % 4 = 2: the kernels' non-vectorized branch, at a
narrow K), and each reduced family planned on the card and served from its
bits through the decode graph, against the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the reference
package: ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_encdec_cuda.py``.

Tolerances: B3 within the reference kernel's bound of its plain version
(``fa_ref.attention_bound``: 2e-5 abs + rel; bf16 one bf16 ulp more); the
CIM kernels within 2 * eps_f32 * K * (|x| @ |w|) of theirs (the same exact
products summed in another order), B4 equal to B2 bit for bit; served
tokens: the decode graph equals the eager loop and the CPU's tokens of the
CPU's plan.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import prng, tree
from repro_torch.configs import get_arch
from repro_torch.core import planes, planner, simulator
from repro_torch.kernels import _util
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul import ref as cim_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve
from repro_torch.models import api, attention

F32_EPS = torch.finfo(torch.float32).eps
H, D = 16, 64  # seamless-m4t-medium's heads (MHA) and head dim
VOCAB = 256206  # seamless-m4t-medium's LM head width


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _util.full_f32_matmuls()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["bidir", "causal"])
@pytest.mark.parametrize("b,s", [(4, 32), (1, 2048), (2, 37)])
def test_flash_attention_head_dim_64_group_1(cuda_device, dtype, kind, b, s):
    """B3 at D = 64 with as many KV heads as query heads, against its plain
    version: bf16 on the tensor-core kernel, f32 on the FMA kernel."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(b * s)
    q, k, v = (torch.randn(b, H, s, D, device=dev, generator=g).to(dtype) for _ in range(3))
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, kind=kind)
    assert fa_ops.LAUNCHES == {"B3": 1, "B3_tc": int(dtype == torch.bfloat16)}
    want = fa_ref.flash_attention(q, k, v, kind=kind)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(((got.float() - want.float()).abs() <= fa_ref.attention_bound(want)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 200])
@pytest.mark.parametrize("m", [1, 4])
def test_fma_cim_kernels_at_the_seamless_head_width(cuda_device, k, m):
    """B2, B4 (~half the tiles zero) and B5 with f32 x (the FMA kernels, as
    the planned LM head takes them) at N = 256206, within the bound of the
    plain versions."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(k + m)
    q = torch.randint(0, 1024, (k, VOCAB), dtype=torch.int32, device=dev, generator=gen)
    s = torch.where(torch.rand(k, VOCAB, device=dev, generator=gen) < 0.5, -1, 1).to(torch.int8)
    op = simulator.packed_operands(q, s, 0.02 / 1023, 0.0, 10)
    dead = torch.rand(10, -(-k // 128), device=dev, generator=gen) < 0.5
    rows = dead.repeat_interleave(16, dim=1)[:, : op["planes_packed"].shape[1]]
    op["planes_packed"] = op["planes_packed"] * (~rows)[:, :, None]
    op = planes.encode_operands(op, "const_rle")
    i8 = simulator.int8_plane_operands(q, s, 0.02 / 1023, 0.0, 10)
    x = torch.randn(m, k, device=dev, generator=gen)
    args = (op["planes_packed"], op["sign_packed"], op["scale"])
    cim_ops.reset_launches()
    b2 = cim_ops.cim_matmul_packed(x, *args)
    b4 = cim_ops.cim_matmul_packed(x, *args, tile_nz=op["plane_tile_nz"])
    b5 = cim_ops.cim_matmul(x, i8["splanes"], i8["scale"])
    assert {k_: v for k_, v in cim_ops.LAUNCHES.items() if v} == {"B2": 1, "B4": 1, "B5": 1}
    want = cim_ref.cim_matmul_packed(x, *args)
    want5 = cim_ref.cim_matmul(x, i8["splanes"], i8["scale"])
    torch.cuda.synchronize()
    w_abs = cim_ref.unpack_weights(*args[:2], k).abs() * op["scale"]
    assert b2.shape == (m, VOCAB)
    assert bool(((b2 - want).abs() <= 2 * F32_EPS * k * (x.abs() @ w_abs)).all())
    assert torch.equal(b4, b2)
    w8_abs = q.float() * i8["scale"]
    assert bool(((b5 - want5).abs() <= 2 * F32_EPS * k * (x.abs() @ w8_abs)).all())


def _cuda(t):
    return tree.tree_map(lambda a: a.to("cuda"), t)


@pytest.fixture(scope="module", params=["seamless-m4t-medium", "internvl2-76b"])
def reduced_family(request):
    """A reduced family (f32) planned on the CPU and on the card, and a
    batch of 12 positions (internvl2: 8 prefix positions + 4 tokens)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _util.full_f32_matmuls()
    cfg = get_arch(request.param, reduced=True)
    params = api.init(prng.PRNGKey(0), cfg, device="cpu")
    pcfg = planner.PlannerConfig(p_stuck=0.5, min_size=256)
    plan = planner.build_deployment(params, planner.CrossbarSpec(), pcfg, device="cpu")
    card_plan = planner.build_deployment(_cuda(params), planner.CrossbarSpec(), pcfg,
                                         device="cuda")
    batch = api.make_batch(cfg, prng.PRNGKey(0), 4, 12, device="cpu")
    return cfg, params, plan, card_plan, batch


@pytest.mark.cuda
@pytest.mark.parametrize("materialize,codec,kernel", [
    ("packed", "raw", "B2"), ("packed", "const_rle", "B4"), ("planes_int8", "raw", "B5")])
def test_family_served_on_the_card_equals_the_cpu(reduced_family, materialize, codec, kernel):
    """The reduced family (f32) from its deployed bits, planned on the card:
    the card's plan equals the CPU's, the decode graph's tokens equal the
    eager loop's and those of the CPU's plan served on the CPU; an eager
    generate launches the CIM kernel (prefill + (gen - 1) decode steps)
    on the FMA kernels, and B3 at head dim 16 once a self-attention layer
    in its prefill (the encoder's bidir and the decoder's causal); the
    cross-attention is blockwise_attention, once a decoder layer."""
    cfg, params, plan, card_plan, batch = reduced_family
    for name, r in plan.reports.items():
        assert card_plan.reports[name].transitions_final == r.transitions_final, name
    gen = 6
    cpu_p = planner.deploy_params(params, plan, materialize=materialize, codec=codec)
    want, _ = serve.generate(cfg, cpu_p, batch, gen_len=gen)
    p = planner.deploy_params(_cuda(params), card_plan, materialize=materialize, codec=codec)
    b = _cuda(batch)
    toks = {loop: serve.generate(cfg, p, b, gen_len=gen, loop=loop)[0] for loop in serve.LOOPS}
    assert torch.equal(toks["scan"], toks["python"])
    assert torch.equal(toks["scan"].cpu(), want)
    run = serve.make_generator(cfg, p, b, gen_len=gen, loop="python")
    cim_ops.reset_launches()
    fa_ops.reset_launches()
    calls = attention.blockwise_attention.calls
    run()
    if cfg.encdec:
        prefill_ = 1 + 7 * cfg.n_enc_layers + 11 * cfg.n_layers + 1
        step, b3, plain = 9 * cfg.n_layers + 1, cfg.n_enc_layers + cfg.n_layers, cfg.n_layers
    else:
        prefill_, step, b3, plain = 7 * cfg.n_layers + 1, 7 * cfg.n_layers + 1, cfg.n_layers, 0
    assert cim_ops.LAUNCHES[kernel] == prefill_ + step * (gen - 1)
    assert cim_ops.LAUNCHES[f"{kernel}_tc"] == 0
    assert fa_ops.LAUNCHES == {"B3": b3, "B3_tc": 0}
    assert attention.blockwise_attention.calls - calls == plain
