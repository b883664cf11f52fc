"""hymba-1.5b's kernels on the card: B3 at head dim 64 with a GQA group of
5 (the bf16 tensor-core kernel and the f32 FMA kernel), B2/B4/B5 at the
Mamba projections' shapes no other served model reaches (``x_proj`` [3200,
132]: N not a multiple of 16; ``dt_proj`` [100, 3200]: K not a multiple of
8), and a reduced hymba served from its bits through the decode graph.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the reference
package: ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_hymba_cuda.py``.

Tolerances: B3 within ``ref.attention_bound`` of its plain version (2e-5
abs + rel; bf16 outputs one bf16 ulp more); the CIM kernels within 2 *
eps_f32 * K * (|x| @ |w|) of theirs (the same exact products summed in
another order), B4 equal to B2 bit for bit on the same bits; served tokens:
the decode graph equals the eager loop.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core import planes, planner, simulator
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul import ref as cim_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve
from repro_torch.models import api

F32_EPS = torch.finfo(torch.float32).eps
HQ, HKV, D = 25, 5, 64  # hymba-1.5b's attention
MAMBA_SHAPES = ((3200, 132), (100, 3200))  # K x N of x_proj and dt_proj


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["causal", "swa", "bidir"])
@pytest.mark.parametrize("b,s,per_row", [(4, 160, False), (1, 2048, False), (4, 160, True),
                                         (2, 37, False)])
def test_flash_attention_head_dim_64(cuda_device, dtype, kind, b, s, per_row):
    """B3 at D = 64, 25 query heads over 5 KV heads, against its plain
    version: bf16 on the tensor-core kernel, f32 on the FMA kernel; swa at
    hymba's window 1024; per-row q_offset / kv_valid_len tensors on a cache
    view 64 slots longer than the queries."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(b * s + int(per_row))
    sk = s + 64 if per_row else s
    q = torch.randn(b, HQ, s, D, device=dev, generator=g).to(dtype)
    k = torch.randn(b, HKV, sk, D, device=dev, generator=g).to(dtype)
    v = torch.randn(b, HKV, sk, D, device=dev, generator=g).to(dtype)
    if per_row:
        kvl = torch.randint(s, sk + 1, (b,), device=dev, generator=g, dtype=torch.int32)
        off = kvl - s
    else:
        kvl, off = None, 0
    window = 1024 if kind == "swa" else None
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, kvl, kind=kind, window=window, q_offset=off)
    assert fa_ops.LAUNCHES == {"B3": 1, "B3_tc": int(dtype == torch.bfloat16)}
    want = fa_ref.flash_attention(q, k, v, kvl, kind=kind, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(((got.float() - want.float()).abs() <= fa_ref.attention_bound(want)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MAMBA_SHAPES)
@pytest.mark.parametrize("m", [4, 640])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cim_kernels_at_the_mamba_projections(cuda_device, k, n, m, dtype):
    """B2, B4 (~half the tiles zero) and B5 at x_proj's and dt_proj's shapes
    (the non-vectorized branches) within the bound of the plain versions;
    bf16 x on the tensor-core kernels, f32 x on the FMA kernels."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(k + n + m)
    q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=dev, generator=gen)
    s = torch.where(torch.rand(k, n, device=dev, generator=gen) < 0.5, -1, 1).to(torch.int8)
    op = simulator.packed_operands(q, s, 0.02 / 1023, 0.0, 10)
    dead = torch.rand(10, -(-k // 128), device=dev, generator=gen) < 0.5
    rows = dead.repeat_interleave(16, dim=1)[:, : op["planes_packed"].shape[1]]
    op["planes_packed"] = op["planes_packed"] * (~rows)[:, :, None]
    op = planes.encode_operands(op, "const_rle")
    i8 = simulator.int8_plane_operands(q, s, 0.02 / 1023, 0.0, 10)
    x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
    args = (op["planes_packed"], op["sign_packed"], op["scale"])
    w_abs = cim_ref.unpack_weights(*args[:2], k).abs() * op["scale"]
    bound = 2 * F32_EPS * k * (x.float().abs() @ w_abs)
    tc = dtype == torch.bfloat16
    cim_ops.reset_launches()
    b2 = cim_ops.cim_matmul_packed(x, *args)
    b4 = cim_ops.cim_matmul_packed(x, *args, tile_nz=op["plane_tile_nz"])
    b5 = cim_ops.cim_matmul(x, i8["splanes"], i8["scale"])
    assert {k_: v for k_, v in cim_ops.LAUNCHES.items() if v} == {
        "B2": 1, "B4": 1, "B5": 1, **({"B2_tc": 1, "B4_tc": 1, "B5_tc": 1} if tc else {})}
    want = cim_ref.cim_matmul_packed(x, *args)
    want5 = cim_ref.cim_matmul(x, i8["splanes"], i8["scale"])
    torch.cuda.synchronize()
    assert b2.shape == (m, n) and bool(((b2 - want).abs() <= bound).all())
    assert torch.equal(b4, b2)
    w8_abs = q.float() * i8["scale"]
    assert bool(((b5 - want5).abs() <= 2 * F32_EPS * k * (x.float().abs() @ w8_abs)).all())


@pytest.fixture(scope="module")
def reduced_hymba():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = get_arch("hymba-1.5b", reduced=True)  # float32, head dim 16, window 16
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    plan = planner.build_deployment(params, planner.CrossbarSpec(),
                                    planner.PlannerConfig(p_stuck=0.5, min_size=512), device=dev)
    batch = api.make_batch(cfg, prng.PRNGKey(0), 4, 12, device=dev)
    return cfg, params, plan, batch


@pytest.mark.cuda
@pytest.mark.parametrize("materialize,codec,kernel", [
    ("packed", "raw", "B2"), ("packed", "const_rle", "B4"), ("planes_int8", "raw", "B5")])
def test_hymba_decode_graph_equals_eager_loop(reduced_hymba, materialize, codec, kernel):
    """The reduced hymba (f32) from its deployed bits, 8 meta + 12 prompt +
    10 generated positions past its window of 16 (the ring wraps): the
    decode graph's tokens equal the eager loop's; every forward of an eager
    generate launches the CIM kernel once per planned matmul (wq, wk, wv,
    wo, in_proj, x_proj, dt_proj, out_proj and the MLP's 3 a layer, and the
    head) on the FMA kernels, and B3 once a layer a prefill."""
    cfg, params, plan, batch = reduced_hymba
    p = planner.deploy_params(params, plan, materialize=materialize, codec=codec)
    gen = 10
    toks = {loop: serve.generate(cfg, p, batch, gen_len=gen, loop=loop)[0]
            for loop in serve.LOOPS}
    assert torch.equal(toks["scan"], toks["python"])
    step = serve.make_generator(cfg, p, batch, gen_len=gen, loop="python")
    cim_ops.reset_launches()
    fa_ops.reset_launches()
    step()
    assert cim_ops.LAUNCHES[kernel] == (11 * cfg.n_layers + 1) * gen
    assert cim_ops.LAUNCHES[f"{kernel}_tc"] == 0
    assert fa_ops.LAUNCHES == {"B3": cfg.n_layers, "B3_tc": 0}


@pytest.mark.cuda
def test_hymba_bf16_at_head_dim_64_graph_equals_eager(cuda_device):
    """A small bf16 hymba at head dim 64 (B3 on the tensor cores, 4 query
    heads over 2) served packed past its window: graph == eager loop, B3_tc
    once a layer a prefill."""
    dev = cuda_device
    cfg = dataclasses.replace(get_arch("hymba-1.5b", reduced=True), head_dim=64,
                              dtype="bfloat16")
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    plan = planner.build_deployment(params, planner.CrossbarSpec(),
                                    planner.PlannerConfig(p_stuck=0.5, min_size=512), device=dev)
    p = planner.deploy_params(params, plan, materialize="packed")
    batch = api.make_batch(cfg, prng.PRNGKey(0), 4, 12, device=dev)
    toks = {loop: serve.generate(cfg, p, batch, gen_len=10, loop=loop)[0]
            for loop in serve.LOOPS}
    assert torch.equal(toks["scan"], toks["python"])
    step = serve.make_generator(cfg, p, batch, gen_len=10, loop="python")
    fa_ops.reset_launches()
    step()
    assert fa_ops.LAUNCHES == {"B3": cfg.n_layers, "B3_tc": cfg.n_layers}
