"""xlstm-350m's path on the card: B2/B4/B5 at the mLSTM projections'
shapes (``w_if`` [1024, 8]: N = 8, the narrowest N a served model gives
them, on the non-vectorized branches; ``wq`` [2048, 2048]), the reduced
model's mLSTM and sLSTM blocks and steps against the same calls on the
CPU, and the reduced model served from its bits through the decode graph.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the reference
package: ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_xlstm_cuda.py``.

Tolerances: the CIM kernels within 2 * eps_f32 * K * (|x| @ |w|) of their
plain versions (the same exact products summed in another order), B4
equal to B2 bit for bit on the same bits; the blocks and steps (float32,
TF32 off) within 2e-5 absolute + relative of the CPU; served tokens: the
decode graph equals the eager loop and the CPU's tokens of the same plan.
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
from repro_torch.launch import serve
from repro_torch.models import api, ssm
from repro_torch.models.transformer import layer_slice

F32_EPS = torch.finfo(torch.float32).eps
TOL = 2e-5
XLSTM_SHAPES = ((1024, 8), (2048, 2048))  # K x N of w_if and wq


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _util.full_f32_matmuls()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", XLSTM_SHAPES)
@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cim_kernels_at_the_xlstm_projections(cuda_device, k, n, m, dtype):
    """B2, B4 (~half the tiles zero) and B5 at w_if's and wq's shapes within
    the bound of the plain versions; bf16 x on the tensor-core kernels, f32
    x on the FMA kernels."""
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
def reduced_xlstm():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _util.full_f32_matmuls()
    cfg = get_arch("xlstm-350m", reduced=True)  # float32, chunk 8, 3 mlstm + 1 slstm
    params = api.init(prng.PRNGKey(0), cfg, device="cpu")
    plan = planner.build_deployment(params, planner.CrossbarSpec(),
                                    planner.PlannerConfig(p_stuck=0.5, min_size=256),
                                    device="cpu")
    card_plan = planner.build_deployment(_cuda(params), planner.CrossbarSpec(),
                                         planner.PlannerConfig(p_stuck=0.5, min_size=256),
                                         device="cuda")
    batch = api.make_batch(cfg, prng.PRNGKey(0), 4, 11, device="cpu")
    return cfg, params, plan, card_plan, batch


def _cuda(t):
    return tree.tree_map(lambda a: a.to("cuda"), t)


def _cpu(t):
    if isinstance(t, (tuple, list)):
        return [_cpu(v) for v in t]
    return tree.tree_map(lambda a: a.cpu(), t)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_on_the_card_match_the_cpu(reduced_xlstm, kind):
    """Each block over 11 positions (the mLSTM's second chunk padded) with
    its prompt cache, then one step written into that cache in place: the
    card's outputs and caches against the CPU's."""
    cfg, params, _, _, _ = reduced_xlstm
    seg, fwd, step = ((0, ssm.mlstm_block_fwd, ssm.mlstm_block_step) if kind == "mlstm"
                      else (1, ssm.slstm_block_fwd, ssm.slstm_block_step))
    p = layer_slice(params["segments"][seg], 0)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 11, cfg.d_model, generator=g)
    x1 = torch.randn(2, 1, cfg.d_model, generator=g)
    out = {}
    for dev, pp in (("cpu", p), ("cuda", _cuda(p))):
        y, cache = fwd(pp, cfg, x.to(dev), return_cache=True)
        y1 = step(pp, cfg, x1.to(dev), cache, 11)
        out[dev] = (y, y1, cache)
    for got, want in zip(tree.leaves(_cpu(out["cuda"])), tree.leaves(out["cpu"])):
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("materialize,codec,kernel", [
    ("packed", "raw", "B2"), ("packed", "const_rle", "B4"), ("planes_int8", "raw", "B5")])
def test_xlstm_served_on_the_card_equals_the_cpu(reduced_xlstm, materialize, codec, kernel):
    """The reduced xlstm (f32) from its deployed bits, planned on the card:
    the decode graph's tokens equal the eager loop's and those of the CPU's
    plan served on the CPU; an eager generate launches the CIM kernel (6 x
    3 + 2 x 1 + 1) x gen times on the FMA kernels and no B3."""
    cfg, params, plan, card_plan, batch = reduced_xlstm
    gen = 8
    cpu_p = planner.deploy_params(params, plan, materialize=materialize, codec=codec)
    want, _ = serve.generate(cfg, cpu_p, batch, gen_len=gen)
    p = planner.deploy_params(_cuda(params), card_plan, materialize=materialize, codec=codec)
    b = {"tokens": batch["tokens"].cuda()}
    toks = {loop: serve.generate(cfg, p, b, gen_len=gen, loop=loop)[0] for loop in serve.LOOPS}
    assert torch.equal(toks["scan"], toks["python"])
    assert torch.equal(toks["scan"].cpu(), want)
    step = serve.make_generator(cfg, p, b, gen_len=gen, loop="python")
    cim_ops.reset_launches()
    fa_ops.reset_launches()
    step()
    assert cim_ops.LAUNCHES[kernel] == (6 * 3 + 2 * 1 + 1) * gen
    assert cim_ops.LAUNCHES[f"{kernel}_tc"] == 0
    assert fa_ops.LAUNCHES == {"B3": 0, "B3_tc": 0}
