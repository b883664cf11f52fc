"""The grouped launches of B2/B4 (bit-packed matmul) and B5 (int8-plane
matmul) over a MoE layer's expert axis, and the MoE model served from the
deployed bits, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the reference
package: ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_moe_cuda.py``.

Tolerances: a grouped launch equals G single launches bit for bit where
both take the same launch plan (the same K splits), else within the
kernels' bound 2 * eps_f32 * K * (|x| @ |w|) (the same exact products
summed in another order), as it is of the plain version.  B4 equals B2 bit
for bit.  Served tokens: the decode graph equals the eager loop.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import prng, tree
from repro_torch.configs import get_arch
from repro_torch.core import planes, planner, simulator
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul import ref as cim_ref
from repro_torch.launch import serve
from repro_torch.models import api

F32_EPS = torch.finfo(torch.float32).eps
# (G, M, K, N): reduced-width stacks, ragged K / N, M past one tensor-core
# tile, and one qwen2-moe-a2.7b wi_gate stack at prefill capacity
GROUPED = [(8, 8, 256, 176), (8, 11, 176, 256), (3, 70, 300, 90), (5, 4, 1001, 333),
           (64, 11, 2048, 1408)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _packed_stack(g_, k, n, dev, seed, zero_share=0.0, ids=False):
    """G const_rle-flagged packed operand dicts stacked on a group axis, with
    about ``zero_share`` of their (plane, 128-row) tiles zero."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(0, 1024, (g_, k, n), dtype=torch.int32, device=dev, generator=gen)
    s = torch.where(torch.rand(g_, k, n, device=dev, generator=gen) < 0.5, -1, 1).to(torch.int8)
    scale = 0.02 / 1023 * (1 + torch.arange(g_, dtype=torch.float32, device=dev))
    op = simulator.packed_operands(q, s, scale, torch.zeros(g_, device=dev), 10)
    if zero_share:
        dead = torch.rand(g_, 10, -(-k // 128), device=dev, generator=gen) < zero_share
        rows = dead.repeat_interleave(16, dim=-1)[..., : op["planes_packed"].shape[-2]]
        op["planes_packed"] = op["planes_packed"] * (~rows)[..., None]
    op = planes.encode_operands(op, "const_rle")
    if ids:
        op["plane_ids"] = torch.stack([torch.randperm(10, generator=torch.Generator().manual_seed(
            seed + i)) for i in range(g_)]).to(dev, torch.int32)
    return op


def _bound(x, w_abs):
    return 2 * F32_EPS * x.shape[-1] * (x.float().abs() @ w_abs)


def _same_plan(plan, g_) -> bool:
    """A grouped launch of G takes the single launch's plan (its K splits)."""
    return plan(1) == plan(g_)


@pytest.mark.cuda
@pytest.mark.parametrize("g_,m,k,n", GROUPED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip", [False, True])
def test_grouped_packed_matches_single_launches(cuda_device, g_, m, k, n, dtype, skip):
    """B2 (skip False) and B4 (about half the tiles zero, permuted plane_ids)
    as one grouped launch: equal to G single launches (bit for bit on the
    same plan), within the bound of the plain version, B4 == B2."""
    dev = cuda_device
    op = _packed_stack(g_, k, n, dev, g_ + m + k + n, zero_share=0.5 if skip else 0.0, ids=skip)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(g_, m, k, device=dev, generator=gen).to(dtype)
    ids = op.get("plane_ids")
    flags = op["plane_tile_nz"] if skip else None
    args = (op["planes_packed"], op["sign_packed"], op["scale"])
    cim_ops.reset_launches()
    got = cim_ops.cim_matmul_packed(x, *args, tile_nz=flags, plane_ids=ids)
    kernel = "B4" if skip else "B2"
    tc = {f"{kernel}_tc": 1} if dtype == torch.bfloat16 else {}
    assert {k_: v for k_, v in cim_ops.LAUNCHES.items() if v} == {kernel: 1, **tc}
    single = torch.stack([cim_ops.cim_matmul_packed(
        x[i], *(a[i] for a in args), tile_nz=None if flags is None else flags[i],
        plane_ids=None if ids is None else ids[i]) for i in range(g_)])
    want = cim_ref.cim_matmul_packed(x, *args, ids)
    torch.cuda.synchronize()
    w_abs = cim_ref.unpack_weights(*args[:2], k, ids).abs() * op["scale"][:, None, None]
    bound = _bound(x, w_abs)
    assert got.shape == (g_, m, n) and bool(((got - want).abs() <= bound).all())
    if dtype == torch.bfloat16:
        plan = lambda gr: cim_ops.tc_packed_launch_plan(m, k, n, _sms(dev), gr)  # noqa: E731
    else:
        plan = lambda gr: cim_ops.launch_plan(m, k, n, _sms(dev), groups=gr)  # noqa: E731
    if _same_plan(plan, g_):
        assert torch.equal(got, single)
    else:
        assert bool(((got - single).abs() <= 2 * bound).all())
    if skip:
        b2 = cim_ops.cim_matmul_packed(x, *args, plane_ids=ids)
        assert torch.equal(got, b2)


@pytest.mark.cuda
@pytest.mark.parametrize("g_,m,k,n", GROUPED[:4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fused_dequant", "planes"])
def test_grouped_planes_matches_single_launches(cuda_device, g_, m, k, n, dtype, mode):
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(g_ + m + k + n)
    q = torch.randint(0, 1024, (g_, k, n), dtype=torch.int32, device=dev, generator=gen)
    s = torch.where(torch.rand(g_, k, n, device=dev, generator=gen) < 0.5, -1, 1).to(torch.int8)
    scale = 0.02 / 1023 * (1 + torch.arange(g_, dtype=torch.float32, device=dev))
    op = simulator.int8_plane_operands(q, s, scale, 0.0, 10)
    x = torch.randn(g_, m, k, device=dev, generator=gen).to(dtype)
    cim_ops.reset_launches()
    got = cim_ops.cim_matmul(x, op["splanes"], op["scale"], mode=mode)
    tc = dtype == torch.bfloat16 and mode == "fused_dequant"
    want = {"B5": 1, **({"B5_tc": 1} if tc else {})}
    assert {k_: v for k_, v in cim_ops.LAUNCHES.items() if v} == want
    single = torch.stack([cim_ops.cim_matmul(x[i], op["splanes"][i], op["scale"][i], mode=mode)
                          for i in range(g_)])
    want = cim_ref.cim_matmul(x, op["splanes"], op["scale"], mode)
    torch.cuda.synchronize()
    bound = _bound(x, q.float() * scale[:, None, None])
    assert got.shape == (g_, m, n) and bool(((got - want).abs() <= bound).all())
    if tc:
        plan = lambda gr: cim_ops.tc_launch_plan(m, k, n, 10, _sms(dev), gr)  # noqa: E731
    else:
        plan = lambda gr: cim_ops.launch_plan(m, k, n, _sms(dev), 4, gr)  # noqa: E731
    if _same_plan(plan, g_):
        assert torch.equal(got, single)
    else:
        assert bool(((got - single).abs() <= 2 * bound).all())


@pytest.mark.cuda
def test_grouped_launch_refuses_bad_shapes(cuda_device):
    op = _packed_stack(4, 64, 32, cuda_device, 0)
    x = torch.randn(3, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="lead"):
        cim_ops.cim_matmul_packed(x, op["planes_packed"], op["sign_packed"], op["scale"])
    x = torch.randn(4, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="scale"):
        cim_ops.cim_matmul_packed(x, op["planes_packed"], op["sign_packed"], op["scale"][0])


@pytest.fixture(scope="module")
def reduced_moe():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = get_arch("qwen2-moe-a2.7b", reduced=True)  # float32: B3's bf16 kernel takes no D = 16
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    plan = planner.build_deployment(params, planner.CrossbarSpec(),
                                    planner.PlannerConfig(p_stuck=0.5, min_size=1024), device=dev)
    batch = api.make_batch(cfg, prng.PRNGKey(0), 4, 12, device=dev)
    return cfg, params, plan, batch


@pytest.mark.cuda
@pytest.mark.parametrize("materialize,codec,kernel", [
    ("packed", "raw", "B2"), ("packed", "const_rle", "B4"), ("planes_int8", "raw", "B5")])
def test_moe_served_from_the_bits(reduced_moe, materialize, codec, kernel):
    """The reduced MoE (f32) from its deployed bits: the decode graph's
    tokens equal the eager loop's, and every forward of an eager generate
    launches the CIM kernel once per planned matmul: q/k/v/o, the router,
    the shared GLU (3) and each expert stack (3, grouped) a layer, and the
    head, all on the FMA kernels (f32 x)."""
    cfg, params, plan, batch = reduced_moe
    p = planner.deploy_params(params, plan, materialize=materialize, codec=codec)
    gen = 5
    toks = {loop: serve.generate(cfg, p, batch, gen_len=gen, loop=loop)[0]
            for loop in serve.LOOPS}
    assert torch.equal(toks["scan"], toks["python"])
    step = serve.make_generator(cfg, p, batch, gen_len=gen, loop="python")
    cim_ops.reset_launches()
    step()
    per_step = 11 * cfg.n_layers + 1
    assert cim_ops.LAUNCHES[kernel] == per_step * gen
    assert cim_ops.LAUNCHES[f"{kernel}_tc"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 3)])
def test_sharded_dispatch_served_on_the_card(reduced_moe, shape):
    """The sharded MoE dispatch (EP at (2, 2) and (1, 4), expert-TP at
    (2, 3)) on the card: the decode graph captured under the mesh gives the
    eager loop's tokens and the CPU's (f32), the generator refuses to
    replay it once the mesh is cleared, and a graph captured unsharded
    refuses to run under the mesh."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    cfg, params, plan, batch = reduced_moe
    p = planner.deploy_params(params, plan, materialize="dense")
    unsharded = serve.make_generator(cfg, p, batch, gen_len=5)
    moe.set_moe_distribution(make_mesh(shape, ("data", "model")))
    try:
        graph = serve.make_generator(cfg, p, batch, gen_len=5)
        assert graph.decode is not None and graph.decode.replays == 1
        toks = graph()[0]
        eager = serve.generate(cfg, p, batch, gen_len=5, loop="python")[0]
        cpu = serve.generate(cfg, tree.tree_map(lambda v: v.cpu(), p),
                             tree.tree_map(lambda v: v.cpu(), batch), gen_len=5)[0]
        assert torch.equal(toks, eager) and torch.equal(toks.cpu(), cpu)
        with pytest.raises(RuntimeError, match="MoE distribution"):
            unsharded()
    finally:
        moe.set_moe_distribution(None)
    with pytest.raises(RuntimeError, match="MoE distribution"):
        graph()
    unsharded()

