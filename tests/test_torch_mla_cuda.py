"""deepseek-v2-236b's kernels on the card: the grouped B2/B4 (bit-packed
matmul) and B5 (int8-plane matmul) launches over 160 experts, the planner's
SWS sort kernel, and the reduced MLA + MoE model served from its bits.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the reference
package: ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_mla_cuda.py``.

Tolerances: a grouped launch within the kernels' bound 2 * eps_f32 * K *
(|x| @ |w|) of its plain version (the same exact products summed in
another order); B4 equals B2 bit for bit on the same bits; the sort
kernel's permutation equals ``torch.sort(stable=True)``'s bit for bit;
served tokens: the decode graph equals the eager loop.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core import planes, planner, simulator
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul import ref as cim_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.sws_sort import ops as sort_ops
from repro_torch.kernels.sws_sort import ref as sort_ref
from repro_torch.launch import serve
from repro_torch.models import api

F32_EPS = torch.finfo(torch.float32).eps
G = 160  # deepseek-v2-236b's routed experts
# (M, K, N): decode / prefill capacity 8 at wi_gate's and wo's shapes, K cut
# by 4 (the layout is the full one's), and the full wi_gate shape
GROUPED = [(8, 1280, 1536), (8, 1536, 1280), (8, 5120, 1536)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _stack(k, n, dev, seed):
    """G packed stacks with about half of their (plane, 128-row) tiles zero
    (const_rle flags); the int8 planes of the integers before the zeroing,
    with their |w|; the generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(0, 1024, (G, k, n), dtype=torch.int32, device=dev, generator=gen)
    s = torch.where(torch.rand(G, k, n, device=dev, generator=gen) < 0.5, -1, 1).to(torch.int8)
    scale = 0.02 / 1023 * (1 + torch.arange(G, dtype=torch.float32, device=dev) / G)
    op = simulator.packed_operands(q, s, scale, torch.zeros(G, device=dev), 10)
    dead = torch.rand(G, 10, -(-k // 128), device=dev, generator=gen) < 0.5
    rows = dead.repeat_interleave(16, dim=-1)[..., : op["planes_packed"].shape[-2]]
    op["planes_packed"] = op["planes_packed"] * (~rows)[..., None]
    op = planes.encode_operands(op, "const_rle")
    w8_abs = q.float() * scale[:, None, None]
    return op, simulator.int8_plane_operands(q, s, scale, 0.0, 10), w8_abs, gen


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", GROUPED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_kernels_at_160_experts(cuda_device, m, k, n, dtype):
    """B2, B4 (const_rle flags) and B5 each one launch over 160 experts,
    within the bound of the plain version; B4 == B2 on the same bits."""
    dev = cuda_device
    op, i8, w8_abs, gen = _stack(k, n, dev, m + k + n)
    x = torch.randn(G, m, k, device=dev, generator=gen).to(dtype)
    args = (op["planes_packed"], op["sign_packed"], op["scale"])
    w_abs = cim_ref.unpack_weights(*args[:2], k).abs() * op["scale"][:, None, None]
    bound = 2 * F32_EPS * k * (x.float().abs() @ w_abs)
    tc = dtype == torch.bfloat16
    for kernel, call, plain in (
            ("B2", lambda: cim_ops.cim_matmul_packed(x, *args),
             lambda: cim_ref.cim_matmul_packed(x, *args)),
            ("B4", lambda: cim_ops.cim_matmul_packed(x, *args, tile_nz=op["plane_tile_nz"]),
             lambda: cim_ref.cim_matmul_packed(x, *args))):
        cim_ops.reset_launches()
        got = call()
        assert {k_: v for k_, v in cim_ops.LAUNCHES.items() if v} == {
            kernel: 1, **({f"{kernel}_tc": 1} if tc else {})}
        want = plain()
        torch.cuda.synchronize()
        assert got.shape == (G, m, n) and bool(((got - want).abs() <= bound).all())
        if kernel == "B4":
            assert torch.equal(got, cim_ops.cim_matmul_packed(x, *args))
    cim_ops.reset_launches()
    got = cim_ops.cim_matmul(x, i8["splanes"], i8["scale"])
    assert {k_: v for k_, v in cim_ops.LAUNCHES.items() if v} == {
        "B5": 1, **({"B5_tc": 1} if tc else {})}
    want = cim_ref.cim_matmul(x, i8["splanes"], i8["scale"])
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 2 * F32_EPS * k * (x.float().abs() @ w8_abs)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("encoding", ["sign_magnitude", "offset_binary"])
@pytest.mark.parametrize("n,pad", [(1, 127), (1000, 24), (1 << 20, 0), (3_000_001, 63)])
def test_sort_kernel_matches_torch_sort(cuda_device, encoding, n, pad):
    """The SWS sort kernel against torch.sort(stable=True) of the padded
    keys, bit for bit: weights drawn from 64 values of both signs (every
    value tied many times), -0.0 and +0.0 mixed, the zero padding."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(n + pad)
    vals = torch.linspace(-1.0, 1.0, 63, device=dev)
    vals = torch.cat([vals, torch.tensor([-0.0], device=dev)])
    w = vals[torch.randint(0, 64, (n,), device=dev, generator=gen)]
    sort_ops.reset_launches()
    got = sort_ops.sws_argsort(w, n + pad, encoding)
    assert sort_ops.LAUNCHES["SORT"] == 1 and got.dtype == torch.int32
    want = sort_ref.sws_argsort(w, n + pad, encoding)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def reduced_mla():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = get_arch("deepseek-v2-236b", reduced=True)  # float32
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    plan = planner.build_deployment(params, planner.CrossbarSpec(),
                                    planner.PlannerConfig(p_stuck=0.5, min_size=512), device=dev)
    batch = api.make_batch(cfg, prng.PRNGKey(0), 4, 12, device=dev)
    return cfg, params, plan, batch


@pytest.mark.cuda
@pytest.mark.parametrize("materialize,codec,kernel", [
    ("packed", "raw", "B2"), ("packed", "const_rle", "B4"), ("planes_int8", "raw", "B5")])
def test_mla_served_from_the_bits(reduced_mla, materialize, codec, kernel):
    """The reduced deepseek (f32) from its deployed bits: the decode graph's
    tokens equal the eager loop's, and every forward of an eager generate
    launches the CIM kernel once per planned matmul: MLA's wq_a, wq_b,
    wkv_a and wo, the router, the shared GLU (3) and each expert stack (3,
    grouped) a layer, and the head, all on the FMA kernels (f32 x); no B3."""
    cfg, params, plan, batch = reduced_mla
    p = planner.deploy_params(params, plan, materialize=materialize, codec=codec)
    gen = 5
    toks = {loop: serve.generate(cfg, p, batch, gen_len=gen, loop=loop)[0]
            for loop in serve.LOOPS}
    assert torch.equal(toks["scan"], toks["python"])
    step = serve.make_generator(cfg, p, batch, gen_len=gen, loop="python")
    cim_ops.reset_launches()
    fa_ops.reset_launches()
    step()
    assert cim_ops.LAUNCHES[kernel] == (11 * cfg.n_layers + 1) * gen
    assert cim_ops.LAUNCHES[f"{kernel}_tc"] == 0 and fa_ops.LAUNCHES["B3"] == 0
