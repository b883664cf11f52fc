"""Tensor parallelism's shard shapes on the card (marked ``cuda``; skips without a device).

Imports neither JAX nor the reference package, so it runs where only the
port is installed:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_tp_cuda.py``.

The CIM kernels on operands sliced the way ``simulator.shard_operands``
slices them — B2 and B5 on row-parallel (K-sliced, packed bytes) and
column-parallel (N-sliced) shards, B4 on an N-sliced const_rle shard whose
zero-tile flags it keeps — against their plain versions, f32 and bf16 x;
B3 at a shard's local heads (8 q heads, 1 KV head, D = 128, yi-6b at n =
4); and a 2-way ``tp_generate`` of the reduced yi-6b on the card with the
CPU's tokens, graph and eager loop alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core import planes, simulator
from repro_torch.kernels._util import full_f32_matmuls
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul import ref as cim_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import api
from repro_torch.parallel import tp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    full_f32_matmuls()
    return torch.device("cuda")


def _packed(dev, k, n, seed, cols=10):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(0, 2**cols, (k, n), dtype=torch.int32, device=dev, generator=g)
    q = q * (torch.rand(k, n, device=dev, generator=g) < 0.7)  # some all-zero tiles
    sign = torch.where(torch.rand(k, n, device=dev, generator=g) < 0.5, -1, 1).to(torch.int8)
    return q, sign


@pytest.mark.parametrize("axis,n", [(-2, 4), (-2, 2), (-1, 4), (-1, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cim_kernels_on_shard_operands_match_plain(cuda_device, axis, n, dtype):
    dev = cuda_device
    k, nn = 2752 * 2, 512  # yi-6b's mlp/wo K at n = 2; K / 4 = 1376 (not a multiple of 64)
    q, sign = _packed(dev, k, nn, seed=3)
    scale = torch.tensor(0.01, device=dev)
    ops = {
        "B2": simulator.packed_operands(q, sign, scale, 0.0, 10),
        "B4": planes.encode_operands(simulator.packed_operands(q, sign, scale, 0.0, 10),
                                     "const_rle"),
        "B5": simulator.int8_plane_operands(q, sign, scale, 0.0, 10),
    }
    eps = torch.finfo(torch.float32).eps
    g = torch.Generator(device=dev).manual_seed(5)
    for kern, full in ops.items():
        if kern == "B4" and axis == -2:
            continue  # K shards drop the flags: B2 serves them
        for i in range(n):
            op = {f: v.contiguous() for f, v in
                  simulator.shard_operands(full, axis=axis, index=i, n=n).items()}
            if kern == "B5":
                w = (op["splanes"].float() * (2.0 ** torch.arange(10, device=dev))[:, None, None]
                     ).sum(0) * scale
            else:
                w = simulator.densify_operands(op)
            kk = w.shape[0]
            for m in (4, 128):
                x = torch.randn(m, kk, device=dev, generator=g).to(dtype)
                cim_ops.reset_launches()
                if kern == "B5":
                    got = cim_ops.cim_matmul(x, op["splanes"], op["scale"])
                    want = cim_ref.cim_matmul(x, op["splanes"], op["scale"])
                else:
                    args = (x, op["planes_packed"], op["sign_packed"], op["scale"])
                    kw = {"tile_nz": op["plane_tile_nz"]} if "plane_tile_nz" in op else {}
                    got = cim_ops.cim_matmul_packed(*args, **kw)
                    want = cim_ref.cim_matmul_packed(*args)
                assert cim_ops.LAUNCHES[kern] == 1
                assert cim_ops.LAUNCHES[f"{kern}_tc"] == (dtype == torch.bfloat16)
                bound = 2.0 * eps * kk * (x.float().abs() @ w.abs())
                assert bool(((got - want).abs() <= bound).all()), (kern, axis, n, i, m)


@pytest.mark.parametrize("s", [32, 2048])
def test_flash_attention_at_local_heads_matches_plain(cuda_device, s):
    dev = cuda_device
    loc = tp.local_config(get_arch("yi-6b"), tp.plan_tp(get_arch("yi-6b"), 4, packed=True))
    assert (loc.n_heads, loc.n_kv_heads, loc.head_dim) == (8, 1, 128)
    g = torch.Generator(device=dev).manual_seed(s)
    b = 4 if s == 32 else 1
    q = torch.randn(b, 8, s, 128, device=dev, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(b, 1, s, 128, device=dev, generator=g).to(torch.bfloat16)
            for _ in range(2))
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, kind="causal")
    assert dict(fa_ops.LAUNCHES) == {"B3": 1, "B3_tc": 1}
    want = fa_ref.flash_attention(q, k, v, kind="causal")
    assert bool(((got.float() - want.float()).abs() <= fa_ref.attention_bound(want)).all())


def test_tp_generate_on_the_card_matches_the_cpu(cuda_device):
    cfg = dataclasses.replace(get_arch("yi-6b", reduced=True), n_heads=8, n_kv_heads=4,
                              head_dim=16)
    params = api.init(prng.PRNGKey(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 8)).astype(np.int32))
    want, _ = tp.tp_generate(cfg, params, {"tokens": tokens}, n=2, gen_len=8)
    on_card = api.init(prng.PRNGKey(0), cfg, device=cuda_device)
    for loop in ("scan", "python"):
        got, _ = tp.tp_generate(cfg, on_card, {"tokens": tokens.to(cuda_device)}, n=2,
                                gen_len=8, loop=loop)
        assert torch.equal(got.cpu(), want), loop
