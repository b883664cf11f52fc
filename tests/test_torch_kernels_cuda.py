"""Kernels B3 (flash attention) and B6 (bitslice) against their plain
versions on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the reference
package, so it also runs where only the port is installed:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``.

Tolerances: B3 in float32 within 2e-5 (absolute + relative, as the
reference holds its Pallas kernel to its oracle: both sum in f32 in
another order); in bfloat16 within one bf16 ulp of the output plus that
(both round an f32 result to bf16).  B6 is exact.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.core import simulator
from repro_torch.kernels.bitslice import ops as bs_ops
from repro_torch.kernels.bitslice import ref as bs_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

TOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def attention_bound(want: torch.Tensor) -> torch.Tensor:
    """Allowed |kernel - plain| per element for ``want``'s dtype."""
    w = want.float().abs()
    bound = TOL + TOL * w
    if want.dtype == torch.bfloat16:
        ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(
            w.clamp_min(torch.finfo(torch.float32).tiny))))
        bound = bound + ulp
    return bound


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (2, 4, 1, 37, 50, 128), (2, 8, 2, 64, 64, 256), (1, 4, 4, 16, 200, 128),
    (2, 4, 1, 40, 70, 256), (2, 32, 4, 32, 32, 128),
])
@pytest.mark.parametrize("kind", ["causal", "bidir", "swa"])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, b, hq, hkv, sq, sk, d, kind,
                                              per_row, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(b + hq + sq + sk + d)
    q = torch.randn(b, hq, sq, d, device=cuda_device, generator=g).to(dtype)
    k = torch.randn(b, hkv, sk, d, device=cuda_device, generator=g).to(dtype)
    v = torch.randn(b, hkv, sk, d, device=cuda_device, generator=g).to(dtype)
    if per_row:
        # each row's queries are the last sq positions of its live extent,
        # so every row sees at least one key
        kvl = torch.randint(max(sq, 1), sk + 1, (b,), device=cuda_device, generator=g)
        off = torch.clamp(kvl - sq, min=0)
    else:
        kvl, off = None, max(0, sk - sq)
    window = 16 if kind == "swa" else None
    got = fa_ops.flash_attention(q, k, v, kvl, kind=kind, window=window, q_offset=off)
    want = fa_ref.flash_attention(q, k, v, kvl, kind=kind, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(((got.float() - want.float()).abs() <= attention_bound(want)).all())


@pytest.mark.cuda
def test_flash_attention_kernel_counts_launches(cuda_device):
    q = torch.randn(1, 2, 8, 128, device=cuda_device)
    k = torch.randn(1, 1, 8, 128, device=cuda_device)
    fa_ops.reset_launches()
    fa_ref.flash_attention.calls = 0
    fa_ops.flash_attention(q, k, k)
    assert fa_ops.LAUNCHES["B3"] == 1 and fa_ref.flash_attention.calls == 0


def _weights_with_ties(shape, inv_scale, device, seed):
    """Random weights with exact .5 ties of |w| * inv_scale and -0.0 planted."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(shape, device=device, generator=g) * 0.05
    flat = w.view(-1)
    n_ties = flat.numel() // 7
    idx = torch.randint(0, flat.numel(), (n_ties,), device=device, generator=g)
    half = torch.randint(0, 1023, (n_ties,), device=device, generator=g).float() + 0.5
    sign = torch.where(torch.rand(n_ties, device=device, generator=g) < 0.5, -1.0, 1.0)
    flat[idx] = sign * half / inv_scale
    flat[:8] = -0.0
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (37, 130), (256, 2048), (3, 64, 96)])
@pytest.mark.parametrize("cols", [1, 8, 10])
def test_bitslice_kernel_matches_plain(cuda_device, shape, cols):
    inv = 512.0  # a power of two: |w| * inv is exact, so the planted ties stay .5
    w = _weights_with_ties(shape, inv, cuda_device, seed=sum(shape) + cols)
    inv_t = torch.tensor(inv, device=cuda_device)
    got = bs_ops.bitslice_planes(w, inv_t, cols)
    want = bs_ref.bitslice_planes(w, inv_t, cols)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == want.shape == shape[:-2] + (cols,) + shape[-2:]
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_bitslice_kernel_builds_planner_operands(cuda_device):
    """``operands_from_dense(planes_int8)`` on the card (B6) equals the
    previous route, q = round(|w_hat| / scale), on deployed-like weights."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    scale = 0.15 / 1023
    q = torch.randint(0, 1024, (2, 300, 130), device=cuda_device, generator=g)
    s = torch.where(torch.rand(q.shape, device=cuda_device, generator=g) < 0.5, -1, 1)
    w_hat = (q * s).float() * torch.tensor(scale, dtype=torch.float32, device=cuda_device)
    bs_ops.reset_launches()
    op = simulator.operands_from_dense(w_hat, scale, 0.0, "sign_magnitude", 10,
                                       materialize="planes_int8")
    assert bs_ops.LAUNCHES["B6"] == 1
    old = simulator.int8_plane_operands(q.int(), s.to(torch.int8), scale, 0.0, 10)
    assert torch.equal(op["splanes"], old["splanes"])
