"""Kernels B2/B4 (bit-packed matmul; B2 also with drift gains), B3 (flash
attention), B5 (int8-plane matmul) and B6 (bitslice) against their plain
versions on the card (B3's f32 kernel also at the reduced configs' head
dims 16, 20 and 32).

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the reference
package, so it also runs where only the port is installed:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``.

Tolerances: B3 in float32 within 2e-5 (absolute + relative, as the
reference holds its Pallas kernel to its oracle: both sum in f32 in
another order); in bfloat16 within one bf16 ulp of the output plus that
(both round an f32 result to bf16).  B2, B4 and B5 within
2 * eps_f32 * K * (|x| @ |w|) (the kernel and the plain version sum the same
exact products in another order), and B4 equal to B2 bit for bit.  B6 is
exact.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.core import planes, simulator
from repro_torch.kernels.bitslice import ops as bs_ops
from repro_torch.kernels.bitslice import ref as bs_ref
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul import ref as cim_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

TOL = 2e-5
F32_EPS = torch.finfo(torch.float32).eps


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
    (2, 4, 1, 40, 70, 256), (2, 32, 4, 32, 32, 128), (4, 8, 1, 32, 32, 256),
    (2, 16, 2, 40, 100, 128),  # a packed GQA group of 320 rows spans three tiles
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
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (8, 4, 2, 64, 64, 16),  # the trained LM's evaluation forward (reduced internlm2)
    (2, 4, 1, 37, 50, 16), (2, 4, 2, 40, 100, 20), (2, 8, 1, 33, 70, 32), (1, 4, 4, 16, 200, 20),
])
@pytest.mark.parametrize("kind", ["causal", "bidir", "swa"])
@pytest.mark.parametrize("per_row", [False, True])
def test_flash_attention_kernel_small_head_dims(cuda_device, b, hq, hkv, sq, sk, d, kind,
                                                per_row):
    """The f32 FMA kernel at the reduced configs' head dims (one output
    column a lane, the lanes past D idle)."""
    g = torch.Generator(device=cuda_device).manual_seed(b + hq + sq + sk + d)
    q = torch.randn(b, hq, sq, d, device=cuda_device, generator=g)
    k = torch.randn(b, hkv, sk, d, device=cuda_device, generator=g)
    v = torch.randn(b, hkv, sk, d, device=cuda_device, generator=g)
    if per_row:
        kvl = torch.randint(max(sq, 1), sk + 1, (b,), device=cuda_device, generator=g)
        off = torch.clamp(kvl - sq, min=0)
    else:
        kvl, off = None, max(0, sk - sq)
    window = 16 if kind == "swa" else None
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, kvl, kind=kind, window=window, q_offset=off)
    assert fa_ops.LAUNCHES == {"B3": 1, "B3_tc": 0}
    want = fa_ref.flash_attention(q, k, v, kvl, kind=kind, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(((got - want).abs() <= attention_bound(want)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 20, 32, 48])
def test_flash_attention_bf16_small_head_dim_raises(cuda_device, d):
    """The tensor-core kernel takes only D = 64, 128 and 256; a bf16 call at
    another D raises and launches nothing."""
    q = torch.randn(1, 2, 8, d, device=cuda_device).to(torch.bfloat16)
    fa_ops.reset_launches()
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, q[:, :1], q[:, :1])
    assert fa_ops.LAUNCHES["B3"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,d", [(1, 32, 4, 128), (1, 8, 1, 256)])
def test_flash_attention_kernel_long_prefill_bf16(cuda_device, b, hq, hkv, d):
    """A 2048-token causal prefill in yi-6b's and gemma-2b's layouts, on the
    tensor-core path."""
    g = torch.Generator(device=cuda_device).manual_seed(hq + d)
    q, k, v = (torch.randn(b, h, 2048, d, device=cuda_device, generator=g).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, kind="causal")
    assert fa_ops.LAUNCHES == {"B3": 1, "B3_tc": 1}
    want = fa_ref.flash_attention(q, k, v, kind="causal")
    torch.cuda.synchronize()
    assert bool(((got.float() - want.float()).abs() <= attention_bound(want)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_counts_launches(cuda_device, dtype):
    q = torch.randn(1, 2, 8, 128, device=cuda_device).to(dtype)
    k = torch.randn(1, 1, 8, 128, device=cuda_device).to(dtype)
    fa_ops.reset_launches()
    fa_ref.flash_attention.calls = 0
    fa_ops.flash_attention(q, k, k)
    tc = int(dtype == torch.bfloat16)
    assert fa_ops.LAUNCHES == {"B3": 1, "B3_tc": tc} and fa_ref.flash_attention.calls == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (1, 2048, 2048), (16, 2048, 256), (17, 1001, 333), (300, 2048, 512), (4, 16384, 2048),
    (128, 4000, 1030),
])
@pytest.mark.parametrize("cols", [10, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_plane_kernel_paths(cuda_device, m, k, n, cols, dtype):
    """fused_dequant: bf16 x on the tensor-core kernel, f32 x on the FMA
    kernel; ragged K and N, M from 1 to 300, cols 10 and 16."""
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n + cols)
    q = torch.randint(0, 2**cols, (k, n), dtype=torch.int32, device=cuda_device, generator=g)
    s = torch.where(torch.rand(k, n, device=cuda_device, generator=g) < 0.5, -1, 1).to(torch.int8)
    op = simulator.int8_plane_operands(q, s, 1e-3, 0.0, cols)
    x = torch.randn(m, k, device=cuda_device, generator=g).to(dtype)
    cim_ops.reset_launches()
    cim_ref.cim_matmul.calls = 0
    got = cim_ops.cim_matmul(x, op["splanes"], op["scale"])
    assert cim_ops.LAUNCHES["B5"] == 1 and cim_ref.cim_matmul.calls == 0
    assert cim_ops.LAUNCHES["B5_tc"] == int(dtype == torch.bfloat16)
    want = cim_ref.cim_matmul(x, op["splanes"], op["scale"])
    torch.cuda.synchronize()
    bound = 2 * F32_EPS * k * (x.float().abs() @ (q.float() * 1e-3))
    assert got.shape == (m, n) and bool(((got - want).abs() <= bound).all())


_PACKED_OPS: dict = {}


def _packed_operands(device, k, n, cols, share):
    """const_rle-encoded packed operands with (plane, 128-row) tiles zeroed
    at ``share``, and |w| * scale for the bound (cached across cases)."""
    key = (k, n, cols, share)
    if key not in _PACKED_OPS:
        _PACKED_OPS.clear()  # one shape's operands at a time
        g = torch.Generator(device=device).manual_seed(k + n + cols + int(100 * share))
        q = torch.randint(0, 2**cols, (k, n), dtype=torch.int32, device=device, generator=g)
        s = torch.where(torch.rand(k, n, device=device, generator=g) < 0.5, -1, 1).to(torch.int8)
        op = simulator.packed_operands(q, s, 1e-3, 0.0, cols)
        if share:
            dead = torch.rand(cols, -(-k // 128), device=device, generator=g) < share
            rows = dead.repeat_interleave(16, dim=1)[:, : op["planes_packed"].shape[1]]
            op["planes_packed"] = op["planes_packed"] * (~rows)[:, :, None]
        op = planes.encode_operands(op, "const_rle")
        w_abs = cim_ref.unpack_weights(op["planes_packed"], op["sign_packed"], k).abs() * 1e-3
        _PACKED_OPS[key] = (op, w_abs)
    return _PACKED_OPS[key]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 16384), (16384, 2048), (1001, 333), (4096, 64000)])
@pytest.mark.parametrize("cols", [10, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_kernels_match_plain(cuda_device, k, n, cols, dtype):
    """B2 and B4 against the plain version, M from 1 to 300, zero tiles
    0 / 50 / 90%, identity and permuted plane_ids (stored plane p holds
    logical plane ids[p]): bf16 x on the tensor-core kernel, f32 x on the FMA
    kernel, and B4 equal to B2 bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(k + n + cols)
    perm = torch.randperm(cols, generator=torch.Generator().manual_seed(cols)).to(torch.int32)
    tc = int(dtype == torch.bfloat16)
    for share in (0.0, 0.5, 0.9):
        op, w_abs = _packed_operands(cuda_device, k, n, cols, share)
        for ids in (None, perm.to(cuda_device)):
            # permuting stored planes (and their flags) keeps the weights
            pp = op["planes_packed"] if ids is None else op["planes_packed"][ids.long()]
            nz = op["plane_tile_nz"] if ids is None else op["plane_tile_nz"][ids.long()]
            args = (pp, op["sign_packed"], op["scale"])
            for m in (1, 4, 16, 17, 128, 300):
                x = torch.randn(m, k, device=cuda_device, generator=g).to(dtype)
                cim_ops.reset_launches()
                cim_ref.cim_matmul_packed.calls = 0
                b2 = cim_ops.cim_matmul_packed(x, *args, plane_ids=ids)
                b4 = cim_ops.cim_matmul_packed(x, *args, tile_nz=nz, plane_ids=ids)
                assert {key: v for key, v in cim_ops.LAUNCHES.items() if v} == {
                    "B2": 1, "B4": 1, **({"B2_tc": 1, "B4_tc": 1} if tc else {})}
                assert cim_ref.cim_matmul_packed.calls == 0
                want = cim_ref.cim_matmul_packed(x, *args, plane_ids=ids)
                torch.cuda.synchronize()
                bound = 2 * F32_EPS * k * (x.float().abs() @ w_abs)
                what = f"share {share} ids {ids is not None} M {m}"
                assert b2.shape == (m, n) and bool(((b2 - want).abs() <= bound).all()), what
                assert torch.equal(b2, b4), what


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 16384), (16384, 2048), (1001, 333)])
@pytest.mark.parametrize("cols", [8, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_kernel_with_plane_gain_matches_plain(cuda_device, k, n, cols, dtype):
    """B2 with drift gains (stored plane p at column n weighs gain[p, n] *
    2**ids[p]) against the plain version, identity and permuted plane_ids,
    M from 1 to 128: always the FMA kernel (bf16 x taken as f32), never B4
    (zero-tile flags are ignored), and no plain-version call."""
    g = torch.Generator(device=cuda_device).manual_seed(k + n + cols)
    op, _ = _packed_operands(cuda_device, k, n, cols, 0.5)
    gain = torch.exp(0.05 * torch.randn(cols, n, device=cuda_device, generator=g))
    perm = torch.randperm(cols, generator=torch.Generator().manual_seed(cols)).to(torch.int32)
    for ids in (None, perm.to(cuda_device)):
        args = (op["planes_packed"], op["sign_packed"], op["scale"])
        w_abs = cim_ref.unpack_weights(*args[:2], k, ids, gain).abs() * 1e-3
        for m in (1, 4, 17, 128):
            x = torch.randn(m, k, device=cuda_device, generator=g).to(dtype)
            cim_ops.reset_launches()
            cim_ref.cim_matmul_packed.calls = cim_ref.unpack_weights.calls = 0
            got = cim_ops.cim_matmul_packed(x, *args, plane_ids=ids, plane_gain=gain)
            flagged = cim_ops.cim_matmul_packed(x, *args, tile_nz=op["plane_tile_nz"],
                                                plane_ids=ids, plane_gain=gain)
            assert {key: v for key, v in cim_ops.LAUNCHES.items() if v} == {"B2": 2, "B2_gain": 2}
            assert cim_ref.cim_matmul_packed.calls == cim_ref.unpack_weights.calls == 0
            want = cim_ref.cim_matmul_packed(x, *args, plane_ids=ids, plane_gain=gain)
            torch.cuda.synchronize()
            bound = 2 * F32_EPS * k * (x.float().abs() @ w_abs)
            what = f"ids {ids is not None} M {m}"
            assert got.shape == (m, n) and bool(((got - want).abs() <= bound).all()), what
            assert torch.equal(got, flagged), what


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 16384), (16384, 2048), (1001, 333)])
@pytest.mark.parametrize("bad", ["repeated", "past_cols", "negative"])
def test_packed_tensor_core_kernel_non_permutation_ids_give_nan(cuda_device, k, n, bad):
    """On the tensor-core kernel (bf16 x), plane_ids that are not a
    permutation of range(cols) make B2 and B4 return NaN in every element,
    split K included; identity and permuted ids stay finite."""
    op, _ = _packed_operands(cuda_device, k, n, 10, 0.5)
    args = (op["planes_packed"], op["sign_packed"], op["scale"])
    ids = list(range(10))
    ids[3] = {"repeated": 5, "past_cols": 10, "negative": -1}[bad]
    g = torch.Generator(device=cuda_device).manual_seed(k + n)
    for m in (1, 4, 128):
        x = torch.randn(m, k, device=cuda_device, generator=g).to(torch.bfloat16)
        for plane_ids, finite in ((torch.tensor(ids, dtype=torch.int32), False),
                                  (torch.arange(10, dtype=torch.int32), True),
                                  (torch.arange(9, -1, -1, dtype=torch.int32), True)):
            plane_ids = plane_ids.to(cuda_device)
            cim_ops.reset_launches()
            b2 = cim_ops.cim_matmul_packed(x, *args, plane_ids=plane_ids)
            b4 = cim_ops.cim_matmul_packed(x, *args, tile_nz=op["plane_tile_nz"],
                                           plane_ids=plane_ids)
            assert {key: v for key, v in cim_ops.LAUNCHES.items() if v} == {
                "B2": 1, "B4": 1, "B2_tc": 1, "B4_tc": 1}
            torch.cuda.synchronize()
            what = f"ids {plane_ids.tolist()} M {m}"
            if finite:
                assert bool(torch.isfinite(b2).all()) and torch.equal(b2, b4), what
            else:
                assert bool(torch.isnan(b2).all()) and bool(torch.isnan(b4).all()), what


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


def _bitslice_matches_plain(w, inv, cols):
    """B6 == its plain version bit for bit, in one launch and no plain call."""
    inv_t = torch.tensor(inv, device=w.device)
    bs_ops.reset_launches()
    bs_ref.bitslice_planes.calls = 0
    got = bs_ops.bitslice_planes(w, inv_t, cols)
    assert bs_ops.LAUNCHES["B6"] == 1 and bs_ref.bitslice_planes.calls == 0
    want = bs_ref.bitslice_planes(w, inv_t, cols)
    torch.cuda.synchronize()
    shape = tuple(w.shape)
    assert got.dtype == torch.int8 and got.shape == want.shape == shape[:-2] + (cols,) + shape[-2:]
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 1), (37, 130), (256, 2048), (3, 64, 96),
    (5, 1), (7, 15), (9, 17), (4, 333),  # ragged N: the element path
    (2, 33000, 16), (65537, 1, 5),  # L * K > 65535 rows; layers past gridDim.y
])
@pytest.mark.parametrize("cols", [1, 2, 7, 8, 10, 15, 16])
def test_bitslice_kernel_matches_plain(cuda_device, shape, cols):
    # a power of two keeps the planted ties .5; past cols 10 a larger one
    # makes the high planes live
    inv = 512.0 if cols <= 10 else 2.0 ** (cols + 3)
    _bitslice_matches_plain(_weights_with_ties(shape, inv, cuda_device, seed=sum(shape) + cols),
                            inv, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 128), (3, 64, 96), (4, 333)])
@pytest.mark.parametrize("cols", [8, 10])
def test_bitslice_kernel_unaligned_view(cuda_device, shape, cols):
    """A contiguous w whose data lies 4 bytes past a 16-byte boundary (a
    view of a flat buffer at offset 1) takes the kernel's element path."""
    flat = _weights_with_ties((1 + torch.Size(shape).numel(),), 512.0, cuda_device, seed=cols)
    w = flat[1:].view(shape)
    assert w.is_contiguous() and w.data_ptr() % 16 == 4
    _bitslice_matches_plain(w, 512.0, cols)


@pytest.mark.cuda
def test_bitslice_kernel_past_2_31_bytes(cuda_device):
    """yi-6b's head shape at cols 10: 2.62 GB of planes, 64-bit offsets."""
    _bitslice_matches_plain(_weights_with_ties((1, 4096, 64000), 512.0, cuda_device, seed=3),
                            512.0, 10)
    torch.cuda.empty_cache()


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
