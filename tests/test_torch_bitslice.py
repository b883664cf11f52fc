"""The port's bitslice (kernel B6's plain version) against the JAX package.

``kernels/bitslice/ref.bitslice_planes`` must equal the reference's Pallas
kernel (interpret mode) exactly, .5 ties and -0.0 included, and
``simulator.operands_from_dense(materialize="planes_int8")``, which builds
its planes with ``bitslice_planes``, must give the reference's ``splanes``
byte for byte.  Inputs are made with numpy from a seed.  The kernel itself
is held against its plain version on the card
(``tests/test_torch_kernels_cuda.py``); here its launch plan, which mirrors
the kernel's grid and index math, is checked to write every weight once.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitslice as jbits
from repro.core import simulator as jsim
from repro.kernels.bitslice import ops as jbs_ops
from repro.kernels.bitslice import ref as jbs_ref
from repro_torch.core import simulator
from repro_torch.kernels.bitslice import ops as bs_ops
from repro_torch.kernels.bitslice import ref as bs_ref


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _weights(shape, inv_scale, seed):
    """Random weights with exact .5 ties of |w| * inv_scale, values past
    the top level, and -0.0 cells planted."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    flat = w.reshape(-1)
    idx = rng.choice(flat.size, size=flat.size // 5, replace=False)
    half = rng.integers(0, 1100, idx.size) + 0.5  # some beyond 2**10 - 1
    flat[idx] = (np.where(rng.random(idx.size) < 0.5, -1, 1) * half / inv_scale).astype(np.float32)
    flat[:3] = -0.0
    return w


@pytest.mark.parametrize("k,n", [(1, 1), (37, 130), (256, 300)])
@pytest.mark.parametrize("cols", [1, 4, 10])
def test_bitslice_plain_matches_reference_kernel(k, n, cols):
    inv = 256.0  # a power of two keeps the planted ties exact
    w = _weights((k, n), inv, seed=k * n + cols)
    want_kernel = np.asarray(jbs_ops.bitslice_planes(jnp.asarray(w), inv, cols, interpret=True))
    want_ref = np.asarray(jbs_ref.bitslice_planes(jnp.asarray(w), jnp.float32(inv), cols))
    got = bs_ref.bitslice_planes(_t(w), torch.tensor(inv), cols)
    assert got.dtype == torch.int8 and got.shape == (cols, k, n)
    np.testing.assert_array_equal(got.numpy(), want_kernel)
    np.testing.assert_array_equal(got.numpy(), want_ref)
    assert torch.equal(bs_ops.bitslice_planes(_t(w), torch.tensor(inv), cols), got)


def test_bitslice_rounds_half_to_even():
    w = torch.tensor([[0.5, 1.5, 2.5, -3.5, -0.0, 0.0]])
    got = bs_ref.bitslice_planes(w, torch.tensor(1.0), 3)
    q = (got.to(torch.int32) * torch.tensor([1, 2, 4])[:, None, None]).sum(0)
    assert q.tolist() == [[0, 2, 2, -4, 0, 0]]


def test_bitslice_stacked_layers_share_one_scale():
    """[L, K, N] -> [L, cols, K, N], each layer as its own 2-D call."""
    w = _weights((3, 40, 24), 512.0, seed=1)
    got = bs_ops.bitslice_planes(_t(w), torch.tensor(512.0), 10)
    assert got.shape == (3, 10, 40, 24)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jbs_ref.bitslice_planes(jnp.asarray(w[i]), 512.0, 10)))


@pytest.mark.parametrize("shape", [(64, 48), (2, 300, 24)])
def test_operands_from_dense_planes_match_reference(shape):
    """Deployed weights (quantize -> dequantize) give the reference's
    splanes through B6's plain version; the route before it agrees too."""
    w = (np.random.default_rng(sum(shape)).standard_normal(shape) * 0.05).astype(np.float32)
    qt = jbits.quantize(jnp.asarray(w), 10)
    w_hat = np.array(jbits.dequantize(qt)).reshape(shape)
    w_hat.reshape(-1)[:4] = -0.0
    kw = dict(materialize="planes_int8")
    jop = jsim.operands_from_dense(jnp.asarray(w_hat), qt.scale, qt.offset, "sign_magnitude", 10, **kw)
    top = simulator.operands_from_dense(_t(w_hat), float(qt.scale), 0.0, "sign_magnitude", 10, **kw)
    np.testing.assert_array_equal(top["splanes"].numpy(), np.asarray(jop["splanes"]))
    for key in ("scale", "offset"):
        np.testing.assert_array_equal(top[key].numpy(), np.asarray(jop[key]))
    w32 = _t(w_hat)
    q = torch.round(w32.abs() / top["scale"].reshape(-1)[0]).to(torch.int32)
    sign = torch.where(torch.signbit(w32), -1, 1).to(torch.int8)
    old = simulator.int8_plane_operands(q, sign, float(qt.scale), 0.0, 10)
    assert torch.equal(old["splanes"], top["splanes"])


def test_bitslice_wrapper_rejects_bad_arguments():
    with pytest.raises(ValueError):
        bs_ops.bitslice_planes(torch.zeros(8), torch.tensor(1.0), 4)
    with pytest.raises(ValueError):
        bs_ops.bitslice_planes(torch.zeros(4, 4), torch.tensor(1.0), 17)


# ---------------------------------------------------------------------------
# Kernel B6's launch plan (csrc/bitslice.cu's grid and index math, mirrored
# in ops.py): every (layer, k, n) of the output is written exactly once
# ---------------------------------------------------------------------------

def _coverage(plan: bs_ops.LaunchPlan) -> tuple[np.ndarray, np.ndarray]:
    """How often each layer is walked by some blockIdx.y, and each (k, n)
    written by some chunk thread of a layer."""
    layers = np.zeros(plan.layers, np.int64)
    for y in range(plan.blocks_y):
        layers[y::plan.blocks_y] += 1
    cells = np.zeros((plan.k, plan.n), np.int64)
    for u in range(plan.blocks_x * bs_ops.THREADS):
        span = bs_ops.thread_span(plan, u)
        if span is not None:
            row, col, width = span
            assert 1 <= width <= bs_ops.CHUNK and col + width <= plan.n
            cells[row, col:col + width] += 1
    return layers, cells


@pytest.mark.parametrize("shape", [
    (1, 1, 1), (1, 3, 15), (2, 5, 17), (1, 7, 333), (3, 4, 16), (2, 9, 48),
    (4, 16384, 16),  # L * K = 65536 rows (gemma's stacked wo_ff has as many)
    (65537, 1, 5),  # layers past the card's gridDim.y limit: blockIdx.y loops
])
@pytest.mark.parametrize("vec", [True, False])
def test_bitslice_launch_plan_covers_every_weight_once(shape, vec):
    layers, k, n = shape
    plan = bs_ops.launch_plan(layers, k, n, vec)
    assert plan.vec == (vec and n % 16 == 0)
    assert plan.chunks * 16 >= n > (plan.chunks - 1) * 16
    assert 1 <= plan.blocks_y <= bs_ops.MAX_GRID_Y and plan.blocks_x <= 2**31 - 1
    walked, cells = _coverage(plan)
    assert (walked == 1).all() and (cells == 1).all()
    # the kernel's 64-bit output offsets are those of a contiguous
    # [layers, cols, k, n] tensor
    cols = 10
    strides = torch.empty((layers, cols, k, n), dtype=torch.int8, device="meta").stride()
    for layer, b, row, col in ((0, 0, 0, 0), (layers - 1, cols - 1, k - 1, n - 1),
                               (layers // 2, 3, k // 2, n // 2)):
        want = layer * strides[0] + b * strides[1] + row * strides[2] + col * strides[3]
        assert bs_ops.plane_offset(plan, cols, layer, b, row, col) == want


@pytest.mark.parametrize("shape,cols", [
    ((1, 4096, 64000), 10),  # yi-6b's head: 2.62 GB of planes
    ((4, 4096, 11008), 10),  # yi-6b's stacked wi_gate
    ((4, 16384, 2048), 10),  # gemma-2b's stacked wo_ff: L * K = 65536
    ((64, 4096, 4096), 16),
])
@pytest.mark.parametrize("vec", [True, False])
def test_bitslice_launch_plan_at_deployment_shapes(shape, cols, vec):
    """Computed from shapes, nothing allocated: the grid fits the card's
    limits, the first and last chunk threads reach the first and last
    weight of a layer, the thread after them is masked, and the last
    plane byte's 64-bit offset is the output's last element."""
    layers, k, n = shape
    plan = bs_ops.launch_plan(layers, k, n, vec)
    assert plan.blocks_x <= 2**31 - 1 and plan.blocks_y == min(layers, bs_ops.MAX_GRID_Y)
    last = k * plan.chunks - 1
    assert plan.blocks_x * bs_ops.THREADS > last >= (plan.blocks_x - 1) * bs_ops.THREADS
    assert bs_ops.thread_span(plan, 0) == (0, 0, 16)
    assert bs_ops.thread_span(plan, last) == (k - 1, n - 16, 16)
    assert bs_ops.thread_span(plan, last + 1) is None
    # vector and element paths agree on which weights a thread holds (n % 16 == 0)
    for u in (1, plan.chunks - 1, plan.chunks, last // 2, last):
        assert bs_ops.thread_span(plan, u) == bs_ops.thread_span(
            dataclasses.replace(plan, vec=not plan.vec), u)
    numel = layers * cols * k * n
    end = bs_ops.plane_offset(plan, cols, layers - 1, cols - 1, k - 1, n - 1)
    assert end == numel - 1
    if shape == (1, 4096, 64000):
        assert end >= 2**31  # past a 32-bit offset

