"""The planner's bytes in flight, on the CPU: what ``analyze_tensor`` allocates.

A full-width expert stack ([1, 160, 5120, 1536], 1.26 G weights) is planned
on one card only if the planner holds few bytes a weight in flight.  These
tests record every tensor an aten op allocates while ``analyze_tensor``
plans a small stack (a ``TorchDispatchMode``: an output whose storage is no
input's is a new allocation), with the chunk sizes cut so that the chunked
passes run several times, and hold the plan to the reference's report and
``w_hat`` bytes.  The sort is handed a precomputed permutation: on the CPU
it is ``torch.sort``, whose int64 indices are the plain version's, not the
planner's (on the card, ``kernels/sws_sort``'s int32 buffers).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.core import planner as jplanner
from repro_torch import prng
from repro_torch.core import planner, pool, stucking
from repro_torch.kernels.sws_sort import ops as sort_ops
from repro_torch.kernels.sws_sort import ref as sort_ref

SHAPE = (1, 8, 256, 192)  # a layer-stacked expert stack, 393,216 weights
QUANT_MSE_RTOL = 1e-6


class _NewTensors(TorchDispatchMode):
    """Records (op, dtype, bytes) of every tensor an op allocates: an output
    whose storage is none of the op's inputs' (views and in-place ops share
    one)."""

    def __init__(self):
        super().__init__()
        self.allocs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in ins:
                self.allocs.append((str(func), t.dtype, t.untyped_storage().nbytes()))
        return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the TSP walk's ~800 small steps, each an OpenMP
    region, crawl when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(seed=0):
    return (np.random.default_rng(seed).standard_normal(SHAPE) * 0.02).astype(np.float32)


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks of 8,192 slots, walks of one chain at a time, step scans in
    blocks of 16."""
    monkeypatch.setattr(planner, "_CHUNK", 1 << 13)
    monkeypatch.setattr(stucking, "_WALK_CHUNK", 1 << 12)
    monkeypatch.setattr(stucking, "_SCAN_BLOCK", 16)


@pytest.mark.parametrize("encoding", ["sign_magnitude", "offset_binary"])
def test_plan_allocates_no_full_size_int64_or_f32_copy(small_chunks, monkeypatch, encoding):
    """Nothing reaches 4 bytes a weight but ``w_hat`` (no float32 copy of
    ``w``, no int64 inverse), no int64 tensor is larger than 4 chunks; the
    plan equals the reference's."""
    w = _stack()
    n = w.size
    spec = planner.CrossbarSpec(encoding=encoding)
    cfg = planner.PlannerConfig(p_stuck=0.5)
    key = prng.PRNGKey(3)
    tw = torch.from_numpy(w)
    perm = sort_ref.sws_argsort(tw.reshape(-1), n, encoding)
    monkeypatch.setattr(planner.sort_ops, "sws_argsort", lambda *_: perm)
    rec = _NewTensors()
    with rec:
        tr, tw_hat = planner.analyze_tensor(tw, spec, cfg, key, name="w")
    big = [a for a in rec.allocs if a[2] >= 4 * n]
    assert len(big) == 1 and big[0][1] == torch.float32 and big[0][2] == 4 * n, big
    assert tw_hat.untyped_storage().nbytes() == 4 * n  # that one is w_hat
    assert max(b for _, d, b in rec.allocs if d == torch.int64) <= 8 * 4 * planner._CHUNK
    # byte-identical with the reference's plan of the same stack
    jr, jw_hat = jplanner.analyze_tensor(
        jnp.asarray(w), jplanner.CrossbarSpec(encoding=encoding),
        jplanner.PlannerConfig(p_stuck=0.5), jax.random.PRNGKey(3), name="w")
    a, b = dataclasses.asdict(jr), dataclasses.asdict(tr)
    np.testing.assert_allclose(b.pop("quant_mse"), a.pop("quant_mse"), rtol=QUANT_MSE_RTOL)
    assert tuple(b.pop("shape")) == tuple(a.pop("shape")) and a == b
    assert np.asarray(jw_hat).tobytes() == tw_hat.numpy().tobytes()


@pytest.mark.parametrize("kw", [dict(p_stuck=0.5), dict(p_stuck=1.0, codec="const_rle"),
                                dict(p_stuck=0.5, section_order="tsp"), dict(sws=False)])
def test_chunked_plan_equals_one_chunk(monkeypatch, kw):
    """The chunked passes, the walk by chain groups and the step scans by
    blocks change no bit: reports, w_hat bytes, pool state and wear equal
    one whole-tensor pass (quant_mse, a float sum in other pieces, within
    1e-9)."""
    w = torch.from_numpy(_stack(1)[:, :2])
    spec, cfg = planner.CrossbarSpec(), planner.PlannerConfig(**kw)
    out = {}
    for chunk, walk, block in ((1 << 24, 1 << 26, 1 << 20), (1 << 10, 1 << 10, 8)):
        monkeypatch.setattr(planner, "_CHUNK", chunk)
        monkeypatch.setattr(stucking, "_WALK_CHUNK", walk)
        monkeypatch.setattr(stucking, "_SCAN_BLOCK", block)
        xbars = pool.CrossbarPool(spec, cfg.crossbars, device="cpu")
        r, w_hat = planner.analyze_tensor(w, spec, cfg, prng.PRNGKey(5), pool=xbars)
        out[chunk] = (dataclasses.asdict(r), w_hat.numpy().tobytes(), xbars.state,
                      xbars.wear.copy())
    (a, wa, sa, ea), (b, wb, sb, eb) = out.values()
    np.testing.assert_allclose(b.pop("quant_mse"), a.pop("quant_mse"), rtol=1e-9)
    assert a == b and wa == wb and np.array_equal(sa, sb) and np.array_equal(ea, eb)


def test_sort_plain_version_ties_zeros_and_padding():
    """The plain SWS argsort: int32, stable, -0.0 / +0.0 / the padding tied
    in source order under both encodings; the wrapper takes the CPU route."""
    w = torch.tensor([0.3, -0.0, -0.2, 0.0, -0.0, 0.1, -0.2, 0.0, 2.0, -3.0])
    padded = np.pad(w.numpy(), (0, 6))
    for enc, key in (("sign_magnitude", np.abs(padded)), ("offset_binary", padded + 0.0)):
        sort_ref.sws_argsort.calls = 0
        got = sort_ops.sws_argsort(w, 16, enc)
        assert got.dtype == torch.int32 and sort_ref.sws_argsort.calls == 1
        np.testing.assert_array_equal(got.numpy(), np.argsort(key, kind="stable"))
    with pytest.raises(ValueError, match="encoding"):
        sort_ops.sws_argsort(w, 16, "two_complement")
    with pytest.raises(ValueError, match="n_total"):
        sort_ops.sws_argsort(w, 4, "sign_magnitude")


@pytest.mark.parametrize("shape", [(3, 1000), (2, 1537, 7, 1), (1, 512, 4), (2, 513)])
def test_step_scan_by_blocks_equals_cummax(shape):
    """The walk's two-level scan equals torch.cummax over the steps."""
    gen = torch.Generator().manual_seed(shape[1])
    steps = torch.arange(shape[1], dtype=torch.int32).reshape((1, -1) + (1,) * (len(shape) - 2))
    x = torch.where(torch.rand(shape, generator=gen) < 0.01, steps.expand(shape), -1)
    x = x.to(torch.int32)
    assert torch.equal(stucking._cummax_steps(x), torch.cummax(x, dim=1).values)
