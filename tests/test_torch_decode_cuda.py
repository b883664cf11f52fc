"""The decode loop as a CUDA graph on the card (marked ``cuda``; skips without a device).

Imports neither JAX nor the reference package, so it runs where only the
port is installed:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_decode_cuda.py``.

The graph (``loop="scan"``) gives the eager per-token loop's tokens bit for
bit, greedy and sampled, on the reduced gemma-2b and on gemma-2b at full
width with 1 layer (fp and packed weights); a captured ``decode_step``
replayed at two positions equals the eager step in logits and cache bits;
the card's Gumbel noise equals the CPU's bit for bit.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core import planner
from repro_torch.kernels._util import full_f32_matmuls
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.launch import serve, steps
from repro_torch.models import api

GEN = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    full_f32_matmuls()
    return torch.device("cuda")


def _loops_agree(cfg, params, batch, greedy):
    out = {}
    for loop in serve.LOOPS:
        run = serve.make_generator(cfg, params, batch, gen_len=GEN, greedy=greedy, seed=3,
                                   loop=loop)
        out[loop] = [run()[0] for _ in range(2)]
    assert out["scan"][0].shape == (batch["tokens"].shape[0], GEN)
    for t in out["scan"][1:] + out["python"]:
        assert torch.equal(t, out["scan"][0])
    return out["scan"][0]


@pytest.mark.cuda
@pytest.mark.parametrize("greedy", [True, False])
def test_graph_equals_eager_reduced(cuda_device, greedy):
    cfg = get_arch("gemma-2b", reduced=True)
    params = api.init(prng.PRNGKey(0), cfg, device=cuda_device)
    batch = api.make_batch(cfg, 2, 12, seed=1, device=cuda_device)
    _loops_agree(cfg, params, batch, greedy)


@pytest.fixture(scope="module")
def gemma_full():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    full_f32_matmuls()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=1)
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    plan = planner.build_deployment(params, planner.CrossbarSpec(),
                                    planner.PlannerConfig(p_stuck=0.5), device=dev)
    packed = planner.deploy_params(params, plan, materialize="packed")
    return cfg, {"fp": params, "packed": packed}, api.make_batch(cfg, 4, 32, seed=0, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["fp", "packed"])
@pytest.mark.parametrize("greedy", [True, False])
def test_graph_equals_eager_full_width(gemma_full, weights, greedy):
    cfg, params, batch = gemma_full
    cim_ops.reset_launches()
    _loops_agree(cfg, params[weights], batch, greedy)
    if weights == "packed":
        assert cim_ops.LAUNCHES["B2_tc"] > 0


@pytest.mark.cuda
def test_captured_decode_step_replays_at_two_positions(cuda_device):
    cfg = get_arch("gemma-2b", reduced=True)
    params = api.init(prng.PRNGKey(0), cfg, device=cuda_device)
    batch = api.make_batch(cfg, 2, 12, seed=2, device=cuda_device)
    step = steps.make_serve_step(cfg)
    with torch.inference_mode():
        _, pf = api.prefill(params, cfg, batch)
        caches = [api.merge_prefill_cache(cfg, api.init_cache(cfg, 2, 16, device=cuda_device), pf)
                  for _ in range(2)]
        tok = batch["tokens"][:, :1].clone()
        pos = torch.full((), 12, dtype=torch.int64, device=cuda_device)
        graphed = steps.CudaGraphCall(step, params, caches[0], tok, pos)
        # the warm-up and the capture wrote row 12: rewrite the prompt rows
        api.merge_prefill_cache(cfg, caches[0], pf)
        for p in (12, 13):
            want, _ = step(params, caches[1], tok, p)
            got, _ = graphed(params, caches[0], tok, torch.tensor(p, device=cuda_device))
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            for a, b in zip(caches[0], caches[1]):
                for name in ("k", "v"):
                    assert torch.equal(a[name][..., : p + 1, :].view(torch.int32),
                                       b[name][..., : p + 1, :].view(torch.int32))
    assert graphed.replays == 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256000), (2, 1000)])
def test_gumbel_on_the_card_equals_the_cpu(cuda_device, shape):
    _, sub = prng.split(prng.PRNGKey(0)).unbind(-2)
    got = prng.gumbel(sub.to(cuda_device), shape).cpu()
    want = prng.gumbel(sub, shape)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    logits = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(prng.categorical(sub.to(cuda_device), logits.to(cuda_device)).cpu(),
                       prng.categorical(sub, logits))
