"""The engine's dispatches as CUDA graphs on the card (marked ``cuda``; skips without a device).

Imports neither JAX nor the reference package, so it runs where only the
port is installed:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_engine_cuda.py``.

Each dispatch kind (decode quantum, prefill chunk, fused step), greedy and
sampled, through the engine's graph (captured at the bucket's first call,
replayed at the second with other inputs) gives the tokens, keys and pool
bits of the same step function run eagerly at the same bucket; B3 with
per-row offsets and valid lengths at the engine's (chunk, pages x page)
shapes is within its tolerance of the plain version; an engine on the card
serves a trace with the CPU engine's schedule.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.kernels._util import full_f32_matmuls
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import engine as teng
from repro_torch.models import api

ECFG = dict(max_slots=4, page_size=8, max_seq_len=32, prefill_chunk=8, decode_quantum=4,
            num_blocks=13)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    full_f32_matmuls()
    return torch.device("cuda")


def _keys(seeds):
    return np.stack([prng.PRNGKey(s).numpy() for s in seeds])


def _inputs(kind, greedy, rng, vocab):
    """(graph name, step attribute, host inputs) of one bucket of each kind;
    ``greedy=False`` makes every live row sample."""
    g = int(greedy)
    if kind == "decode":
        state = np.asarray([[5, 6, g], [9, 3, g], [17, 9, g], [0, 0, 1]], np.int32)
        table = np.asarray([[1, 2, 0], [4, 5, 0], [6, 7, 8], [0, 0, 0]], np.int32)
        return ("decode", 4, 4, 3), [table, state, _keys([1, 2, 3, 4])], (0, 2)
    tokens = rng.integers(0, vocab, (4, 8)).astype(np.int32)
    table = np.asarray([[1, 2, 0], [3, 4, 0], [5, 6, 7], [0, 0, 0]], np.int32)
    if kind == "prefill":
        meta = np.asarray([[8, 16, 7, g], [2, 7, 4, g], [0, 8, 7, g], [0, 1, 0, 0]], np.int32)
        return ("prefill", 4, 3), [table, tokens, meta, _keys([5, 6, 7, 8])], (0, 1)
    pf_meta = np.asarray([[8, 12, 3, g, 1], [3, 11, 7, g, 0], [0, 8, 7, g, 0], [0, 1, 0, 0, 0]],
                         np.int32)
    dec_table = np.asarray([[1, 2, 0], [3, 4, 0], [8, 9, 10], [11, 0, 0]], np.int32)
    state = np.asarray([[0, 12, g, 0, 0], [0, 11, 1, 42, 1], [3, 9, g, 0, 0], [8, 2, 1, 0, 0]],
                       np.int32)
    join = np.asarray([0, 1, -1, -1], np.int32)
    return (("fused", 4, 8, 4, 4, 3),
            [table, tokens, pf_meta, _keys([9, 10, 11, 12]), dec_table, state,
             _keys([13, 14, 15, 16]), join], (0, 1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("kind", ["decode", "prefill", "fused"])
def test_graph_dispatch_equals_eager(cuda_device, kind, greedy):
    cfg = get_arch("gemma-2b", reduced=True)
    params = api.init(prng.PRNGKey(0), cfg, device=cuda_device)
    eng = teng.Engine(cfg, params, teng.EngineConfig(**ECFG))
    fn = {"decode": eng._decode_loops[4], "prefill": eng._prefill_step,
          "fused": eng._fused_steps[4]}[kind]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for pool in eng.pools:
        for a in pool.values():
            a.copy_(torch.randn(a.shape, device=cuda_device, generator=gen))
    rng = np.random.default_rng(1)
    for call in range(2):  # capture, then a replay with other inputs
        name, host, outs = _inputs(kind, greedy, rng, cfg.vocab_size)
        eager_pools = [{k: a.clone() for k, a in p.items()} for p in eng.pools]
        with torch.inference_mode():
            want = fn(eng.params, eager_pools, *[torch.from_numpy(h).to(cuda_device)
                                                 for h in host])
        got = eng._dispatch(name, fn, 0, host, outs)
        for i, o in zip(outs, got):
            np.testing.assert_array_equal(o, want[i].cpu().numpy())
        for p, q in zip(eng.pools, eager_pools):
            for k in p:
                assert torch.equal(p[k].view(torch.int32), q[k].view(torch.int32))
    assert eng.graph_stats["captured"] == 1 and eng._graphs[(name, 0)].replays == 2
    if not greedy:
        assert not np.array_equal(got[-1][0], host[-2 if kind == "fused" else -1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,layout", [(torch.bfloat16, (4, 8, 1, 256)),
                                          (torch.float32, (4, 4, 1, 16))])
@pytest.mark.parametrize("c", [1, 8, 32])
@pytest.mark.parametrize("pages", [2, 13])
def test_b3_per_row_at_engine_shapes(cuda_device, dtype, layout, c, pages):
    b, hq, hkv, d = layout
    sk = pages * 16
    g = torch.Generator(device=cuda_device).manual_seed(c * 100 + pages)
    q = torch.randn(b, hq, c, d, device=cuda_device, generator=g).to(dtype)
    k = torch.randn(b, hkv, sk, d, device=cuda_device, generator=g).to(dtype)
    v = torch.randn(b, hkv, sk, d, device=cuda_device, generator=g).to(dtype)
    start = torch.randint(0, sk - c + 1, (b,), device=cuda_device, generator=g, dtype=torch.int32)
    kvl = start + torch.randint(1, c + 1, (b,), device=cuda_device, generator=g,
                                dtype=torch.int32)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, kvl, kind="causal", q_offset=start)
    assert fa_ops.LAUNCHES == {"B3": 1, "B3_tc": int(dtype == torch.bfloat16)}
    want = fa_ref.flash_attention(q, k, v, kvl, kind="causal", q_offset=start)
    assert bool(((got.float() - want.float()).abs() <= fa_ref.attention_bound(want)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_engine_on_card_keeps_the_cpu_schedule(cuda_device, fused):
    """The same trace on the card and on the CPU: identical stats and
    shapes (the schedule does not depend on the device), every dispatch one
    graph replay, streams within the reduced config's near ties of the
    CPU's (compared by count of equal streams)."""
    cfg = get_arch("gemma-2b", reduced=True)
    specs = [(11, 5, True, 0), (7, 8, False, 3), (19, 3, True, 1), (4, 1, True, 0),
             (9, 9, False, 5), (14, 6, True, 2)]
    runs = {}
    for dev in ("cpu", cuda_device):
        params = api.init(prng.PRNGKey(0), cfg, device=dev)
        eng = teng.Engine(cfg, params, teng.EngineConfig(fused=fused, **ECFG))
        for rid, (plen, gen, greedy, seed) in enumerate(specs):
            prompt = np.random.default_rng(100 + rid).integers(0, cfg.vocab_size, plen)
            eng.submit(teng.Request(rid=rid, prompt=prompt, max_new_tokens=gen, greedy=greedy,
                                    seed=seed))
        now = 0.0
        while eng.waiting or any(s is not None for s in eng.slots):
            eng.step(now)
            now += 1.0
        runs[str(dev)] = eng
    cpu, card = runs["cpu"], runs[str(cuda_device)]
    assert cpu.stats == card.stats and cpu._shapes_seen == card._shapes_seen
    dispatches = sum(card.stats[k] for k in ("decode_dispatches", "prefill_dispatches",
                                             "fused_dispatches"))
    assert sum(g.replays for g in card._graphs.values()) == dispatches
    same = sum(cpu.results[r].tokens == card.results[r].tokens for r in cpu.results)
    assert same >= len(specs) - 1
