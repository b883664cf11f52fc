"""The port's paged KV cache and ragged dispatches against the JAX package, on the CPU.

Data movement must equal the reference's bit for bit: the block tables and
free list under one sequence of operations, ``swap_out`` -> ``swap_in``
into other blocks, ``gather_pool_view`` / ``scatter_pool_view``.  Compute
(``attention_step`` at (B,) positions, ``prefill_chunk`` +
``decode_step_paged`` on garbage-filled, out-of-order pages, and the three
step functions the engine dispatches) holds the reference's tokens and
keys exactly and its logits and written pool cells within ``LOGIT_TOL``
(the two frameworks sum the matmuls in other orders; C.2); within the
port the paged path gives the contiguous-cache path's logits bit for bit
at the same view extent, and a (B,) position the per-row scalar steps'.
Reduced gemma-2b (f32), params converted from the reference's ``api.init``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch import paged_cache as jpc
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import blocks as jblocks
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.convert import from_numpy_tree
from repro_torch.launch import paged_cache as pc
from repro_torch.launch import steps
from repro_torch.models import api, blocks

LOGIT_TOL = 2e-5
PAGE = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's engine on the CPU runs thousands of tiny ops: one intra-op
    thread each (the suite's workers share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def gemma():
    jcfg = jax_get_arch("gemma-2b", reduced=True)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_arch("gemma-2b", reduced=True), tparams


# ---------------------------------------------------------------------------
# Host bookkeeping and data movement: bit for bit
# ---------------------------------------------------------------------------

def _ops(mod):
    """One sequence of allocator / table operations; everything observable."""
    kv = mod.PagedKVCache(mod.PagedCacheConfig(page_size=4, num_blocks=9, max_slots=3,
                                               max_pages=5))
    seen = []
    for slot, n in ((0, 6), (1, 9), (0, 7), (2, 4), (0, 13), (1, 20), (2, 17)):
        seen.append(("ensure", slot, n, kv.ensure_capacity(slot, n),
                     kv.tables.tolist(), kv.n_pages.tolist(), kv.allocator.free_blocks))
    kv.release(1)
    seen.append(("release", kv.tables.tolist(), kv.allocator._free[:]))
    seen.append(("grow", kv.ensure_capacity(2, 17), kv.tables.tolist()))
    seen.append(("rows", kv.table_rows([2, 0, 1], 4).tolist(), kv.table_rows([0], 2).dtype.str))
    seen.append(("flat", [kv.flat_idx(s, p) for s in range(3) for p in (0, 3, 5, 11)]))
    seen.append(("cells", kv.slot_cells(0, 13).tolist(), kv.slot_cells(2, 4).tolist(),
                 kv.slot_cells(0, 5).dtype.str))
    for bad in (lambda: kv.slot_cells(1, 1), lambda: kv.ensure_capacity(0, 21),
                lambda: kv.allocator.free([mod.DUMMY_BLOCK]), lambda: mod.BlockAllocator(1)):
        with pytest.raises(ValueError):
            bad()
    a = mod.BlockAllocator(6)
    seen.append(("alloc", a.alloc(3), a.alloc(3), a.alloc(2), a.free_blocks))
    return seen


def test_tables_and_allocator_match_reference():
    assert _ops(pc) == _ops(jpc)


def test_swap_roundtrip_matches_reference():
    """swap_out -> release -> re-allocate -> swap_in: the port's host copy
    equals the reference's, and the restored pools equal its pools byte for
    byte (the other slot's cells and the dummy block untouched)."""
    out = {}
    for name, mod in (("ref", jpc), ("port", pc)):
        kv = mod.PagedKVCache(mod.PagedCacheConfig(page_size=4, num_blocks=9, max_slots=2,
                                                   max_pages=6))
        t = kv.cfg.num_tokens
        base = np.arange(2 * t * 3, dtype=np.float32).reshape(2, t, 1, 3)
        if name == "ref":
            pools = [{"k": jnp.asarray(base), "v": jnp.asarray(-base)}]
        else:
            pools = [{"k": _t(base), "v": _t(-base)}]
        assert kv.ensure_capacity(0, 11) and kv.ensure_capacity(1, 5)
        before = kv.slot_cells(0, 11)
        snap = mod.swap_out(pools, kv, 0, 11)
        kv.release(0)
        assert kv.ensure_capacity(1, 17) and kv.ensure_capacity(0, 11)
        after = kv.slot_cells(0, 11)
        assert set(after.tolist()) != set(before.tolist())
        got = mod.swap_in(pools, kv, 0, snap)
        if name == "port":
            assert got is pools  # in place: graphs hold the leaves by address
        out[name] = (jax.tree.map(np.asarray, snap),
                     [{k: np.asarray(v) for k, v in p.items()} for p in got])
    (snap_r, pools_r), (snap_p, pools_p) = out["ref"], out["port"]
    for k in ("k", "v"):
        assert snap_p[0][k].tobytes() == snap_r[0][k].tobytes()
        # the reference's padded scatter writes zeros into dummy cells; every
        # other cell must agree
        np.testing.assert_array_equal(pools_p[0][k][:, PAGE:], pools_r[0][k][:, PAGE:])


@pytest.mark.parametrize("lead", [(), (2,)])
def test_gather_and_scatter_pool_view_match_reference(lead):
    rng = np.random.default_rng(5)
    page, blocks_n, hkv, hd = 4, 7, 2, 3
    pool = rng.standard_normal(lead + (blocks_n * page, hkv, hd)).astype(np.float32)
    table = np.asarray([[3, 0, 5], [6, 2, 1]], np.int32)
    got = blocks.gather_pool_view(_t(pool), _t(table), page)
    want = jblocks.gather_pool_view(jnp.asarray(pool), jnp.asarray(table), page)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    view = rng.standard_normal(tuple(want.shape)).astype(np.float32)
    pos0 = np.asarray([5, 2], np.int32)
    got = blocks.scatter_pool_view(_t(pool), _t(view), _t(table), _t(pos0), 3, page)
    want = jblocks.scatter_pool_view(jnp.asarray(pool), jnp.asarray(view), jnp.asarray(table),
                                     jnp.asarray(pos0), 3, page)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


# ---------------------------------------------------------------------------
# Ragged compute
# ---------------------------------------------------------------------------

def test_attention_step_vector_positions(gemma):
    """(B,) positions: each row equals the step at its position as a scalar
    bit for bit (output and cache row), and the reference's within
    LOGIT_TOL."""
    jcfg, jparams, cfg, tparams = gemma
    p = jax.tree.map(lambda a: a[0], jparams["segments"][0]["attn"])
    tp = {k: v[0] for k, v in tparams["segments"][0]["attn"].items()}
    rng = np.random.default_rng(1)
    b, s = 3, 16
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((b, cfg.n_kv_heads, s, cfg.resolved_head_dim)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    pos = np.asarray([2, 9, 0], np.int32)
    cache = {"k": _t(kc), "v": _t(vc)}
    got = blocks.attention_step(tp, cfg, _t(x), cache, _t(pos))
    for i in range(b):  # the same batch at row i's position as a scalar
        sub = {"k": _t(kc), "v": _t(vc)}
        want = blocks.attention_step(tp, cfg, _t(x), sub, int(pos[i]))
        assert got[i].numpy().tobytes() == want[i].numpy().tobytes()
        assert cache["k"][i].numpy().tobytes() == sub["k"][i].numpy().tobytes()
    jgot, jcache = jblocks.attention_step(p, jcfg, jnp.asarray(x),
                                          {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                          jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_paged_chunked_prefill_and_decode(gemma):
    """Chunked prefill + paged decode against garbage-filled, out-of-order
    pages: the contiguous-cache path's logits bit for bit at the same view
    extent (4 pages = 16 cells), the reference's paged logits within
    LOGIT_TOL, and the same greedy tokens."""
    jcfg, jparams, cfg, tparams = gemma
    prompt_len, gen, chunk = 11, 4, 4
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, prompt_len)).astype(np.int32)
    logits_pf, pf = api.prefill(tparams, cfg, {"tokens": _t(tokens).long()})
    cache = api.merge_prefill_cache(cfg, api.init_cache(cfg, 1, 4 * PAGE, device="cpu"), pf)
    tok = logits_pf[:, -1:].argmax(-1)
    want = []
    for i in range(gen - 1):
        lg, cache = api.decode_step(tparams, cfg, cache, tok, prompt_len + i)
        want.append(lg.clone())
        tok = lg[:, -1:].argmax(-1)

    table = np.asarray([[9, 3, 11, 5]], np.int32)
    pools = api.init_paged_pools(cfg, 16 * PAGE, device="cpu")
    for p in pools:
        for a in p.values():
            a += 777.0
    jpools = jax.tree.map(lambda a: a + 777.0, japi.init_paged_pools(jcfg, 16 * PAGE))
    start = 0
    while start < prompt_len:
        c = min(chunk, prompt_len - start)
        tk = np.zeros((1, chunk), np.int32)
        tk[0, :c] = tokens[0, start:start + c]
        args = (start, start + c, c - 1)
        lg, pools = api.prefill_chunk(tparams, cfg, pools, _t(table), _t(tk).long(),
                                      *map(torch.tensor, args), PAGE)
        jlg, jpools = japi.prefill_chunk(jparams, jcfg, jpools, jnp.asarray(table),
                                         jnp.asarray(tk), *map(jnp.int32, args), PAGE)
        start += c
    assert lg.numpy().tobytes() == logits_pf.numpy().tobytes()
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    tok = lg[:, -1:].argmax(-1)
    for i in range(gen - 1):
        pos = np.asarray([prompt_len + i], np.int32)
        lg, pools = api.decode_step_paged(tparams, cfg, pools, _t(table), tok, _t(pos), PAGE)
        jlg, jpools = japi.decode_step_paged(jparams, jcfg, jpools, jnp.asarray(table),
                                             jnp.asarray(tok.numpy().astype(np.int32)),
                                             jnp.asarray(pos), PAGE)
        assert lg.numpy().tobytes() == want[i].numpy().tobytes()
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert int(lg.argmax()) == int(np.argmax(np.asarray(jlg)))
        tok = lg[:, -1:].argmax(-1)
    for p, jp in zip(pools, jpools):
        for k in ("k", "v"):
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# The engine's three dispatches against the reference's
# ---------------------------------------------------------------------------

N_BLOCKS = 12


def _keys(seeds):
    return np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds])


def _pools(jcfg, cfg, rng):
    """The same garbage-filled pools for both packages."""
    jp = japi.init_paged_pools(jcfg, N_BLOCKS * PAGE)
    filled = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
    return (jax.tree.map(jnp.asarray, filled),
            from_numpy_tree(filled, device="cpu"), filled)


def _check_pools(tpools, jpools, before, written):
    """Written cells within LOGIT_TOL of the reference's; every other cell
    untouched (equal to ``before``) in both."""
    mask = np.zeros(N_BLOCKS * PAGE, bool)
    mask[list(written)] = True
    mask[:PAGE] = False  # the dummy page absorbs pad writes in either order
    for tp_, jp_, b in zip(tpools, jpools, before):
        for k in ("k", "v"):
            got, want = tp_[k].numpy(), np.asarray(jp_[k])
            np.testing.assert_allclose(got[:, mask], want[:, mask], rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)
            keep = ~mask
            keep[:PAGE] = False
            assert got[:, keep].tobytes() == b[k][:, keep].tobytes()
            assert np.asarray(want)[:, keep].tobytes() == b[k][:, keep].tobytes()
            assert not np.array_equal(got[:, mask], b[k][:, mask])


def _cells(table_row, positions):
    return {int(table_row[p // PAGE]) * PAGE + p % PAGE for p in positions}


def test_paged_decode_loop_matches_reference(gemma):
    """Three rows (greedy, sampled, sampled) and a pad row, 3 steps."""
    jcfg, jparams, cfg, tparams = gemma
    rng = np.random.default_rng(3)
    jpools, tpools, before = _pools(jcfg, cfg, rng)
    table = np.asarray([[1, 2, 3], [4, 5, 0], [6, 7, 8], [0, 0, 0]], np.int32)
    state = np.asarray([[5, 6, 1], [9, 3, 0], [17, 9, 0], [0, 0, 1]], np.int32)
    keys = _keys([1, 2, 3, 4])
    n = 3
    jtoks, jpools, jkeys = jax.jit(jsteps.make_paged_decode_loop(jcfg, n, PAGE))(
        jparams, jpools, jnp.asarray(table), jnp.asarray(state), jnp.asarray(keys))
    ttoks, tpools, tkeys = steps.make_paged_decode_loop(cfg, n, PAGE)(
        tparams, tpools, _t(table), _t(state), _t(keys.astype(np.int64)))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys).astype(np.int64))
    assert not np.array_equal(tkeys.numpy()[1], keys[1])  # sampled rows split
    np.testing.assert_array_equal(tkeys.numpy()[0], keys[0])  # greedy rows do not
    written = set()
    for r in range(3):
        written |= _cells(table[r], range(state[r, 1], state[r, 1] + n))
    _check_pools(tpools, jpools, before, written)


def test_prefill_chunk_step_matches_reference(gemma):
    """Two rows mid- and end-of-prompt (greedy and sampled) and a pad row."""
    jcfg, jparams, cfg, tparams = gemma
    rng = np.random.default_rng(4)
    jpools, tpools, before = _pools(jcfg, cfg, rng)
    c = 4
    table = np.asarray([[1, 2, 3], [4, 5, 6], [0, 0, 0], [0, 0, 0]], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (4, c)).astype(np.int32)
    tokens[1, 3:] = 0
    tokens[2:] = 0
    meta = np.asarray([[4, 8, 3, 1], [2, 5, 2, 0], [0, 1, 0, 0], [0, 1, 0, 0]], np.int32)
    keys = _keys([7, 8, 9, 10])
    jtok, jkeys, jpools = jax.jit(jsteps.make_prefill_chunk_step(jcfg, PAGE))(
        jparams, jpools, jnp.asarray(table), jnp.asarray(tokens), jnp.asarray(meta),
        jnp.asarray(keys))
    ttok, tkeys, tpools = steps.make_prefill_chunk_step(cfg, PAGE)(
        tparams, tpools, _t(table), _t(tokens), _t(meta), _t(keys.astype(np.int64)))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys).astype(np.int64))
    written = _cells(table[0], range(4, 8)) | _cells(table[1], range(2, 6))
    _check_pools(tpools, jpools, before, written)


def test_fused_step_matches_reference(gemma):
    """Chunk rows (a finishing sampled row that consumes its key, a
    finishing recompute replay that does not, a mid-prompt row) and decode
    rows (plain greedy, plain sampled, the two finishing rows joined in,
    the replay seeded from its override token)."""
    jcfg, jparams, cfg, tparams = gemma
    rng = np.random.default_rng(6)
    jpools, tpools, before = _pools(jcfg, cfg, rng)
    c, n = 4, 2
    pf_table = np.asarray([[1, 2, 0], [3, 4, 0], [5, 6, 7]], np.int32)
    pf_tokens = rng.integers(0, cfg.vocab_size, (3, c)).astype(np.int32)
    pf_tokens[0, 2:] = 0
    pf_meta = np.asarray([[4, 6, 1, 0, 1], [3, 7, 3, 1, 0], [0, 4, 3, 1, 0]], np.int32)
    pf_keys = _keys([11, 12, 13])
    table = np.asarray([[1, 2, 0], [3, 4, 0], [8, 9, 10], [11, 0, 0]], np.int32)
    state = np.asarray([[0, 6, 0, 0, 0], [0, 7, 1, 42, 1], [3, 9, 0, 0, 0],
                        [8, 2, 1, 0, 0]], np.int32)
    keys = _keys([21, 22, 23, 24])
    join = np.asarray([0, 1, -1, -1], np.int32)
    args = (pf_table, pf_tokens, pf_meta, pf_keys, table, state, keys, join)
    jout = jax.jit(jsteps.make_fused_step(jcfg, n, PAGE))(
        jparams, jpools, *map(jnp.asarray, args))
    targs = [_t(a.astype(np.int64) if a is pf_keys or a is keys else a) for a in args]
    tout = steps.make_fused_step(cfg, n, PAGE)(tparams, tpools, *targs)
    for got, want in zip(tout[:3], jout[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype))
    written = (_cells(pf_table[0], range(4, 8)) | _cells(pf_table[1], range(3, 7))
               | _cells(pf_table[2], range(0, 4)))
    for r in range(4):
        written |= _cells(table[r], range(state[r, 1], state[r, 1] + n))
    _check_pools(tout[3], jout[3], before, written)


def test_row_pick_consume_mask():
    """Greedy rows and rows outside ``consume`` keep their keys; the draw of
    each sampled row is jax.random.categorical of its own subkey."""
    logits = torch.randn(4, 1, 40, generator=torch.Generator().manual_seed(0))
    keys = _keys([1, 2, 3, 4])
    greedy = torch.tensor([True, False, False, False])
    consume = torch.tensor([True, True, False, True])
    tok, out = steps._row_pick(logits, _t(keys.astype(np.int64)), greedy, consume)
    jtok, jout = jsteps._row_pick(jnp.asarray(logits.numpy()), jnp.asarray(keys),
                                  jnp.asarray(greedy.numpy()), jnp.asarray(consume.numpy()))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout).astype(np.int64))
    np.testing.assert_array_equal(out.numpy()[[0, 2]], keys[[0, 2]])
    with pytest.raises(TypeError, match="float32"):
        steps._row_pick(logits.bfloat16(), _t(keys.astype(np.int64)), greedy)
    assert prng.PRNGKey(3).numpy().tolist() == keys[2].tolist()
