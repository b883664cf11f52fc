"""Gradient compression and the torch.distributed reduction gate, on the CPU.

* ``parallel.compression`` against the JAX package's: int8 values, scales
  and error state bit for bit on f32 and bf16 trees (zero leaves included),
  then the reference's four properties (bounded round trip, error feedback
  unbiased over time, an int8 wire format, training parity on a toy
  least-squares problem);
* ``parallel.collective.ProcessGroupGate``: two ``gloo`` processes on the
  CPU, one shard each of a 2-way ``tp_generate`` of the reduced yi-6b,
  give the in-process shard loop's tokens, greedy and sampled.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as jcomp
from repro_torch import prng, tree
from repro_torch.configs import get_arch
from repro_torch.models import api
from repro_torch.parallel import compression as comp
from repro_torch.parallel import tp

ROOT = Path(__file__).resolve().parents[1]


def _trees(seed: int):
    rng = np.random.default_rng(seed)
    g = {"a": rng.normal(size=(37, 53)).astype(np.float32) * 3,
         "b": [rng.normal(size=(1000,)).astype(np.float32) * 1e-3,
               np.zeros((4, 4), np.float32)],
         "c": rng.normal(size=(8, 8)).astype(np.float32) * 1e4}
    e = {"a": rng.normal(size=(37, 53)).astype(np.float32) * 1e-2,
         "b": [rng.normal(size=(1000,)).astype(np.float32) * 1e-5, np.zeros((4, 4), np.float32)],
         "c": np.zeros((8, 8), np.float32)}
    return g, e


def _bytes(x) -> bytes:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(np.atleast_1d(x)).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compression_bit_identical_to_reference(seed, dtype):
    g, e = _trees(seed)
    jg = jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), g)
    tg = jax.tree.map(lambda x: torch.from_numpy(x).to(getattr(torch, dtype)), g)
    want = jcomp.compress(jg, jax.tree.map(jnp.asarray, e))
    got = comp.compress(tg, jax.tree.map(torch.from_numpy, e))
    for w, t in zip(want, got):
        wl, tl = jax.tree.leaves(w), tree.leaves(t)
        assert len(wl) == len(tl) == 4
        for a, b in zip(wl, tl):
            assert np.asarray(a).dtype == b.numpy().dtype
            assert _bytes(a) == _bytes(b)
    jd = jcomp.decompress(want[0], want[1])
    td = comp.decompress(got[0], got[1])
    assert all(_bytes(a) == _bytes(b) for a, b in zip(jax.tree.leaves(jd), tree.leaves(td)))
    zero = comp.init_error_state(tg)
    assert all(z.dtype == torch.float32 and not z.any() for z in tree.leaves(zero))


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def test_roundtrip_error_bounded():
    g = {"a": _normal((64, 32), 0), "b": _normal((10,), 1)}
    g_hat, err = comp.compress_decompress(g, comp.init_error_state(g))
    for name in g:
        step = float(g[name].abs().max()) / 127.0
        assert float((g[name] - g_hat[name]).abs().max()) <= step * 0.5 + 1e-7
        torch.testing.assert_close(err[name], g[name] - g_hat[name], rtol=1e-6, atol=1e-7)


def test_error_feedback_unbiased_over_time():
    g = {"w": _normal((32, 32), 2) * 1e-3}
    err = comp.init_error_state(g)
    applied = torch.zeros_like(g["w"])
    for _ in range(50):
        g_hat, err = comp.compress_decompress(g, err)
        applied = applied + g_hat["w"]
    true_sum = g["w"] * 50
    assert float(torch.linalg.norm(applied - true_sum) / torch.linalg.norm(true_sum)) < 0.02


def test_wire_format_is_int8():
    g = {"w": _normal((16, 16), 3)}
    q, s, _ = comp.compress(g, comp.init_error_state(g))
    assert q["w"].dtype == torch.int8
    assert s["w"].dtype == torch.float32 and s["w"].shape == ()


def test_training_parity_tiny_model():
    x, w_true = _normal((128, 8), 4), _normal((8, 1), 5)
    y = x @ w_true

    def loss(w):
        return torch.mean((x @ w - y) ** 2)

    def grad(w):
        return 2.0 * x.T @ (x @ w - y) / x.shape[0]

    lr = 0.05
    w_plain, w_comp = torch.zeros(8, 1), torch.zeros(8, 1)
    err = comp.init_error_state({"w": w_comp})
    for _ in range(100):
        w_plain = w_plain - lr * grad(w_plain)
        g_hat, err = comp.compress_decompress({"w": grad(w_comp)}, err)
        w_comp = w_comp - lr * g_hat["w"]
    lp, lc = float(loss(w_plain)), float(loss(w_comp))
    assert lc < 1e-3 or lc <= lp * 1.1


# ---------------------------------------------------------------------------
# the torch.distributed gate
# ---------------------------------------------------------------------------

RANK_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.parallel import collective, tp

    torch.set_num_threads(1)
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    cfg = get_arch("yi-6b", reduced=True)
    params = api.init(prng.PRNGKey(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 8)).astype(np.int32))
    rows = []
    for greedy in (True, False):
        got, _ = tp.tp_generate(cfg, params, {"tokens": tokens}, n=2, gen_len=8, greedy=greedy,
                                seed=5, gate=collective.ProcessGroupGate(), shards=[rank])
        rows.append(got.numpy())
    if rank == 0:
        np.save(out, np.stack(rows))
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_process_group_gate_matches_the_shard_loop(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    out = tmp_path / "tokens.npy"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    got = np.load(out)

    cfg = get_arch("yi-6b", reduced=True)
    params = api.init(prng.PRNGKey(0), cfg, device="cpu")
    assert tp.plan_tp(cfg, 2).attn and tp.plan_tp(cfg, 2).mlp
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 8)).astype(np.int32))
    for i, greedy in enumerate((True, False)):
        want, _ = tp.tp_generate(cfg, params, {"tokens": tokens}, n=2, gen_len=8, greedy=greedy,
                                 seed=5)
        assert np.array_equal(got[i], want.numpy()), greedy
