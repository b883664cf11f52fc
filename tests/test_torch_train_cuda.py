"""The training path on the card (marked ``cuda``; skips without a device).

Imports neither JAX nor the reference package, so it runs where only the
port is installed:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py``.

B3 raises under autograd on CUDA tensors; the train path's forward on the
card runs ``blockwise_attention`` and trains the attention projections; one
reduced float32 train step on the card equals the CPU's within 1e-4
(relative, loss and every updated leaf: cuBLAS and the CPU sum the same
f32 products in another order, TF32 off); and a loop resumed on the card
from a checkpoint replays the straight run's losses within 1e-5 relative.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import prng, tree
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_dataset
from repro_torch.kernels._util import full_f32_matmuls
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models import api, attention
from repro_torch.optim import AdamWConfig, adamw_init

ARCH = "internlm2-1.8b"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    full_f32_matmuls()
    return torch.device("cuda")


@pytest.mark.cuda
def test_b3_raises_under_autograd(cuda_device):
    q = torch.randn(1, 2, 64, 16, device=cuda_device, requires_grad=True)
    k = torch.randn(1, 1, 64, 16, device=cuda_device)
    fa_ops.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention(q, k, k)
    assert fa_ops.LAUNCHES["B3"] == 0
    with torch.no_grad():
        fa_ops.flash_attention(q, k, k)
    assert fa_ops.LAUNCHES["B3"] == 1


@pytest.mark.cuda
def test_train_path_trains_attention_on_the_card(cuda_device):
    cfg = get_arch(ARCH, reduced=True)
    params = api.init(prng.PRNGKey(0), cfg, device=cuda_device)
    batch = make_dataset(DataConfig(cfg.vocab_size, 64, 8, task="copy"),
                         device=cuda_device).batch_at(0)
    p = tree.tree_map(lambda x: x.detach().requires_grad_(True), params)
    fa_ops.reset_launches()
    calls = attention.blockwise_attention.calls
    loss, _ = steps.loss_fn(p, cfg, batch)
    loss.backward()
    assert fa_ops.LAUNCHES["B3"] == 0
    assert attention.blockwise_attention.calls - calls == cfg.n_layers
    for name in ("wq", "wk", "wv", "wo"):
        g = p["segments"][0]["attn"][name].grad
        assert bool((g != 0).any()) and bool(torch.isfinite(g).all()), name
    with torch.no_grad():  # evaluation keeps B3 on the card, at head dim 16
        api.forward(params, cfg, batch)
    assert fa_ops.LAUNCHES["B3"] == cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_one_train_step_matches_the_cpu(cuda_device, remat):
    cfg = get_arch(ARCH, reduced=True)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=120)
    out = {}
    for dev in ("cpu", cuda_device):
        params = api.init(prng.PRNGKey(0), cfg, device=dev)
        batch = make_dataset(DataConfig(cfg.vocab_size, 64, 8, task="copy"),
                             device=dev).batch_at(0)
        step = steps.make_train_step(cfg, opt_cfg, remat=remat)
        new, opt, m = step(params, adamw_init(params), batch)
        out[str(dev)] = (float(m["loss"]), [x.cpu() for x in tree.leaves((new, opt))])
    (l_cpu, cpu), (l_gpu, gpu) = out["cpu"], out[str(cuda_device)]
    assert l_gpu == pytest.approx(l_cpu, rel=1e-4)
    for a, b in zip(gpu, cpu):
        if b.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-4 * max(float(b.abs().max()), 1e-30))
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_resume_on_the_card_replays_the_straight_run(cuda_device, tmp_path):
    kw = dict(reduced=True, steps=8, batch=8, seq=64, lr=3e-3, task="copy", log_every=1,
              ckpt_every=4, device=cuda_device)
    straight = train_cli.build_loop(ARCH, ckpt_dir=str(tmp_path / "a"), **kw).run()
    loop = train_cli.build_loop(ARCH, ckpt_dir=str(tmp_path / "b"), **kw)
    loop.loop_cfg = type(loop.loop_cfg)(**{**loop.loop_cfg.__dict__, "total_steps": 4})
    loop.run()
    resumed_loop = train_cli.build_loop(ARCH, ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed_loop.start_step == 4
    resumed = resumed_loop.run()["metrics_log"]
    assert [r["step"] for r in resumed] == [5, 6, 7, 8]
    np.testing.assert_allclose([r["loss"] for r in resumed],
                               [r["loss"] for r in straight["metrics_log"][4:]], rtol=1e-5)
