"""Shared benchmark machinery of the port: shape-faithful weight sets + helpers.

The port's copy of ``benchmarks/common.py``.  The paper evaluates trained
ResNet/VGG/AlexNet/ViT/DeiT on ImageNet-1K; without ImageNet or pretrained
checkpoints each model is represented by its *exact published layer shapes*
with fan-in-scaled gaussian weights (the bell-shaped distribution SWS
exploits).  The LM entries take one layer's shapes from the port's arch
configs.

The weights are the reference's bit for bit: the same key schedule (one
``split`` per tensor from ``PRNGKey(seed)``) and ``prng.normal``, which
draws what ``jax.random.normal`` draws, times ``(2 / fan_in) ** 0.5``
rounded to float32.  So every transition count below equals the
reference's.

The default caps each tensor at ``max_elems`` weights (transitions are a
per-element statistic, so a uniform subsample is unbiased); ``max_elems=0``
benchmarks every element.  Every entry point runs on CUDA unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Callable, Iterable

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import bitslice, sws
from repro_torch.kernels._util import resolve_device

OUT_DIR = Path(__file__).resolve().parents[1] / "experiments" / "bench_torch"

PHYS_COLS = 128  # physical crossbar columns (the paper's 128x128 arrays)
# fig9's and fig10's per-tensor cap: the reference walks the stochastic
# stucking schedule sequentially over sections, so it caps them harder
SWEEP_CAP = 500_000


def weights_per_section(cols: int, rows: int = 128) -> int:
    """Weights one crossbar holds (paper §II: a 128x128 array with 16
    power-of-two multipliers stores 128/16 = 8 weights per row, labelled
    '128x16'; '128x10' stores 12 weights per row)."""
    return rows * max(1, PHYS_COLS // cols)

# ---------------------------------------------------------------------------
# Shape-faithful model weight sets
# ---------------------------------------------------------------------------

def _conv(cout, cin, k):  # torch layout (cout, cin, k, k)
    return (cout, cin, k, k)


def _resnet50_shapes() -> list[tuple[int, ...]]:
    shapes = [_conv(64, 3, 7)]
    # (in_planes, planes, blocks) per stage; bottleneck expansion 4
    stages = [(64, 64, 3), (256, 128, 4), (512, 256, 6), (1024, 512, 3)]
    for cin, planes, blocks in stages:
        for b in range(blocks):
            c_in = cin if b == 0 else planes * 4
            shapes += [
                _conv(planes, c_in, 1),
                _conv(planes, planes, 3),
                _conv(planes * 4, planes, 1),
            ]
            if b == 0:
                shapes.append(_conv(planes * 4, c_in, 1))  # downsample proj
    shapes.append((1000, 2048))  # fc
    return shapes


def _vgg16_shapes() -> list[tuple[int, ...]]:
    cfg = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    shapes, cin = [], 3
    for cout in cfg:
        shapes.append(_conv(cout, cin, 3))
        cin = cout
    shapes += [(4096, 25088), (4096, 4096), (1000, 4096)]
    return shapes


def _alexnet_shapes() -> list[tuple[int, ...]]:
    return [
        _conv(64, 3, 11), _conv(192, 64, 5), _conv(384, 192, 3),
        _conv(256, 384, 3), _conv(256, 256, 3),
        (4096, 9216), (4096, 4096), (1000, 4096),
    ]


def _vit_shapes(d: int, layers: int, heads: int) -> list[tuple[int, ...]]:
    shapes = [(d, 3 * 16 * 16)]  # patch embed
    for _ in range(layers):
        shapes += [(d, 3 * d), (d, d), (d, 4 * d), (4 * d, d)]
    shapes.append((1000, d))
    return shapes


def _lm_layer_shapes(arch: str) -> list[tuple[int, ...]]:
    """One transformer layer's matmul weights from an arch config."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    hd = cfg.resolved_head_dim
    shapes = [
        (cfg.d_model, cfg.n_heads * hd),
        (cfg.d_model, cfg.n_kv_heads * hd),
        (cfg.d_model, cfg.n_kv_heads * hd),
        (cfg.n_heads * hd, cfg.d_model),
    ]
    if cfg.d_ff:
        shapes += [(cfg.d_model, cfg.d_ff)] * 2 + [(cfg.d_ff, cfg.d_model)]
    return shapes


MODELS: dict[str, Callable[[], list[tuple[int, ...]]]] = {
    "alexnet": _alexnet_shapes,
    "vgg16": _vgg16_shapes,
    "resnet50": _resnet50_shapes,
    "deit-tiny": lambda: _vit_shapes(192, 12, 3),
    "deit-base": lambda: _vit_shapes(768, 12, 12),
    "vit-base": lambda: _vit_shapes(768, 12, 12),
    # LM tie-ins (one layer each; full model = n_layers x this)
    "internlm2-layer": lambda: _lm_layer_shapes("internlm2-1.8b"),
    "yi6b-layer": lambda: _lm_layer_shapes("yi-6b"),
}

PAPER_DEFAULT_MODELS = ["alexnet", "vgg16", "resnet50", "deit-tiny", "deit-base", "vit-base"]


def scaled_normal(key: torch.Tensor, shape: tuple[int, ...], fan_in: int) -> torch.Tensor:
    """``normal(key, shape) * (2 / fan_in) ** 0.5``, the scale rounded to
    float32 first (as jax rounds a Python float against a float32 array)."""
    scale = torch.tensor((2.0 / fan_in) ** 0.5, dtype=torch.float32, device=key.device)
    return prng.normal(key, shape) * scale


def model_weights(
    name: str, *, max_elems: int = 2_000_000, seed: int = 0, device=None
) -> Iterable[tuple[str, torch.Tensor]]:
    """Yield (tensor_name, flat float32 weights) with fan-in-scaled gaussian values."""
    key = prng.PRNGKey(seed, device=resolve_device(device))
    for i, shape in enumerate(MODELS[name]()):
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
        n = math.prod(shape)
        n_eff = min(n, max_elems) if max_elems else n
        key, sub = prng.split(key)
        yield f"{name}/t{i}{tuple(shape)}", scaled_normal(sub, (n_eff,), fan_in)


def model_planes(
    name: str,
    *,
    cols: int = 10,
    rows: int = 128,
    sort: bool = True,
    max_elems: int = 2_000_000,
    seed: int = 0,
    device=None,
) -> torch.Tensor:
    """bool[S, W, cols] section bit planes for a whole model, W = weights per
    physical crossbar (see ``weights_per_section``).

    The paper's accounting: quantization scale and the SWS sort are *per
    layer*, and the per-layer section streams are concatenated in layer
    order (the model streaming through the crossbar pool layer by layer).
    """
    w_per = weights_per_section(cols, rows)
    chunks = []
    for _, w in model_weights(name, max_elems=max_elems, seed=seed, device=device):
        if sort:
            w = w[sws.sws_permutation(w)]
        q = F.pad(bitslice.quantize(w, cols).q, (0, (-w.shape[0]) % w_per))
        chunks.append(bitslice.bitplanes(q.reshape(-1, w_per), cols))
    return torch.cat(chunks, dim=0)


# ---------------------------------------------------------------------------
# Output helpers
# ---------------------------------------------------------------------------

def save_json(figname: str, payload: dict) -> Path:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"{figname}.json"
    path.write_text(json.dumps(payload, indent=1))
    return path


def banner(title: str) -> None:
    print(f"\n=== {title} " + "=" * max(0, 70 - len(title)))


class Timer:
    """Wall time of a block; synchronizes ``device`` (if CUDA) at both ends."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self._sync()
        self.seconds = time.perf_counter() - self.t0
