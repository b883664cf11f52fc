"""Parameters of the JAX package -> the port's parameters.

The input is the reference's params pytree with every leaf turned into a
numpy array (nested dicts and lists, e.g. ``jax.tree.map(np.asarray, p)``).
The output keeps its structure, so the '/'-joined names ``iter_weights`` and
``deploy_params`` use (``segments/0/mlp/wi_gate``) are the same in both
packages, and segment stacks keep their leading layer axis.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels._util import resolve_device


def from_numpy_tree(tree: Any, device=None) -> Any:
    """Copy a nested dict/list of numpy arrays into torch tensors on
    ``device`` (CUDA unless ``device="cpu"``)."""
    return _copy_tree(tree, resolve_device(device))


def _copy_tree(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _copy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
