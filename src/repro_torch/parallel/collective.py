"""The reduction gate of tensor-parallel serving: one interface, two
implementations.

Under a TP plan (``parallel/tp.py``) the model's row-parallel sublayers
(attention through ``wo``, the gated MLP) produce one PARTIAL output per
shard, which must be summed before the residual add: the gates of
``models/blocks.py`` (the reference's ``lax.psum``).  A gate is the object
that sums them:

* :class:`ShardLoop` — every shard of the group runs in this process, one
  after another at its local shapes (``blocks._tp_gate`` loops over the
  shard axis), and the partials are summed here in shard order.  This is
  the one-card path: the port's kernels are ``ctypes`` launches that
  ``torch.func.vmap`` cannot batch, and NCCL refuses two ranks on one GPU.
  The loop lives inside the step function, so a serving dispatch with all
  its shards is still one CUDA graph.
* :class:`ProcessGroupGate` — one local shard a rank of a
  ``torch.distributed`` group, the partial summed by ``dist.all_reduce``
  (the reference's ``shard_map`` branch).

Both sum in float32 and cast to the activation dtype once: partials
``p_0 .. p_{n-1}`` give ``((p_0 + p_1) + p_2) + ...`` rounded once, which
for a bf16 model is closer to the unsharded matmul (one f32 accumulation,
one rounding) than a bf16 sum.  For f32 activations this is the
reference's psum over the vmap axis; tokens equal its ``tp_generate`` and
the solo generate (tests).  The gate in force is the innermost
:func:`active` context (default: a :class:`ShardLoop`).
"""
from __future__ import annotations

import contextlib

import torch


class ShardLoop:
    """All shards in process; partials summed in shard order in float32."""

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        acc = parts[0].to(torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(torch.float32)
        return acc.to(parts[0].dtype)


class ProcessGroupGate:
    """One shard a rank: the local partial all-reduced (sum) over ``group``
    (default: the world) in float32."""

    def __init__(self, group=None):
        self.group = group

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        import torch.distributed as dist

        if len(parts) != 1:
            raise ValueError(f"a process-group gate holds one shard a rank, got {len(parts)}")
        y = parts[0].to(torch.float32, copy=True)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y.to(parts[0].dtype)


_STACK: list = [ShardLoop()]


def current():
    """The gate in force."""
    return _STACK[-1]


@contextlib.contextmanager
def active(gate):
    """Run the enclosed model code with ``gate`` at its reduction points."""
    _STACK.append(gate)
    try:
        yield gate
    finally:
        _STACK.pop()
