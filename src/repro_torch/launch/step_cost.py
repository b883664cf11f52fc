"""Per-device cost of one step of the port, counted on fake tensors.

The counterpart of ``repro.launch.hlo_cost``.  The reference re-derives one
device's FLOPs, bytes and collective wire bytes from XLA's partitioned HLO
text; the port has no HLO, so :func:`count_step` runs the step itself,
eagerly, on ``FakeTensorMode`` tensors (shapes, dtypes and strides, no
data, no allocation) and counts what each ATen operation of the eager
program would do on one device:

* **FLOPs** — ``torch.utils.flop_counter.FlopCounterMode``: matmuls,
  batched matmuls, convolutions and attention, elementwise ops 0; the
  reference's ``hlo_cost`` counts ``dot`` ops alone, the same set.
* **Bytes accessed** — :class:`ByteCounter`: every op's operand and result
  bytes, a broadcast operand at its distinct elements, views free.  The
  port's eager program is unfused, so each op is charged on its own where
  XLA charges a fusion once at its call site: a departure, the bytes an
  eager step moves.  An in-place write is charged for what it touches (a
  cache row's ``index_copy_``, a scatter, a slice assignment's ``copy_``),
  and a gather (``embedding``, ``index_select``, ``gather``, ``index``)
  reads the rows it returns, not its whole source.
* **Wire bytes** — :class:`CountingGate`: the gate of
  ``parallel.collective`` for one device of an n-way group; it computes
  that device's shard and records each all-reduce, priced with the ring
  factor of ``launch.roofline``.
* **Peak memory** — ``torch.distributed._tools.mem_tracker.MemTracker`` over
  the same fake run, the step's inputs tracked from the start.

The reference's trip-count machinery (``n_while``, ``max_trip``) has no
counterpart: the eager step runs every loop iteration, so nothing is
counted once for many.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.roofline import all_reduce_wire

aten = torch.ops.aten

# allocations without a write, and a view the schema does not mark as one
_NO_TRAFFIC = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
               aten.new_empty_strided, aten.lift_fresh, aten.resize_, aten._unsafe_view}
# reads of the rows they return from their first operand: the position of
# their index operand
_GATHERS = {aten.embedding: 1, aten.index_select: 2, aten.gather: 2, aten.index: 1, aten.take: 1}
# in-place writes of part of their first operand, and whether each reads
# the cells it writes (accumulates); index_put_'s flag is an argument
_PARTIAL_WRITES = {aten.index_copy_: False, aten.index_add_: True, aten.index_put_: None,
                   aten._index_put_impl_: None, aten.scatter_: False, aten.scatter_add_: True,
                   aten.scatter_reduce_: True}
# in-place ops that overwrite their first operand without reading it
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_}


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a broadcast dim counts once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _tensors(obj) -> list[torch.Tensor]:
    flat, _ = tree_flatten(obj)
    seen, out = set(), []
    for t in flat:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _partial_write_bytes(pkt, args, kwargs) -> int:
    """An in-place write of part of ``args[0]``: its index and values read,
    the touched cells written (and read first when it accumulates)."""
    self_ = args[0]
    acc = _PARTIAL_WRITES[pkt]
    if pkt in (aten.index_copy_, aten.index_add_):  # (self, dim, index, source)
        index, values = args[2], args[3]
        cells = values.numel()
    elif pkt in (aten.scatter_, aten.scatter_add_, aten.scatter_reduce_):  # (self, dim, index, src)
        index, values = args[2], args[3]
        cells = index.numel()  # src is read at the index's shape
    else:  # index_put_(self, indices, values, accumulate)
        index, values = args[1], args[2]
        acc = bool(args[3]) if len(args) > 3 else bool(kwargs.get("accumulate", False))
        idx = [i for i in index if i is not None]
        if any(i.dtype == torch.bool for i in idx):
            cells = values.numel()  # a mask's count is data: charge the values given
        else:
            bshape = torch.broadcast_shapes(*(i.shape for i in idx)) if idx else ()
            rest = [n for d, n in enumerate(self_.shape) if d >= len(index) or index[d] is None]
            cells = math.prod(bshape) * math.prod(rest)
    read = sum(_distinct_bytes(t) for t in _tensors(index))
    if isinstance(values, torch.Tensor):
        read += min(_distinct_bytes(values), cells * values.element_size())
    return read + (2 if acc else 1) * cells * self_.element_size()


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one ATen call moves (see the module docstring)."""
    pkt = func.overloadpacket
    if func.is_view or pkt in _NO_TRAFFIC:
        return 0
    if pkt in _GATHERS:
        read = sum(_distinct_bytes(t) for t in _tensors(args[_GATHERS[pkt]]))
        return read + 2 * sum(t.nbytes for t in _tensors(out))
    if pkt in _PARTIAL_WRITES:
        return _partial_write_bytes(pkt, args, kwargs)
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    if func._schema.is_mutable:
        written = [a for a, arg in zip(args, func._schema.arguments)
                   if isinstance(a, torch.Tensor) and arg.alias_info is not None
                   and arg.alias_info.is_write]
        wid = {id(t) for t in written}
        read = sum(_distinct_bytes(t) for t in ins
                   if not (pkt in _OVERWRITES and id(t) in wid))
        return read + sum(t.nbytes for t in written)
    if not outs:  # a query of metadata or of a value (prim.device, _local_scalar_dense)
        return 0
    return sum(_distinct_bytes(t) for t in ins) + sum(t.nbytes for t in outs)


class ByteCounter(TorchDispatchMode):
    """Sums :func:`op_bytes` over every ATen call made under it."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        n = op_bytes(func, args, kwargs, out)
        self.total += n
        self.by_op[str(func.overloadpacket)] += n
        return out


class CountingGate:
    """The reduction gate (``parallel.collective``) of one device of an
    ``n``-way model axis: it computes shard 0 (``local_shards``) and its
    ``reduce`` returns the one partial through the float32 round trip
    ``ProcessGroupGate`` makes around its ``dist.all_reduce``, recording
    the all-reduce (float32, as the port's gates sum) and its ring wire
    bytes."""

    def __init__(self, n: int):
        self.n = n
        self.count = 0
        self.wire = 0.0

    def local_shards(self, n: int) -> tuple[int]:
        if n != self.n:
            raise ValueError(f"a gate of a {self.n}-way axis asked for a {n}-way group")
        return (0,)

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        if len(parts) != 1:
            raise ValueError(f"one device computes one shard, got {len(parts)} partials")
        y = parts[0].to(torch.float32, copy=True)
        self.count += 1
        self.wire += all_reduce_wire(y.nbytes, self.n)
        return y.to(parts[0].dtype)


@dataclasses.dataclass
class StepCost:
    flops: float
    bytes_accessed: float
    argument_bytes: int  # distinct storages of the inputs
    output_bytes: int  # distinct new storages of the outputs
    peak_bytes: int | None  # MemTracker's peak (inputs included); None if it failed
    memory_error: str | None
    trace_s: float
    flops_by_op: dict[str, int]
    bytes_by_op: dict[str, int]


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors`` (a shared leaf once)."""
    seen, n = set(), 0
    for t in _tensors(tensors):
        st = t.untyped_storage()
        key = st._cdata  # the storage itself, whatever Python wrapper holds it
        if key not in seen:
            seen.add(key)
            n += st.nbytes()
    return n


def _counted(fn: Callable, args: tuple, mem) -> tuple:
    """``fn(*args)`` under the FLOP and byte counters (and ``mem``, a
    MemTracker, unless None) -> (outputs, flop counter, byte counter, s)."""
    t0 = time.perf_counter()
    bc = ByteCounter()
    with FlopCounterMode(display=False) as fc, contextlib.ExitStack() as stack:
        if mem is not None:
            stack.enter_context(mem)
        stack.enter_context(bc)
        out = fn(*args)
    return out, fc, bc, time.perf_counter() - t0


def count_step(fn: Callable, *args: Any) -> tuple[Any, StepCost]:
    """Run ``fn(*args)`` under the active fake mode and count it; returns
    its outputs and the :class:`StepCost`.  The gates the step meets are
    the caller's to install (``parallel.collective.active``).  Where the
    memory tracker fails, the step is counted again without it and the
    peak is None, with the reason."""
    from torch.distributed._tools.mem_tracker import MemTracker

    inputs = _tensors(args)
    arg_bytes = storage_bytes(inputs)
    mem, mem_err = MemTracker(), None
    try:
        mem.track_external(*inputs)
        out, fc, bc, trace_s = _counted(fn, args, mem)
    except Exception as e:  # noqa: BLE001  (recorded in the cell, as the reference does)
        mem, mem_err = None, f"{type(e).__name__}: {e}"
        out, fc, bc, trace_s = _counted(fn, args, None)
    peak = None
    if mem is not None:
        peak = int(sum(snap["Total"] for snap in mem.get_tracker_snapshot("peak").values()))
    in_ids = {t.untyped_storage()._cdata for t in inputs}
    new_out = [t for t in _tensors(out) if t.untyped_storage()._cdata not in in_ids]
    flops_by_op = {str(k): int(v) for k, v in fc.get_flop_counts().get("Global", {}).items()}
    return out, StepCost(
        flops=float(fc.get_total_flops()), bytes_accessed=float(bc.total),
        argument_bytes=arg_bytes, output_bytes=storage_bytes(new_out), peak_bytes=peak,
        memory_error=mem_err, trace_s=trace_s, flops_by_op=flops_by_op,
        bytes_by_op=dict(bc.by_op))
