"""Paged KV cache: fixed-size blocks, per-slot block tables, free-list alloc.

Port of ``repro.launch.paged_cache``.  The physical cache is one
token-major pool per model segment (``models.api.init_paged_pools``): k/v
of shape (layers, T, Hkv, hd) with T = ``num_blocks * page_size``.  A
*block* (page) is ``page_size`` consecutive pool cells; a decode slot owns
an ordered list of blocks — its block-table row — mapping logical positions
to physical cells:

    flat(pos) = table[slot, pos // page_size] * page_size + pos % page_size

Allocation is a host-side free list.  Block 0 is reserved as the *dummy*
page: padded dispatch rows and prompt-padding tokens route their writes
there, so a bucketed dispatch never touches a live slot's cells.  Freeing a
retired request returns its blocks for mid-flight admission of queued
requests.

Under block pressure the engine *preempts*: :func:`swap_out` copies a
victim slot's live cells to host memory so its blocks can be freed, and
:func:`swap_in` restores the copy into freshly allocated (generally
different) blocks on re-admission — byte-identical contents, because the
copy is keyed by *logical* position and the block table re-maps it.

Everything here is host bookkeeping (numpy) except the two swap helpers,
which gather/scatter pool cells on the pools' device; the dispatches
receive plain int32 index arrays derived from the tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree

DUMMY_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Shape policy for the paged pool.

    ``num_blocks`` includes the reserved dummy block; a slot may own at most
    ``max_pages`` blocks (ceil(max_seq_len / page_size) for the engine).
    """

    page_size: int = 16
    num_blocks: int = 257
    max_slots: int = 8
    max_pages: int = 32

    @property
    def num_tokens(self) -> int:
        return self.num_blocks * self.page_size

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # block 0 is the dummy page


class BlockAllocator:
    """LIFO free list over physical blocks 1..num_blocks-1."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least one usable block beyond the dummy")
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() yields 1, 2, ...

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n blocks, or None (allocation is all-or-nothing) if exhausted."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == DUMMY_BLOCK:
                raise ValueError("freeing the reserved dummy block")
        self._free.extend(blocks)


class PagedKVCache:
    """Block tables + allocator for ``max_slots`` concurrent decode slots.

    The device pools themselves are owned by the engine (the dispatches
    write them in place); this class tracks which physical cells each
    slot's logical sequence occupies.
    """

    def __init__(self, cfg: PagedCacheConfig):
        self.cfg = cfg
        self.allocator = BlockAllocator(cfg.num_blocks)
        # rows padded with the dummy block: gathers from unallocated pages
        # read garbage that the attention mask kills
        self.tables = np.full((cfg.max_slots, cfg.max_pages), DUMMY_BLOCK, np.int32)
        self.n_pages = np.zeros((cfg.max_slots,), np.int32)

    # -- lifecycle ---------------------------------------------------------

    def ensure_capacity(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot`` to hold ``n_tokens`` cells; False if out of blocks
        (the caller keeps the request queued until a retirement frees some)."""
        need = -(-n_tokens // self.cfg.page_size)
        if need > self.cfg.max_pages:
            raise ValueError(
                f"request needs {need} pages > max_pages={self.cfg.max_pages}"
            )
        have = int(self.n_pages[slot])
        if need <= have:
            return True
        got = self.allocator.alloc(need - have)
        if got is None:
            return False
        self.tables[slot, have:need] = got
        self.n_pages[slot] = need
        return True

    def release(self, slot: int) -> None:
        """Return a retired slot's blocks to the free list."""
        n = int(self.n_pages[slot])
        if n:
            self.allocator.free(self.tables[slot, :n].tolist())
        self.tables[slot, :] = DUMMY_BLOCK
        self.n_pages[slot] = 0

    # -- index derivation for dispatches -----------------------------------

    def table_rows(self, slots: list[int], n_pages: int) -> np.ndarray:
        """(len(slots), n_pages) block-table slice for a bucketed dispatch;
        unallocated entries are the dummy block."""
        return self.tables[np.asarray(slots, np.int64), :n_pages].astype(np.int32)

    def flat_idx(self, slot: int, pos: int) -> int:
        """Physical pool cell of logical position ``pos`` in ``slot``
        (debug/test helper; dispatches derive cells from the table rows)."""
        page = self.cfg.page_size
        blk = int(self.tables[slot, pos // page])
        return blk * page + pos % page

    def slot_cells(self, slot: int, n_tokens: int) -> np.ndarray:
        """(n_tokens,) physical pool cells of logical positions
        [0, n_tokens) in ``slot``, in logical order — the index array the
        swap helpers gather/scatter through.  Every position must be inside
        the slot's allocation; the dummy block is never a live cell."""
        page = self.cfg.page_size
        need = -(-n_tokens // page)
        if need > int(self.n_pages[slot]):
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens exceed its "
                f"{int(self.n_pages[slot])}-page allocation"
            )
        pos = np.arange(n_tokens)
        blocks = self.tables[slot, pos // page]
        assert not np.any(blocks == DUMMY_BLOCK), "live cell in the dummy block"
        return (blocks.astype(np.int64) * page + pos % page).astype(np.int32)


# -- preemption: host-side block copies --------------------------------------

def swap_out(pools, kv: PagedKVCache, slot: int, n_tokens: int):
    """Copy ``slot``'s live cells — logical positions [0, n_tokens) — to
    host memory, so the caller can ``release`` the slot's blocks.

    ``pools`` is the engine-owned pool tree (one token-major leaf per
    segment, cell axis at -3: (layers, T, Hkv, hd)); the copy mirrors it
    with the cell axis re-indexed to logical order, as CPU tensors (numpy
    has no bfloat16).  ``.cpu()`` waits for the device, so later in-place
    dispatches cannot change the cells mid-read.
    """
    cells = torch.from_numpy(kv.slot_cells(slot, n_tokens).astype(np.int64))
    return tree.tree_map(lambda a: a.index_select(a.ndim - 3, cells.to(a.device)).cpu(), pools)


def swap_in(pools, kv: PagedKVCache, slot: int, snapshot):
    """Restore a :func:`swap_out` copy into ``slot``'s current blocks, in
    place on the pool leaves (``index_copy_``); returns ``pools``.

    The caller re-allocates first (``ensure_capacity`` for at least the
    copy's token count); blocks will generally differ from the ones copied
    out — contents land byte-identical anyway because both sides index by
    logical position.  The reference pads the cell count to a power of two
    to bound its retraces; an in-place ``index_copy_`` traces nothing, so
    the port copies exactly the live cells.  The returned object is
    ``pools`` itself: the engine's captured dispatches hold its leaves by
    address.
    """
    n_tokens = next(iter(tree.leaves(snapshot))).shape[-3]
    cells = torch.from_numpy(kv.slot_cells(slot, n_tokens).astype(np.int64))
    for a, s in zip(tree.leaves(pools), tree.leaves(snapshot)):
        a.index_copy_(a.ndim - 3, cells.to(a.device), torch.as_tensor(s).to(a.device, a.dtype))
    return pools
