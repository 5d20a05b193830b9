"""Paged (block) KV cache for serving: free-list allocator + page pools.

Port of ``repro.serve.kv_cache``.  The cache is a shared pool of
fixed-size pages; each slot holds an int32 *block table* mapping its
logical pages to physical ones, so short and long requests only pay for
what they reserve.

Layout (mirrors ``transformer.paged_decode_step`` and the
``paged_flash_decode`` kernel):

- ``k_pool`` / ``v_pool``: ``(n_layers, n_blocks, block_size, kv_heads,
  hd)`` tensors on the serving device.  Page 0 is the reserved **null
  page**: idle slots point all their table entries at it, so their
  (discarded) decode writes land where no live request reads.
- ``block_tables``: ``(slots, max_blocks)`` int32, host-authoritative with
  a device copy refreshed on change.  Admission reserves a request's FULL
  budget (prompt bucket + max_new_tokens) up front, so decode can never
  stall on an empty free list mid-generation.

All bookkeeping (free list, lengths, pads) lives on the host; only the
pools and the step inputs are device tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

NULL_PAGE = 0


class BlockAllocator:
    """Free-list allocator over physical pages; page 0 is never handed out."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need at least 2 blocks (page 0 is reserved)")
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() yields 1, 2, ...

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_usable(self) -> int:
        return self.n_blocks - 1

    def alloc(self, n: int) -> Optional[list[int]]:
        """Reserve ``n`` pages, or None (and reserve nothing) if short."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == NULL_PAGE:
                raise ValueError("cannot free the reserved null page")
            if b in self._free:
                raise ValueError(f"double free of page {b}")
            self._free.append(b)


@dataclasses.dataclass
class SlotInfo:
    pages: list[int] = dataclasses.field(default_factory=list)
    length: int = 0          # decode position (rows written so far)
    pad: int = 0             # left-pad rows at the front (masked in attention)


class PagedKVCache:
    """Device page pools + host block tables for ``slots`` decode lanes."""

    def __init__(self, cfg: ArchConfig, *, n_blocks: int, block_size: int,
                 slots: int, max_blocks_per_slot: int, dtype=torch.float32,
                 device="cpu"):
        self.cfg = cfg
        self.block_size = block_size
        self.slots = slots
        self.max_blocks_per_slot = max_blocks_per_slot
        self.device = torch.device(device)
        shape = (cfg.n_layers, n_blocks, block_size, cfg.kv_heads,
                 cfg.head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.allocator = BlockAllocator(n_blocks)
        self._tables = np.full((slots, max_blocks_per_slot), NULL_PAGE,
                               np.int32)
        self._slot_info = [SlotInfo() for _ in range(slots)]
        self._tables_dev: Optional[torch.Tensor] = None

    def pages_needed(self, budget_tokens: int) -> int:
        return -(-budget_tokens // self.block_size)

    def can_ever_admit(self, budget_tokens: int) -> bool:
        """Whether a request of this budget fits an empty cache at all."""
        need = self.pages_needed(budget_tokens)
        return need <= min(self.max_blocks_per_slot, self.allocator.n_usable)

    # -- admission / release -------------------------------------------------
    def admit(self, slot: int, budget_tokens: int) -> bool:
        """Reserve pages for a request's full token budget; False if it
        doesn't fit (either in the pool or in the slot's table width)."""
        info = self._slot_info[slot]
        if info.pages:
            raise ValueError(f"slot {slot} is already occupied")
        need = self.pages_needed(budget_tokens)
        if need > self.max_blocks_per_slot:
            return False
        pages = self.allocator.alloc(need)
        if pages is None:
            return False
        info.pages = pages
        info.length = 0
        info.pad = 0
        self._tables[slot] = NULL_PAGE
        self._tables[slot, :need] = pages
        self._tables_dev = None
        return True

    def release(self, slot: int) -> None:
        info = self._slot_info[slot]
        if info.pages:
            self.allocator.free(info.pages)
        self._slot_info[slot] = SlotInfo()
        self._tables[slot] = NULL_PAGE
        self._tables_dev = None

    # -- device views --------------------------------------------------------
    @property
    def block_tables(self) -> torch.Tensor:
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._tables.copy()).to(
                self.device)
        return self._tables_dev

    @property
    def lengths(self) -> np.ndarray:
        return np.array([s.length for s in self._slot_info], np.int32)

    @property
    def pads(self) -> np.ndarray:
        return np.array([s.pad for s in self._slot_info], np.int32)

    def occupancy(self) -> float:
        """Fraction of usable pages currently reserved."""
        a = self.allocator
        return 1.0 - a.n_free / a.n_usable

    # -- data movement -------------------------------------------------------
    def write_prefill(self, slot: int, k_new: torch.Tensor,
                      v_new: torch.Tensor, *, pad: int = 0) -> None:
        """Copy a prefill's cache rows into the slot's reserved pages.

        k_new/v_new: ``(n_layers, S, kv_heads, hd)`` — the dense prefill
        cache for one request (S rows, left-pad included).  Sets the slot's
        length to S and records ``pad``.
        """
        info = self._slot_info[slot]
        n_layers, s, kvh, hd = k_new.shape
        bs = self.block_size
        n_pages = -(-s // bs)
        if n_pages > len(info.pages):
            raise ValueError(f"slot {slot}: prefill of {s} rows exceeds the "
                             f"{len(info.pages)} reserved pages")
        pages = torch.as_tensor(info.pages[:n_pages], dtype=torch.long,
                                device=self.device)
        for pool, rows in ((self.k_pool, k_new), (self.v_pool, v_new)):
            padded = torch.zeros((n_layers, n_pages * bs, kvh, hd),
                                 dtype=pool.dtype, device=self.device)
            padded[:, :s] = rows
            pool[:, pages] = padded.view(n_layers, n_pages, bs, kvh, hd)
        info.length = s
        info.pad = pad

    def set_length(self, slot: int, length: int) -> None:
        self._slot_info[slot].length = length

    def gather_contiguous(self, slot: int):
        """Read the slot's pages back as dense ``(L, cap, KV, hd)`` k/v —
        test/debug helper, not a serving path."""
        table = torch.as_tensor(self._tables[slot], dtype=torch.long,
                                device=self.device)
        n_layers, _, bs, kvh, hd = self.k_pool.shape
        cap = table.shape[0] * bs
        k = self.k_pool[:, table].reshape(n_layers, cap, kvh, hd)
        v = self.v_pool[:, table].reshape(n_layers, cap, kvh, hd)
        return k, v
