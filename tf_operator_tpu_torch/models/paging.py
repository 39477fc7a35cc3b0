"""Paged KV cache: block pool, block tables, and their reads and writes.

The port of tf_operator_tpu/models/paging.py's linear-table half.  The KV
cache is a fixed pool of blocks per layer, [num_blocks + 1, block_size,
KV, D], and each lane holds a block table [T] of ids: position p lives in
block table[p // bs] at offset p % bs.  Block id 0 is a reserved SCRATCH
block that is never handed out: frozen lanes and table padding point at
it, so their writes can never land in a block another lane owns, and
every read masks it.

Host side (copied, since importing the JAX package would load jax):
`SCRATCH_BLOCK`, `blocks_for`, `BlockPool`, `build_table`, `plan_request`.
Device side: `init_block_pool`, the table-routed write (`block_write_index`
+ `write_blocks`, or `paged_cache_write` for one call) and the linear-view
gather `gather_blocks` that the plain attention reads through.

Writes are IN PLACE on the pool tensors (the JAX package returned new
pools; here the caller's pools are updated and returned).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from tf_operator_tpu_torch.device import resolve_device

# block id 0: reserved scratch target for frozen lanes and table padding
SCRATCH_BLOCK = 0


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold `tokens` positions (ceil division)."""
    return -(-tokens // block_size)


class BlockPool:
    """Host-side allocator over `num_blocks` usable block ids (1-based;
    id 0 is the scratch block and is never handed out).

    Pure bookkeeping: allocation/refcounting happens between device
    dispatches, and the device pools are indexed by the ids this hands
    out.  Every id has a refcount — 1 for a lane-private block, +1 per
    sharing lane for a prefix block — and returns to the free list
    exactly when its count hits zero.  Double-free and foreign-id
    misuse raise instead of corrupting the free list: an allocator bug
    here would silently alias two lanes' KV."""

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # pop() hands out low ids first (1, 2, ...) — deterministic
        # placement, and blocks-used reads as a compact prefix of the pool
        self._free = list(range(num_blocks, 0, -1))
        self._ref = [0] * (num_blocks + 1)

    # ------------------------------------------------------------ state
    @property
    def used(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    # ------------------------------------------------------- operations
    def alloc(self, n: int) -> List[int]:
        """Take n blocks (refcount 1 each); raises if the pool cannot
        cover them — callers gate admission on can_alloc first."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise RuntimeError(
                f"pool exhausted: {n} blocks requested, "
                f"{len(self._free)} free of {self.num_blocks}")
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        return ids

    def incref(self, ids: Sequence[int]) -> None:
        """Share live blocks (prefix reuse): each id must already be
        allocated — increffing a free block would resurrect it."""
        for b in ids:
            if not 1 <= b <= self.num_blocks or self._ref[b] < 1:
                raise RuntimeError(
                    f"incref of unallocated block {b} (ref "
                    f"{self._ref[b] if 0 <= b <= self.num_blocks else '?'})")
            self._ref[b] += 1

    def decref(self, ids: Sequence[int]) -> int:
        """Drop one reference per id; ids whose count hits zero return
        to the free list (exactly once — a second decref raises).
        Returns how many blocks were actually freed."""
        freed = 0
        for b in ids:
            if not 1 <= b <= self.num_blocks or self._ref[b] < 1:
                raise RuntimeError(
                    f"decref of unallocated block {b} — double free")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                freed += 1
        return freed


def build_table(ids: Sequence[int], width: int,
                pad: int = SCRATCH_BLOCK) -> torch.Tensor:
    """One lane's table row [width] (int32, on the CPU): block ids in
    position order, padded with the scratch id (padding slots sit past
    the lane's written length and are masked by position)."""
    if len(ids) > width:
        raise ValueError(
            f"table of {len(ids)} blocks exceeds width {width}")
    return torch.tensor(list(ids) + [pad] * (width - len(ids)),
                        dtype=torch.int32)


def plan_request(prompt_len: int, max_new_tokens: int, headroom: int,
                 block_size: int, prefix_len: int = 0):
    """Admission block math for one request whose FULL prompt (prefix
    included) is `prompt_len` tokens: (total blocks, fully-shared
    prefix blocks, private blocks, needs boundary CoW).

    The first prefix_len // block_size blocks are whole-prefix and
    shareable by refcount; a partial boundary block (prefix_len not a
    block multiple) must be copied per lane and counts private.  Private
    blocks cover everything from the boundary through prompt + max_new
    + headroom — the worst case the memory gate reserves."""
    total = blocks_for(prompt_len + max_new_tokens + headroom, block_size)
    shared = min(prefix_len // block_size, total)
    cow = prefix_len % block_size != 0
    return total, shared, total - shared, cow


def init_block_pool(cfg, num_blocks: int, block_size: int,
                    dtype: Optional[torch.dtype] = None,
                    device: Union[str, torch.device, None] = None
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer (k, v) block pools [num_blocks + 1, block_size, KV, D]
    (+1: the scratch block at id 0), zeroed, in `dtype` (default
    cfg.dtype) on `device` (default "cuda")."""
    dev = resolve_device(device)
    shape = (num_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.dtype
    return [(torch.zeros(shape, dtype=dt, device=dev),
             torch.zeros(shape, dtype=dt, device=dev))
            for _ in range(cfg.n_layers)]


def block_write_index(pos, table: torch.Tensor, length: int,
                      block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(block ids, offsets), each [B, length], of positions pos..pos+L-1
    per row routed through table [B, T]: position p lands in block
    table[b, p // bs] at offset p % bs.

    The table column CLAMPS to the last one instead of wrapping: a live
    lane's end-of-block overshoot (decode blocks run to the block edge
    past EOS or budget) writes positions past its worst case, which land
    in the lane's own last block — garbage the position mask never shows
    a query — or, for a frozen lane pinned past its zeroed table, in
    scratch.  Torch faults on an out-of-range index where JAX clamps, so
    the clamp is explicit.  pos is an int (one start for every row) or
    a [B] tensor (per-lane positions)."""
    b = table.shape[0]
    steps = torch.arange(length, device=table.device)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        p = pos.to(torch.long)[:, None] + steps[None, :]
    else:
        p = (int(pos) + steps)[None, :].expand(b, length)
    slot = torch.clamp(p // block_size, max=table.shape[1] - 1)
    bidx = torch.gather(table.to(torch.long), 1, slot)
    return bidx, p % block_size


def write_blocks(pool: torch.Tensor, val: torch.Tensor,
                 index: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Scatter val [B, L, KV, D] into pool [N+1, bs, KV, D] at `index`
    (block_write_index), in place.  Indices are NOT unique: every frozen
    lane's table is all scratch, so several rows may write block 0 —
    last-writer-wins garbage in a block no read ever shows."""
    bidx, off = index
    pool[bidx, off] = val.to(pool.dtype)
    return pool


def paged_cache_write(pool: torch.Tensor, val: torch.Tensor, pos,
                      table: torch.Tensor) -> torch.Tensor:
    """One K or V block-pool write through a linear table, in place
    (the JAX package's `_block_write` with modular=False)."""
    return write_blocks(pool, val, block_write_index(
        pos, table, val.shape[1], pool.shape[1]))


def gather_blocks(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[B, T*bs, KV, D] linear view of each lane's blocks: gather
    pool[table] and fold (block, offset) into one position axis.  Tables
    are position-ordered, so index p of the view IS position p — the
    position-masked attention consumes it with no paging awareness."""
    g = pool[table.to(torch.long)]  # [B, T, bs, KV, D]
    b, t, bs = g.shape[:3]
    return g.reshape(b, t * bs, *g.shape[3:])
