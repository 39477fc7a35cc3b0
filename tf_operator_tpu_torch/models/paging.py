"""Paged KV cache: block pool, block tables, and their reads and writes.

The port of tf_operator_tpu/models/paging.py.  The KV cache is a fixed
pool of blocks per layer, [num_blocks + 1, block_size, KV, D], and each
lane holds a block table [T] of ids: position p lives in block
table[p // bs] at offset p % bs.  Block id 0 is a reserved SCRATCH
block that is never handed out: frozen lanes and table padding point at
it, so their writes can never land in a block another lane owns, and
every read masks it.

Sliding-window lanes hold a MODULAR table instead: a ring of T slots,
position p in slot (p // bs) % T, so a lane touches at most T blocks
however long its sequence.  `plan_window_request` reserves a lane's
blocks, and `WindowRotation` keeps its slot map: when the ring wraps
onto a slot that still holds a shared prefix block, the lane swaps in a
pre-reserved private shadow (copying the shared bytes first while any
of them is still inside a live query's window) and drops its reference.

Host side (copied, since importing the JAX package would load jax):
`SCRATCH_BLOCK`, `blocks_for`, `BlockPool`, `build_table`, `plan_request`,
`plan_window_request`, `WindowRotation`, and the continuous scheduler's
`blocks_to_cover` and `step_gate`.
Device side: `init_block_pool`, the table-routed write (`block_write_index`
+ `write_blocks`, or `paged_cache_write` for one call), the linear-view
gather `gather_blocks` that the plain attention reads through, and the
shared prefix's copy-on-write `copy_block`.

The prefill/decode handoff (the JAX package's export/adopt layer): the
block table is the wire format.  `export_blocks` ships a lane's blocks as
blake2b content hashes in table order plus the payload of each block (host
tensors), eliding shared-prefix payload the receiver already holds;
`adopt_blocks` writes them into another pool under fresh ids, resolving
shared blocks through a `HandoffRegistry` so N adoptions of one prefix hold
N references on one block.  The hashes are taken over the same bytes in the
same order as the JAX package's, so an export crosses between the two
frameworks (through numpy).

int8 KV (`kv_quant=True`): each pool is a models/quant.QTensor, an int8
payload [N+1, bs, KV, D] and f32 scales [N+1, bs, KV, 1], one per
(position, head).  Writes quantize over head_dim and store payload and
scale through the same index; the gather keeps the QTensor.

Writes are IN PLACE on the pool tensors (the JAX package returned new
pools; here the caller's pools are updated and returned).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.quant import QTensor, quantize_tensor

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


def copy_block(cache, src: int, dst: int):
    """Copy block src -> dst in every layer's (k, v) pools, in place: the
    copy-on-write of a partial shared-prefix boundary block (the JAX
    package's `copy_block`).  An int8 pool copies payload and scales."""
    for p in _leaves(cache):
        p[dst] = p[src]
    return cache


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


def plan_window_request(prompt_len: int, max_new_tokens: int,
                        block_size: int, ring_blocks: int,
                        prefix_len: int = 0, write_slack: int = 0):
    """Admission block math for a sliding-window lane over a modular
    table of `ring_blocks` slots: (needed slots, shared prefix blocks,
    private blocks to reserve, needs boundary CoW, shared blocks the
    ring will rotate out).

    The lane touches at most ring_blocks slots whatever its length.
    Shared prefix blocks first sit in their own slots (the serve loop
    checks that the prefix fits the ring); when the ring wraps back onto
    a shared slot the lane swaps in a private shadow block and drops its
    reference.  The shadows are reserved here, at admission, so the
    memory gate's worst case is exact and a rotation never allocates.

    write_slack: positions the device may write past the worst case (a
    decode block runs to its edge after EOS or the budget); those writes
    wrap the table too, so the shadows cover them."""
    seq = prompt_len + max_new_tokens + write_slack
    last_block = (seq - 1) // block_size
    needed = min(last_block + 1, ring_blocks)
    shared = min(prefix_len // block_size, needed)
    cow = prefix_len % block_size != 0
    rotated = (max(0, min(shared, last_block - ring_blocks + 1))
               if last_block >= ring_blocks else 0)
    private = needed - shared + rotated
    return needed, shared, private, cow, rotated


class WindowRotation:
    """Host-side modular-table bookkeeping for one sliding-window lane.

    Holds the slot -> block id map and the pre-reserved shadow blocks;
    `advance(upto_pos, q_min)` walks every block index the lane is about
    to write and returns the table edits to apply before that write is
    dispatched:

      - a private slot whose old epoch retires is reused in place (no
        edit);
      - a shared (prefix) slot is swapped to a shadow block and the
        shared id returned for a decref: eviction by refcount.  While
        any of the old block's positions is still inside the window of a
        query at q_min or later, the shadow must first get a copy of the
        shared bytes (copy_block), so the offsets not yet overwritten
        stay readable; a block wholly out of the window is dropped
        without a copy."""

    def __init__(self, slot_ids: List[int], shared_count: int,
                 shadows: List[int], block_size: int,
                 window: int) -> None:
        self.slots = list(slot_ids)        # slot -> block id (0 = scratch)
        self.ring = len(slot_ids)
        # the slots that still hold a shared (read-only) block
        self.shared_slots = set(range(shared_count))
        self.shadows = list(shadows)       # pre-reserved private ids
        self.bs = block_size
        self.window = window
        self.next_block = self.ring        # the first block index that wraps

    def advance(self, upto_pos: int, q_min: int):
        """Handle every wrap up to (and including) the block holding
        `upto_pos`; returns (edits, released, evicted): edits [(slot,
        new_id, copy_src or None)], the shared ids to decref, and the
        count of retired block epochs."""
        edits, released, evicted = [], [], 0
        last = upto_pos // self.bs
        while self.next_block <= last:
            j = self.next_block
            slot = j % self.ring
            evicted += 1
            if slot in self.shared_slots:
                old = self.slots[slot]
                new = self.shadows.pop()
                # the old epoch held positions [(j - ring) * bs, + bs):
                # copy iff one of them is visible to a query at q_min or
                # later (q - window < k)
                old_max = (j - self.ring) * self.bs + self.bs - 1
                copy_src = old if old_max > q_min - self.window else None
                self.slots[slot] = new
                self.shared_slots.discard(slot)
                released.append(old)
                edits.append((slot, new, copy_src))
            self.next_block += 1
        return edits, released, evicted


def blocks_to_cover(upto_tokens: int, covered_blocks: int,
                    block_size: int) -> int:
    """Marginal blocks a lane's linear table needs to cover positions
    [0, upto_tokens), given `covered_blocks` entries already allocated:
    the continuous scheduler grows coverage lazily, per prefill segment
    and per decode block, instead of reserving the worst case."""
    return max(0, blocks_for(upto_tokens, block_size) - covered_blocks)


def step_gate(free_blocks: int, need_now: int, in_flight_lanes: int,
              ladder_per_lane: int = 1) -> bool:
    """The blocks-per-step admission gate: admit a newcomer when the
    pool covers its first prefill segment's blocks (`need_now`) plus a
    ladder of `ladder_per_lane` blocks for every request in flight, so a
    newcomer cannot take the block an admitted lane needs to cross its
    next block boundary.  Deeper shortfalls preempt, they do not
    refuse."""
    return free_blocks >= need_now + ladder_per_lane * in_flight_lanes


def init_block_pool(cfg, num_blocks: int, block_size: int,
                    dtype: Optional[torch.dtype] = None,
                    device: Union[str, torch.device, None] = None,
                    kv_quant: bool = False) -> list:
    """Per-layer (k, v) block pools [num_blocks + 1, block_size, KV, D]
    (+1: the scratch block at id 0), zeroed, in `dtype` (default
    cfg.dtype) on `device` (default "cuda").  kv_quant=True makes each
    pool a QTensor: int8 zeros and f32 ones scales [N+1, bs, KV, 1]; it
    takes no dtype."""
    dev = resolve_device(device)
    shape = (num_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
    if kv_quant:
        if dtype is not None:
            raise ValueError(
                "kv_quant and dtype are mutually exclusive: the int8 "
                "pool's layout is fixed (int8 payload + f32 scales)")

        def leaf() -> QTensor:
            return QTensor(
                q=torch.zeros(shape, dtype=torch.int8, device=dev),
                scale=torch.ones(shape[:3] + (1,), dtype=torch.float32,
                                 device=dev))

        return [(leaf(), leaf()) for _ in range(cfg.n_layers)]
    dt = dtype or cfg.dtype
    return [(torch.zeros(shape, dtype=dt, device=dev),
             torch.zeros(shape, dtype=dt, device=dev))
            for _ in range(cfg.n_layers)]


def block_write_index(pos, table: torch.Tensor, length: int,
                      block_size: int, modular: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(block ids, offsets), each [B, length], of positions pos..pos+L-1
    per row routed through table [B, T]: position p lands in block
    table[b, p // bs] at offset p % bs.

    A linear table's column CLAMPS to the last one instead of wrapping: a
    live lane's end-of-block overshoot (decode blocks run to the block
    edge past EOS or budget) writes positions past its worst case, which
    land in the lane's own last block — garbage the position mask never
    shows a query — or, for a frozen lane pinned past its zeroed table,
    in scratch.  Torch faults on an out-of-range index where JAX clamps,
    so the clamp is explicit.  modular=True (a sliding-window ring)
    wraps each row to slot (p // bs) % T of its own table; WindowRotation
    has made every slot a write wraps onto the lane's own by then, and a
    frozen lane's all-scratch row still lands in scratch.  pos is an int
    (one start for every row) or a [B] tensor (per-lane positions)."""
    b = table.shape[0]
    steps = torch.arange(length, device=table.device)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        p = pos.to(torch.long)[:, None] + steps[None, :]
    else:
        p = (int(pos) + steps)[None, :].expand(b, length)
    if modular:
        slot = torch.remainder(p // block_size, table.shape[1])
    else:
        slot = torch.clamp(p // block_size, max=table.shape[1] - 1)
    bidx = torch.gather(table.to(torch.long), 1, slot)
    return bidx, p % block_size


def write_blocks(pool, val: torch.Tensor,
                 index: Tuple[torch.Tensor, torch.Tensor]):
    """Scatter val [B, L, KV, D] into pool [N+1, bs, KV, D] at `index`
    (block_write_index), in place.  Indices are NOT unique: every frozen
    lane's table is all scratch, so several rows may write block 0 —
    last-writer-wins garbage in a block no read ever shows.  An int8
    pool (QTensor) takes quantize_tensor(val, axes=(3,)): payload and
    per-(position, head) scale through the same index."""
    bidx, off = index
    if isinstance(pool, QTensor):
        qv = quantize_tensor(val, axes=(3,))
        pool.q[bidx, off] = qv.q
        pool.scale[bidx, off] = qv.scale
        return pool
    pool[bidx, off] = val.to(pool.dtype)
    return pool


def paged_cache_write(pool, val: torch.Tensor, pos, table: torch.Tensor,
                      modular: bool = False):
    """One K or V block-pool write through a linear or (modular=True) a
    ring table, in place: the JAX package's `paged_cache_write`.  An
    int8 pool quantizes on the write."""
    return write_blocks(pool, val, block_write_index(
        pos, table, val.shape[1], pool.shape[1], modular))


def gather_blocks(pool, table: torch.Tensor):
    """[B, T*bs, KV, D] linear view of each lane's blocks: gather
    pool[table] and fold (block, offset) into one position axis.  Tables
    are position-ordered, so index p of the view IS position p — the
    position-masked attention consumes it with no paging awareness.  An
    int8 pool gathers payload and scales and stays a QTensor."""
    if isinstance(pool, QTensor):
        return QTensor(q=gather_blocks(pool.q, table),
                       scale=gather_blocks(pool.scale, table))
    g = pool[table.to(torch.long)]  # [B, T, bs, KV, D]
    b, t, bs = g.shape[:3]
    return g.reshape(b, t * bs, *g.shape[3:])


# ------------------------------------------------------------------ handoff
def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a cache (or of one payload row) in the JAX package's
    tree order: per layer k then v, a QTensor as q then scale."""
    out = []
    for k, v in tree:
        for t in (k, v):
            out.extend((t.q, t.scale) if isinstance(t, QTensor) else (t,))
    return out


def _unflatten(like, leaves: Sequence[torch.Tensor]):
    """`like`'s structure (layers of (k, v), QTensor or tensor) over
    `leaves`, given in _leaves order."""
    it = iter(leaves)

    def one(t):
        return QTensor(q=next(it), scale=next(it)) if isinstance(t, QTensor) \
            else next(it)

    return [(one(k), one(v)) for k, v in like]


_ALIGN = 16  # bytes: each tensor's segment of a packed buffer starts here


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat uint8 buffer of every tensor's bytes (raw: a bf16 value is
    never converted), each segment padded to _ALIGN bytes so the typed
    views _unpack takes back are aligned."""
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        if b.numel() % _ALIGN:
            parts.append(b.new_zeros(-b.numel() % _ALIGN))
    return torch.cat(parts)


def _unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    """Typed views into a _pack buffer, with `like`'s dtypes and shapes."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[off:off + n].view(t.dtype).reshape(t.shape))
        off += n + (-n % _ALIGN)
    return out


class HandoffError(RuntimeError):
    """A KV-block handoff cannot be adopted as shipped: wrong block size,
    or a block's payload is absent and its hash unknown to the receiver.
    The router's retry surface: resend with full payload (or re-prefill)
    on a replica that can take it."""


class BlockExport:
    """One lane's KV blocks in wire form: content hashes in table order,
    a dedupe-eligibility flag per block, and payload keyed by hash (host
    tensors, one pool block each, in the pool's structure: per layer a
    (k, v) pair of [bs, KV, D] tensors or QTensors).  `window` carries a
    sliding-window ring's state; linear lanes leave it None."""

    __slots__ = ("block_size", "hashes", "shared", "payload", "window")

    def __init__(self, block_size, hashes, shared, payload, window=None):
        self.block_size = int(block_size)
        self.hashes = list(hashes)
        self.shared = list(shared)
        self.payload = dict(payload)
        self.window = window

    def __len__(self) -> int:
        return len(self.hashes)

    def payload_blocks(self) -> int:
        """Blocks whose bytes ride this export (dedup may have elided
        shared ones already shipped)."""
        return len(self.payload)

    def nbytes(self) -> int:
        """Wire payload size: block bytes only (the table rides as
        hashes)."""
        return sum(t.numel() * t.element_size()
                   for row in self.payload.values() for t in _leaves(row))


def _hash_block(rows: Sequence[torch.Tensor]) -> str:
    """blake2b (16-byte digest) over one block's bytes, leaf by leaf in
    _leaves order: the JAX package's `_hash_block` bytes exactly."""
    h = hashlib.blake2b(digest_size=16)
    for r in rows:
        h.update(r.numpy())
    return h.hexdigest()


def export_blocks(cache, ids: Sequence[int], shared: Sequence[bool],
                  block_size: int, *, sent_hashes=None,
                  window=None) -> BlockExport:
    """Export blocks `ids` (in table order) from `cache` in wire form.
    `shared[i]` marks block i dedupe-eligible (whole shared-prefix blocks
    only: a CoW boundary block's tail is lane-private).  `sent_hashes`
    (a caller-owned set) elides the payload of shared blocks already
    shipped to the same receiver.  One gather per leaf on the pool's
    device, then one copy of every exported block to the host, as the
    JAX package's single device_get."""
    if len(ids) != len(shared):
        raise ValueError(
            f"ids/shared length mismatch: {len(ids)} vs {len(shared)}")
    leaves = _leaves(cache)
    idx = torch.tensor(list(ids), dtype=torch.long, device=leaves[0].device)
    gathered = [p.index_select(0, idx) for p in leaves]
    host = _unpack(_pack(gathered).cpu(), gathered)  # device sync
    raw = [h.view(torch.uint8).reshape(len(ids), -1) for h in host]
    hashes = [_hash_block([r[i] for r in raw]) for i in range(len(ids))]
    payload: Dict[str, list] = {}
    for i, (h, sh) in enumerate(zip(hashes, shared)):
        if sh and sent_hashes is not None and h in sent_hashes:
            continue  # the receiver already holds these bytes
        if h in payload:
            continue
        payload[h] = _unflatten(cache, [t[i] for t in host])
        if sh and sent_hashes is not None:
            sent_hashes.add(h)
    return BlockExport(block_size, hashes, shared, payload, window)


class HandoffRegistry:
    """Receiver-side dedup: content hash -> adopted block id, tied to one
    BlockPool's refcounts.  The registry holds no reference of its own: a
    mapping lives exactly as long as some lane holds the block, so every
    decref of a possibly registered id goes through release()."""

    def __init__(self, pool: BlockPool) -> None:
        self.pool = pool
        self._id_of: Dict[str, int] = {}
        self._hash_of: Dict[int, str] = {}
        self.dedup_hits = 0

    def lookup(self, h: str) -> Optional[int]:
        return self._id_of.get(h)

    def register(self, h: str, block_id: int) -> None:
        self._id_of[h] = block_id
        self._hash_of[block_id] = h

    def adopt_shared(self, h: str) -> Optional[int]:
        """Dedup hit: one more reference on the block already holding
        these bytes, or None when the hash is unknown."""
        bid = self._id_of.get(h)
        if bid is None:
            return None
        self.pool.incref([bid])
        self.dedup_hits += 1
        return bid

    def release(self, ids: Sequence[int]) -> int:
        """decref that keeps the map honest: ids this decref frees drop
        their registration."""
        freed = 0
        for b in list(ids):
            f = self.pool.decref([b])
            freed += f
            if f:
                h = self._hash_of.pop(b, None)
                if h is not None:
                    self._id_of.pop(h, None)
        return freed


def adoption_cost(export: BlockExport, registry=None) -> int:
    """Fresh blocks an adoption of `export` allocates now, given the
    registry's contents: the admission gate's unit (a dedup hit costs an
    incref, not a block)."""
    fresh = 0
    seen = set()
    for h, sh in zip(export.hashes, export.shared):
        if sh and h in seen:
            continue
        if sh and registry is not None and registry.lookup(h) is not None:
            continue
        fresh += 1
        if sh:
            seen.add(h)
    return fresh


def scatter_blocks(cache, ids: Sequence[int], rows: Sequence):
    """Adoption's device half, the JAX package's adoption scatter (its
    `paging.write_blocks(cache, ids, rows)`; not this module's
    table-routed `write_blocks`): write payload rows (one pool block
    each, in the pool's structure) into the pool at block `ids`, in
    place, one index_copy_ per leaf.  The rows cross to the pool's
    device as one buffer.  Only the given rows are written: JAX pads the
    count with scratch rows to bound its recompiles, and nothing here
    compiles per count."""
    leaves = _leaves(cache)
    dev = leaves[0].device
    stacked = [torch.stack(col) for col in zip(*(_leaves(r) for r in rows))]
    on_dev = _unpack(_pack(stacked).to(dev), stacked)
    idx = torch.tensor(list(ids), dtype=torch.long, device=dev)
    for p, v in zip(leaves, on_dev):
        p.index_copy_(0, idx, v)
    return cache


def adopt_blocks(cache, pool: BlockPool, export: BlockExport,
                 registry: Optional[HandoffRegistry] = None):
    """Adopt an exported lane into (cache, pool): fresh ids in table
    order, shared blocks deduped through `registry` (an incref instead of
    alloc + write), every fresh block written by one scatter_blocks.
    Returns (cache, adopted_ids, shared_ids, own_ids, stats): adopted_ids
    is the table row; shared_ids (free them through registry.release)
    and own_ids (plain decref) split ownership for the lane's finish.
    stats = {"fresh", "deduped", "payload_blocks"}.

    Raises HandoffError on a block-size mismatch or when a block's
    payload is missing and its hash unknown, and RuntimeError when the
    pool cannot cover the fresh blocks (callers gate on adoption_cost).
    Unlike the JAX package, which allocates blocks 0..i-1 before it
    raises at block i, every block is resolved and the pool checked
    BEFORE anything is allocated or increfed: a refused adoption leaves
    the pool's free list, its refcounts and the registry as they were.
    A successful one makes the same calls in the same order."""
    if export.block_size != pool.block_size:
        raise HandoffError(
            f"block size mismatch: export {export.block_size} vs "
            f"pool {pool.block_size}")
    # adoption_cost counts a shared hash that repeats in the export once,
    # which holds only where a registry dedups it
    fresh = (adoption_cost(export, registry) if registry is not None
             else len(export.hashes))
    for i, (h, sh) in enumerate(zip(export.hashes, export.shared)):
        hit = sh and registry is not None and registry.lookup(h) is not None
        if not hit and h not in export.payload:
            raise HandoffError(
                f"block {i}: payload for hash {h} not shipped and not "
                f"resident — resend with full payload")
    if not pool.can_alloc(fresh):
        raise RuntimeError(
            f"pool exhausted: {fresh} blocks requested, "
            f"{pool.free_blocks} free of {pool.num_blocks}")
    adopted, shared_ids, own_ids = [], [], []
    write_ids, write_rows = [], []
    deduped = 0
    for h, sh in zip(export.hashes, export.shared):
        if sh and registry is not None:
            bid = registry.adopt_shared(h)
            if bid is not None:
                adopted.append(bid)
                shared_ids.append(bid)
                deduped += 1
                continue
        [bid] = pool.alloc(1)
        adopted.append(bid)
        if sh:
            shared_ids.append(bid)
            if registry is not None:
                registry.register(h, bid)
        else:
            own_ids.append(bid)
        write_ids.append(bid)
        write_rows.append(export.payload[h])
    if write_rows:
        scatter_blocks(cache, write_ids, write_rows)
    stats = {"fresh": len(write_ids), "deduped": deduped,
             "payload_blocks": len(write_ids)}
    return cache, adopted, shared_ids, own_ids, stats
