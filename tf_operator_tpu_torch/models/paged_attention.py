"""Paged attention: a hand-written CUDA kernel for the card, and its plain
PyTorch version.

The port of tf_operator_tpu/models/paged_attention.py (`paged_attention`,
a Pallas TPU kernel).  `paged_attention(q, k_pool, v_pool, table, pos)`
computes, for q [B, L, H, D] post-RoPE queries at positions pos..pos+L-1
per lane, GQA attention over the positions each lane's block table
[B, T] routes into the pools [N+1, bs, KV, D] — without materializing
a linear K/V view on the card.

  - CUDA tensors launch csrc/paged_attention.cu (built by kernels.py at
    first use) or raise; nothing on the card reaches the plain version.
    Each call adds one to `launches`.  bf16 queries take the tensor-core
    design (mma.sync tiles, a cp.async ring; csrc/mma_tiles.cuh) and also
    add one to `launches_mma`; with at most 16 rows per (kv head, lane)
    (decode) it splits the table into chunks (`split_slots`, a host-side
    rule) and merges their partials in a second small kernel, the two
    counted as one call.  f32 queries keep the scalar design, which stays
    exact in f32 (the tensor cores would round to TF32).
  - CPU tensors run `paged_attention_plain`: gather_blocks followed by
    llama.cached_attention, the JAX package's gather oracle.  It is what
    the tests hold against the JAX kernel, and what the kernel is held
    against on the card.

int8 pools (models/quant.QTensor: int8 payload, f32 scale per (position,
head)) take the same call.  On the card they launch K1q, the same kernel
reading the int8 payload and dequantizing each block inside it; each
launch adds one to `launches_int8` (and, for bf16 queries, to
`launches_int8_mma`: the payload is staged raw by cp.async and each tile
dequantized to bf16 in shared memory, with K1q's bits).  On the CPU they run
`paged_attention_int8_plain`: gather, dequantize to q's dtype, then
cached_attention.

The two agree on every live row.  A row with no visible position (a
frozen lane, whose table is all scratch) finalizes to 0 in the kernel,
as on the TPU, while the plain version averages it uniformly; the serve
loop discards such rows' tokens.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from tf_operator_tpu_torch import kernels
from tf_operator_tpu_torch.models import paging
from tf_operator_tpu_torch.models.quant import QTensor

# kernel launches since the last reset (plain-version calls not counted):
# K1 on float pools, K1q on int8 pools; the _mma counts are the calls among
# them that took the tensor-core design (bf16 queries)
launches = 0
launches_int8 = 0
launches_mma = 0
launches_int8_mma = 0

# the decode split: calls with at most SPLIT_MAX_ROWS query rows per (kv
# head, lane) cut the table into chunks, each its own block, so that about
# SPLIT_TARGET_BLOCKS blocks (4 per SM of an H100's 132) stream the pool
SPLIT_MAX_ROWS = 16
SPLIT_TARGET_BLOCKS = 4 * 132
SPLIT_MIN_KEYS = 128  # two 64-key tiles: the copy of one overlaps the other

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448  # shared memory one H100 block may opt into
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global launches, launches_int8, launches_mma, launches_int8_mma
    launches = 0
    launches_int8 = 0
    launches_mma = 0
    launches_int8_mma = 0


def split_slots(rows: int, n_slots: int, bs: int, programs: int) -> int:
    """Table slots per chunk of the decode split, or 0 for no split.

    rows: query rows per (kv head, lane), L * G; programs: (kv head, lane)
    pairs, KV * B.  A chunk starts at SPLIT_MIN_KEYS keys and doubles while
    chunks twice as long would still give SPLIT_TARGET_BLOCKS blocks and
    one chunk does not yet cover the table."""
    if rows > SPLIT_MAX_ROWS:
        return 0
    n_keys = n_slots * bs
    keys = SPLIT_MIN_KEYS
    while (keys < n_keys and programs * -(-n_keys // (2 * keys))
           >= SPLIT_TARGET_BLOCKS):
        keys *= 2
    return -(-keys // bs)


def chunk_bounds(n_slots: int, slots_per_chunk: int) -> list:
    """[lo, hi) table slots of each chunk, in the order the merge takes
    them (the kernel's chunk c is slots c * slots_per_chunk onwards)."""
    return [(lo, min(lo + slots_per_chunk, n_slots))
            for lo in range(0, n_slots, slots_per_chunk)]


def paged_attention_split_plain(q: torch.Tensor, k_pool, v_pool,
                                table: torch.Tensor, pos, *,
                                slots_per_chunk: int,
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """The decode split written plainly: per chunk of table slots, the
    partial (m, l, unnormalized acc) over the keys visible in it (ring
    visibility, window, scratch blocks masked; p rounded to q's dtype for
    PV), then the partials merged in chunk order.  An empty chunk holds
    m = -1e30, l = 0, acc = 0 and adds nothing; a row with no visible key
    finalizes to 0, as the kernel's.  Float or QTensor pools."""
    b, n_q, h, d = q.shape
    if isinstance(k_pool, QTensor):
        k_lin = paging.gather_blocks(k_pool, table).dequantize(q.dtype)
        v_lin = paging.gather_blocks(v_pool, table).dequantize(q.dtype)
    else:
        k_lin = paging.gather_blocks(k_pool, table)
        v_lin = paging.gather_blocks(v_pool, table)
    n_slots = table.shape[1]
    c, kvh = k_lin.shape[1], k_lin.shape[2]
    bs = c // n_slots
    qp = (_positions(pos, b, q.device).to(torch.long)[:, None]
          + torch.arange(n_q, device=q.device))                # [B, L]
    slot = torch.arange(c, device=q.device)
    kg = qp[..., None] - torch.remainder(qp[..., None] - slot, c)
    vis = kg >= 0
    if window is not None:
        vis &= kg > qp[..., None] - window
    vis &= (table != 0).repeat_interleave(bs, dim=1)[:, None, :]
    qg = q.float().reshape(b, n_q, kvh, h // kvh, d)
    sc = torch.einsum("bljgd,bcjd->bjlgc", qg, k_lin.float()) / math.sqrt(d)
    vis = vis[:, None, :, None, :]                             # [B,1,L,1,C]
    parts = []
    for lo, hi in chunk_bounds(n_slots, slots_per_chunk):
        keys = (slot >= lo * bs) & (slot < hi * bs)
        s_c = torch.where(vis & keys, sc, -math.inf)
        m_c = s_c.amax(dim=-1, keepdim=True).clamp(min=-1e30)
        p = torch.exp(s_c - m_c)                               # masked: 0
        acc = torch.einsum("bjlgc,bcjd->bjlgd", p.to(q.dtype).float(),
                           v_lin.float())
        parts.append((m_c, p.sum(dim=-1, keepdim=True), acc))
    mx = parts[0][0]
    for m_c, _, _ in parts[1:]:
        mx = torch.maximum(mx, m_c)
    l_sum, acc_sum = 0.0, 0.0
    for m_c, l_c, acc in parts:
        w = torch.exp(m_c - mx)
        l_sum = l_sum + l_c * w
        acc_sum = acc_sum + acc * w
    out = acc_sum / torch.where(l_sum == 0.0, 1.0, l_sum)
    return out.permute(0, 2, 1, 3, 4).reshape(b, n_q, h, d).to(q.dtype)


def _positions(pos, b: int, device: torch.device) -> torch.Tensor:
    """pos as a [B] int32 tensor on `device`."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        return pos.to(device=device, dtype=torch.int32)
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, table: torch.Tensor, pos,
                          *, window: Optional[int] = None) -> torch.Tensor:
    """The plain version: gather each lane's linear view and run the
    ring-visibility attention over it (llama.cached_attention)."""
    return _attend_linear(q, paging.gather_blocks(k_pool, table),
                          paging.gather_blocks(v_pool, table), pos, window)


def paged_attention_int8_plain(q: torch.Tensor, k_pool: QTensor,
                               v_pool: QTensor, table: torch.Tensor, pos,
                               *, window: Optional[int] = None
                               ) -> torch.Tensor:
    """K1q's plain version: gather each lane's int8 blocks and their
    scales, dequantize them to q's dtype ((f32 payload * scale) rounded,
    QTensor.dequantize), and attend over the linear view."""
    if not (isinstance(k_pool, QTensor) and isinstance(v_pool, QTensor)):
        raise TypeError("paged_attention_int8_plain takes QTensor pools")
    return _attend_linear(
        q, paging.gather_blocks(k_pool, table).dequantize(q.dtype),
        paging.gather_blocks(v_pool, table).dequantize(q.dtype), pos, window)


def _attend_linear(q, k_lin, v_lin, pos, window) -> torch.Tensor:
    from tf_operator_tpu_torch.models.llama import cached_attention

    b, l = q.shape[:2]
    q_pos = (_positions(pos, b, q.device).to(torch.long)[:, None]
             + torch.arange(l, device=q.device))
    return cached_attention(q, k_lin, v_lin, q_pos, k_lin.shape[1],
                            window=window)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kernels.load("paged_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.paged_attention_launch.argtypes = (
            [ptr] * 7 + [i32] * 8 + [i64] * 6
            + [i32, ctypes.c_float, i32, ptr])
        lib.paged_attention_launch.restype = i32
        lib.paged_attention_int8_launch.argtypes = (
            [ptr] * 9 + [i32] * 8 + [i64] * 6
            + [i32, ctypes.c_float, i32, ptr])
        lib.paged_attention_int8_launch.restype = i32
        lib.paged_attention_max_head_dim.argtypes = []
        lib.paged_attention_max_head_dim.restype = i32
        lib.paged_attention_smem_bytes.argtypes = [i32, i32]
        lib.paged_attention_smem_bytes.restype = i64
        lib.paged_attention_error_string.argtypes = [i32]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(q, k_pool, v_pool, table, pos, window) -> torch.Tensor:
    """Check the operands and launch K1 (float pools) or K1q (QTensor
    pools) on q's stream; returns the output [B, L, H, D] in q's dtype."""
    global launches, launches_int8, launches_mma, launches_int8_mma
    int8 = isinstance(k_pool, QTensor)
    if int8 != isinstance(v_pool, QTensor):
        raise TypeError("k_pool and v_pool must both be QTensor or neither")
    b, l, h, d = q.shape
    payload = (k_pool.q, v_pool.q) if int8 else (k_pool, v_pool)
    n1, bs, kv, d_pool = payload[0].shape
    dev = q.device
    named = [("k_pool", payload[0]), ("v_pool", payload[1]),
             ("table", table)]
    if int8:
        named += [("k_pool.scale", k_pool.scale),
                  ("v_pool.scale", v_pool.scale)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        f"bfloat16")
    want = torch.int8 if int8 else q.dtype
    if payload[0].dtype != want or payload[1].dtype != want:
        raise TypeError(f"pools ({payload[0].dtype}, {payload[1].dtype}) "
                        f"must match q ({q.dtype}), or be int8 QTensors")
    if payload[1].shape != payload[0].shape or d_pool != d or h % kv:
        raise ValueError(f"shapes q {tuple(q.shape)}, pools "
                         f"{tuple(payload[0].shape)}/"
                         f"{tuple(payload[1].shape)}")
    if not (payload[0].is_contiguous() and payload[1].is_contiguous()):
        raise ValueError("the pools must be contiguous")
    if int8:
        for sc in (k_pool.scale, v_pool.scale):
            if (sc.dtype != torch.float32 or sc.shape != (n1, bs, kv, 1)
                    or not sc.is_contiguous()):
                raise ValueError(
                    f"int8 pool scales must be contiguous float32 "
                    f"{(n1, bs, kv, 1)}, got {sc.dtype} {tuple(sc.shape)}")
    if q.stride(-1) != 1:
        raise ValueError("q must have unit stride on its last dim")
    if (table.dtype != torch.int32 or table.dim() != 2
            or table.shape[0] != b or not table.is_contiguous()):
        raise ValueError(f"table must be a contiguous int32 [B={b}, T] "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
    if b > 65535 or kv > 65535:
        raise ValueError(f"B={b} and KV={kv} must be <= 65535 (grid dims)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    lib = _load()
    if d > lib.paged_attention_max_head_dim():
        raise ValueError(f"head_dim {d} > the kernel's "
                         f"{lib.paged_attention_max_head_dim()}")
    if lib.paged_attention_smem_bytes(d, bs) > _MAX_SMEM:
        raise ValueError(f"block_size {bs} x head_dim {d} needs more "
                         f"shared memory than one block can have")
    pos_t = _positions(pos, b, dev).contiguous()
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=dev)
    n_slots = table.shape[1]
    mma = q.dtype == torch.bfloat16
    rows = l * (h // kv)
    chunk = split_slots(rows, n_slots, bs, kv * b) if mma else 0
    part = None
    if chunk:
        # per (lane, kv head, chunk, row): m, l and the f32 acc [D]
        n_chunks = -(-n_slots // chunk)
        part = torch.empty(b * kv * n_chunks * rows * (2 + d),
                           dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pools = [payload[0].data_ptr(), payload[1].data_ptr()]
    if int8:
        pools += [k_pool.scale.data_ptr(), v_pool.scale.data_ptr()]
    fn = (lib.paged_attention_int8_launch if int8
          else lib.paged_attention_launch)
    err = fn(
        q.data_ptr(), *pools, table.data_ptr(), pos_t.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), b, l, h,
        kv, d, bs, n_slots, chunk, q.stride(0), q.stride(1), q.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        -1 if window is None else int(window), 1.0 / math.sqrt(d),
        _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: "
            f"{lib.paged_attention_error_string(err).decode()} ({err})")
    if int8:
        launches_int8 += 1
        launches_int8_mma += mma
    else:
        launches += 1
        launches_mma += mma
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, table: torch.Tensor,
                    pos: Union[int, torch.Tensor], *,
                    window: Optional[int] = None) -> torch.Tensor:
    """Block-indexed paged attention.

    q:             [B, L, H, D] post-RoPE queries (L new positions).
    k_pool/v_pool: [N+1, bs, KV, D] block pools (id 0 = scratch), or
                   QTensor pools (int8 payload, f32 scales [N+1, bs, KV,
                   1]).
    table:         [B, T] int32 block tables (position p in block
                   table[p // bs]; the ring formula k = q - mod(q - slot,
                   T*bs) also covers modular tables).
    pos:           int or [B] int tensor — position of q[:, 0]; row l
                   attends what is visible to pos + l.
    window:        sliding-window width; None = full causal.

    Returns [B, L, H, D] in q's dtype.  CUDA tensors go through the CUDA
    kernel, K1 or K1q (or raise); CPU tensors through
    paged_attention_plain or paged_attention_int8_plain."""
    if q.device.type == "cpu":
        plain = (paged_attention_int8_plain if isinstance(k_pool, QTensor)
                 else paged_attention_plain)
        return plain(q, k_pool, v_pool, table, pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return _launch(q, k_pool, v_pool, table, pos, window)
