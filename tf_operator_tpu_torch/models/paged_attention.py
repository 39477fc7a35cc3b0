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
    Each launch adds one to `launches`.
  - CPU tensors run `paged_attention_plain`: gather_blocks followed by
    llama.cached_attention, the JAX package's gather oracle.  It is what
    the tests hold against the JAX kernel, and what the kernel is held
    against on the card.

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

# kernel launches since the last reset (plain-version calls not counted)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448  # shared memory one H100 block may opt into
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global launches
    launches = 0


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
    from tf_operator_tpu_torch.models.llama import cached_attention

    b, l = q.shape[:2]
    q_pos = (_positions(pos, b, q.device).to(torch.long)[:, None]
             + torch.arange(l, device=q.device))
    k_lin = paging.gather_blocks(k_pool, table)
    v_lin = paging.gather_blocks(v_pool, table)
    return cached_attention(q, k_lin, v_lin, q_pos, k_lin.shape[1],
                            window=window)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kernels.load("paged_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.paged_attention_launch.argtypes = (
            [ptr] * 6 + [i32] * 7 + [i64] * 6
            + [i32, ctypes.c_float, i32, ptr])
        lib.paged_attention_launch.restype = i32
        lib.paged_attention_max_head_dim.argtypes = []
        lib.paged_attention_max_head_dim.restype = i32
        lib.paged_attention_smem_bytes.argtypes = [i32, i32]
        lib.paged_attention_smem_bytes.restype = i64
        lib.paged_attention_error_string.argtypes = [i32]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(q, k_pool, v_pool, table, pos, window) -> torch.Tensor:
    global launches
    b, l, h, d = q.shape
    n1, bs, kv, d_pool = k_pool.shape
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        f"bfloat16")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools ({k_pool.dtype}, {v_pool.dtype}) must "
                        f"match q ({q.dtype})")
    if v_pool.shape != k_pool.shape or d_pool != d or h % kv:
        raise ValueError(f"shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("the pools must be contiguous")
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), pos_t.data_ptr(), out.data_ptr(),
        b, l, h, kv, d, bs, table.shape[1],
        q.stride(0), q.stride(1), q.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        -1 if window is None else int(window), 1.0 / math.sqrt(d),
        _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: "
            f"{lib.paged_attention_error_string(err).decode()} ({err})")
    launches += 1
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, table: torch.Tensor,
                    pos: Union[int, torch.Tensor], *,
                    window: Optional[int] = None) -> torch.Tensor:
    """Block-indexed paged attention.

    q:             [B, L, H, D] post-RoPE queries (L new positions).
    k_pool/v_pool: [N+1, bs, KV, D] block pools (id 0 = scratch).
    table:         [B, T] int32 block tables (position p in block
                   table[p // bs]; the ring formula k = q - mod(q - slot,
                   T*bs) also covers modular tables).
    pos:           int or [B] int tensor — position of q[:, 0]; row l
                   attends what is visible to pos + l.
    window:        sliding-window width; None = full causal.

    Returns [B, L, H, D] in q's dtype.  CUDA tensors go through the CUDA
    kernel (or raise); CPU tensors through paged_attention_plain."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, table, pos,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return _launch(q, k_pool, v_pool, table, pos, window)
