"""Flash attention: hand-written CUDA kernels for the card (forward, dQ,
dK/dV), their plain PyTorch versions, and the autograd Function that joins
them.

The port of tf_operator_tpu/ops/flash_attention.py (`flash_attention`, a
Pallas TPU kernel pair behind a custom VJP).  `flash_attention(q, k, v,
causal, window=None)` takes [B, S, H, D] q and compact [B, S, KV, D] k/v
(H % KV == 0: grouped-query attention is native) and returns
softmax(q kᵀ / sqrt(D)) v in q's dtype; it is differentiable.

  - CUDA tensors launch csrc/flash_attention.cu (built by kernels.py at
    first use) or raise: K2f (`flash_fwd`) forward, K2q (`flash_dq`) and
    K2kv (`flash_dkv`) backward.  Each wrapper adds one to its count in
    `launches` per launch.  bf16 inputs take the tensor-core designs
    (wgmma tiles, cp.async rings; csrc/mma_tiles.cuh) and also count in
    `launches["flash_fwd_mma"]`, `["flash_dq_mma"]` and
    `["flash_dkv_mma"]`; f32 inputs run the scalar f32 designs, which
    keep f32 exact (no TF32).
  - CPU tensors run the plain versions `flash_fwd_plain`,
    `flash_dq_plain` and `flash_dkv_plain`: the same arithmetic as the
    kernels in whole-sequence tensor ops.  The tests hold them against
    the JAX kernels; chip_smoke.py holds the kernels against them.

The Function's forward saves (q, k, v, out, lse); its backward computes
delta = Σ(out · dO) in f32 with a torch op from the rounded output, as the
JAX wrapper does outside Pallas, and then runs the two backward kernels.
Under torch.utils.checkpoint the forward runs again in the backward pass
and the recomputed tensors are the ones saved.

Unlike the TPU wrapper, which needs a 128-aligned tiling of S and falls
back to the einsum path otherwise, the kernels mask the tail tile and take
any S.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from tf_operator_tpu_torch import kernels

NEG_INF = -1e30

# kernel launches since the last reset, per kernel (plain-version calls
# are not counted); the *_mma counts: the bf16 launches among them, which
# ran on the tensor cores
launches: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_mma": 0,
                            "flash_dq": 0, "flash_dq_mma": 0,
                            "flash_dkv": 0, "flash_dkv_mma": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448  # shared memory one H100 block may opt into
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def check_gqa_shapes(q, k, v) -> int:
    """Validate [B,S,H,D] q against [B,S,KV,D] k/v; returns the group size
    H // KV (1 == plain MHA)."""
    h, kv_heads = q.shape[2], k.shape[2]
    if h % kv_heads:
        raise ValueError(f"q heads {h} not divisible by kv heads {kv_heads}")
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} shapes "
                         f"must match")
    return h // kv_heads


# ---------------------------------------------------------- plain versions
def _visible(s: int, causal: bool, window: Optional[int],
             device) -> Optional[torch.Tensor]:
    """[S, S] bool: query i may attend key j (None: every pair)."""
    if not causal:
        return None
    q_ids = torch.arange(s, device=device)[:, None]
    k_ids = torch.arange(s, device=device)[None, :]
    mask = q_ids >= k_ids
    if window is not None:
        mask &= k_ids > q_ids - window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: Optional[int]):
    """f32 scores [B, KV, G, S, S] (q.kᵀ then * scale, masked to NEG_INF)
    and the mask.  Query head j*G + g reads kv head j."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d).float()
    sc = torch.einsum("bqjgd,bkjd->bjgqk", qg, k.float()) * (1.0 / math.sqrt(d))
    mask = _visible(s, causal, window, q.device)
    if mask is not None:
        sc = torch.where(mask, sc, NEG_INF)
    return sc, mask


def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B, H, S] statistics as [B, KV, G, S, 1]."""
    b, h, s = x.shape
    return x.reshape(b, kvh, h // kvh, s)[..., None]


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2f's arithmetic over the whole sequence at once: returns out
    [B, S, H, D] in q's dtype and lse [B, H, S] f32.  l sums the unrounded
    p; p is rounded to V's dtype for the PV product; l == 0 -> 1."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    sc, mask = _scores(q, k, causal, window)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    pv = torch.einsum("bjgqk,bkjd->bjgqd", p.to(v.dtype).float(), v.float())
    out = (pv / l_safe).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    lse = (m + torch.log(l_safe)).reshape(b, h, s)
    return out.to(q.dtype), lse


def _bwd_terms(q, k, v, do, lse, delta, causal, window):
    """p (f32) and dS rounded to K's dtype, both [B, KV, G, S, S]."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    sc, mask = _scores(q, k, causal, window)
    p = torch.exp(sc - _grouped(lse, kvh))
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dog = do.reshape(b, s, kvh, h // kvh, d).float()
    dp = torch.einsum("bqjgd,bkjd->bjgqk", dog, v.float())
    ds = (p * (dp - _grouped(delta, kvh))).to(k.dtype).float()
    return p, ds, dog


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool,
                   window: Optional[int] = None) -> torch.Tensor:
    """K2q's arithmetic: dq = scale * (dS K), in q's dtype."""
    b, s, h, d = q.shape
    _, ds, _ = _bwd_terms(q, k, v, do, lse, delta, causal, window)
    dq = (1.0 / math.sqrt(d)) * torch.einsum("bjgqk,bkjd->bqjgd", ds,
                                             k.float())
    return dq.reshape(b, s, h, d).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2kv's arithmetic: dk = scale * (dSᵀ Q) and dv = round(p)ᵀ dO, each
    summed over the query heads of the kv head's group, in k's and v's
    dtypes."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    p, ds, dog = _bwd_terms(q, k, v, do, lse, delta, causal, window)
    qg = q.reshape(b, s, kvh, h // kvh, d).float()
    dk = (1.0 / math.sqrt(d)) * torch.einsum("bjgqk,bqjgd->bkjd", ds, qg)
    dv = torch.einsum("bjgqk,bqjgd->bkjd", p.to(do.dtype).float(), dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, do, lse, delta, causal: bool,
                    window: Optional[int] = None):
    """(dq, dk, dv): the two backward plain versions."""
    dq = flash_dq_plain(q, k, v, do, lse, delta, causal, window)
    return (dq,) + flash_dkv_plain(q, k, v, do, lse, delta, causal, window)


# ------------------------------------------------------------------ kernels
def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kernels.load("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i32] * 5 + [i32, i32, f32, i32, ptr]
        lib.flash_fwd_launch.argtypes = [ptr] * 6 + shape
        lib.flash_dq_launch.argtypes = [ptr] * 8 + shape
        lib.flash_dkv_launch.argtypes = [ptr] * 9 + shape
        for fn in (lib.flash_fwd_launch, lib.flash_dq_launch,
                   lib.flash_dkv_launch):
            fn.restype = i32
        lib.flash_max_head_dim.argtypes = []
        lib.flash_max_head_dim.restype = i32
        lib.flash_smem_bytes.argtypes = [i32, i32]
        lib.flash_smem_bytes.restype = ctypes.c_longlong
        lib.flash_error_string.argtypes = [i32]
        lib.flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(which: int, tensors: Dict[str, torch.Tensor],
           causal: bool, window: Optional[int]) -> ctypes.CDLL:
    """Raise on what the kernels do not take; returns the library."""
    q, k, v = tensors["q"], tensors["k"], tensors["v"]
    dev = q.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if name in ("lse", "delta"):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous float32 "
                                 f"[B, H, S] tensor")
            continue
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} must match q "
                            f"({q.dtype})")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [B, S, heads, D] with unit "
                             f"stride on D, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernels take float32 or "
                        f"bfloat16")
    b, s, h, d = q.shape
    check_gqa_shapes(q, k, v)
    if k.shape[:2] != (b, s) or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on B, S or D")
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window {window} needs causal=True and >= 1")
    lib = _load()
    if d > lib.flash_max_head_dim():
        raise ValueError(f"head_dim {d} > the kernels' "
                         f"{lib.flash_max_head_dim()}")
    if lib.flash_smem_bytes(which, d) > _MAX_SMEM:
        raise ValueError(f"head_dim {d} needs more shared memory than one "
                         f"block can have")
    if b > 65535 or h > 65535:
        raise ValueError(f"B={b} and H={h} must be <= 65535 (grid dims)")
    return lib


def _strides(*ts: torch.Tensor):
    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(err: int, lib: ctypes.CDLL, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.flash_error_string(err).decode()} ({err})")


def _shape_args(q, k, causal, window):
    b, s, h, d = q.shape
    return (b, s, h, k.shape[2], d, int(causal),
            -1 if window is None else int(window), 1.0 / math.sqrt(d),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)


def _launch_fwd(q, k, v, causal, window):
    lib = _check(0, dict(q=q, k=k, v=v), causal, window)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _strides(q, k, v), *_shape_args(q, k, causal, window))
    _raise_on(err, lib, "flash_fwd")
    launches["flash_fwd"] += 1
    if q.dtype == torch.bfloat16:
        launches["flash_fwd_mma"] += 1
    return out, lse


def _launch_dq(q, k, v, do, lse, delta, causal, window):
    lib = _check(1, dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta),
                 causal, window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = lib.flash_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do), *_shape_args(q, k, causal, window))
    _raise_on(err, lib, "flash_dq")
    launches["flash_dq"] += 1
    if q.dtype == torch.bfloat16:
        launches["flash_dq_mma"] += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, window):
    lib = _check(2, dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta),
                 causal, window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = lib.flash_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do), *_shape_args(q, k, causal, window))
    _raise_on(err, lib, "flash_dkv")
    launches["flash_dkv"] += 1
    if q.dtype == torch.bfloat16:
        launches["flash_dkv_mma"] += 1
    return dk, dv


def _on(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, got "
                         f"{x.device}")
    return x.device.type


def flash_fwd(q, k, v, causal: bool, window: Optional[int] = None):
    """K2f: (out [B, S, H, D], lse [B, H, S] f32).  CUDA tensors launch the
    kernel (or raise); CPU tensors run flash_fwd_plain."""
    if _on(q) == "cpu":
        return flash_fwd_plain(q, k, v, causal, window)
    return _launch_fwd(q, k, v, causal, window)


def flash_dq(q, k, v, do, lse, delta, causal: bool,
             window: Optional[int] = None) -> torch.Tensor:
    """K2q: dq [B, S, H, D].  lse and delta are [B, H, S] f32."""
    if _on(q) == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal, window)
    return _launch_dq(q, k, v, do, lse, delta, causal, window)


def flash_dkv(q, k, v, do, lse, delta, causal: bool,
              window: Optional[int] = None):
    """K2kv: (dk, dv), each [B, S, KV, D]."""
    if _on(q) == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal, window)
    return _launch_dkv(q, k, v, do, lse, delta, causal, window)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        # delta from the rounded output, in f32, as [B, H, S]
        delta = (out.float() * do.float()).sum(dim=-1).transpose(1, 2)
        delta = delta.contiguous()
        args = (q, k, v, do, lse, delta, ctx.causal, ctx.window)
        dq = flash_dq(*args)
        dk, dv = flash_dkv(*args)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """Fused attention for [B, S, H, D] q and [B, S, KV, D] k/v,
    differentiable.  `window` (requires causal): each query sees itself
    plus the window-1 previous positions; tiles outside the band are
    skipped in the forward and both backward kernels."""
    check_gqa_shapes(q, k, v)
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    return _Flash.apply(q, k, v, causal, window)


# models/llama.py GqaAttention checks this to skip its kv-head broadcast
flash_attention.supports_gqa = True
