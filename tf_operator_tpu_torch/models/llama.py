"""LLaMA-class decoder (RoPE + GQA + SwiGLU + RMSNorm) in PyTorch.

The port of tf_operator_tpu/models/llama.py: the config and its
factories, rotary embeddings, RMSNorm, the fused SwiGLU MLP, the dense
ring-visibility attention (`cached_attention`: the dense cache's read,
and the plain read the paged kernel is held against), and the decoder in
three modes:

  - decode over a paged KV block pool (serving): every KV read goes
    through models/paged_attention.paged_attention;
  - decode over dense per-row ring caches [B, C, KV, D] (`init_cache`,
    written by `_cache_write`, read by `cached_attention`): the JAX
    package's default inference layout, which `generate` decodes with;
  - full sequence (training): causal attention through cfg.attention_fn
    (ops/flash_attention.flash_attention, or the einsum reference when
    None), optional recompute of each block in the backward pass
    (cfg.remat, torch.utils.checkpoint), and tied or untied logits.

Parameter layouts are the flax ones ([E, H, D] wq, fused [E, 2, KV, D]
wkv, [H, D, E] out, fused [E, 2, F] wi), so models/bridge.params_from_jax
is a rename.  Numerics follow the JAX package: every projection runs in
cfg.dtype (flax's DenseGeneral(dtype=...) casts its kernel to that before
the product, whether the parameter is stored in cfg.dtype for serving or
kept as an f32 master for training), RoPE and RMSNorm in f32, attention
scores and softmax in f32, the untied lm_head in f32 on an upcast hidden
state and the tied head (flax's Embed.attend) in cfg.dtype.  The large
projections are plain torch.matmul, as the JAX package left them to XLA.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models import paged_attention as _pa
from tf_operator_tpu_torch.models import paging
from tf_operator_tpu_torch.models import quant
from tf_operator_tpu_torch.models.quant import QTensor, quantize_tensor
from tf_operator_tpu_torch.models.transformer import dot_product_attention


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1-style frequency-dependent RoPE scaling ("llama3" rope
    type): high-frequency components keep their rotation, wavelengths
    past the original context are slowed by `factor`, and a smooth band
    interpolates between the two."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_len: int = 8192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_heads: int = 32
    n_kv_heads: int = 8
    n_layers: int = 32
    d_ff: int = 11008
    max_len: int = 2048
    rope_theta: float = 10000.0
    # None = plain RoPE; a RopeScaling = llama-3.1 context extension
    rope_scaling: Optional[RopeScaling] = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    # None -> the einsum reference (models/transformer.dot_product_attention);
    # or ops/flash_attention.flash_attention — called with post-RoPE
    # (q, k, v, causal=True) on the full-sequence path
    attention_fn: Optional[Callable] = None
    remat: bool = False  # recompute each block in the backward pass
    # Mistral-style sliding window: passed as window= to attention_fn on
    # the full-sequence path; the paged path writes through modular
    # (ring) block tables and passes it to paged_attention
    sliding_window: Optional[int] = None

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads "
                f"{self.n_heads}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by "
                f"n_kv_heads {self.n_kv_heads}")
        if self.head_dim % 2:
            raise ValueError(f"head_dim {self.head_dim} must be even for RoPE")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def _config(base: dict, kw: dict) -> LlamaConfig:
    base.update(kw)
    return LlamaConfig(**base)


def llama3_8b(**kw) -> LlamaConfig:
    """8B-class: GQA 4:1, larger vocab, theta=500k long-context base."""
    return _config(dict(
        vocab_size=128256, d_model=4096, n_heads=32, n_kv_heads=8,
        n_layers=32, d_ff=14336, max_len=8192, rope_theta=500000.0,
    ), kw)


def llama31_8b(**kw) -> LlamaConfig:
    """Llama-3.1-class: the 3.0 layout extended to 128k context via
    "llama3" rope scaling (factor 8 over the 8k-trained base)."""
    return _config(dict(
        vocab_size=128256, d_model=4096, n_heads=32, n_kv_heads=8,
        n_layers=32, d_ff=14336, max_len=131072, rope_theta=500000.0,
        rope_scaling=RopeScaling(factor=8.0, low_freq_factor=1.0,
                                 high_freq_factor=4.0,
                                 original_max_len=8192),
    ), kw)


def mistral_7b(**kw) -> LlamaConfig:
    """Mistral-class: 4:1 GQA + 4096-token sliding-window attention."""
    return _config(dict(
        vocab_size=32000, d_model=4096, n_heads=32, n_kv_heads=8,
        n_layers=32, d_ff=14336, max_len=8192, rope_theta=1000000.0,
        sliding_window=4096,
    ), kw)


def tiny(**kw) -> LlamaConfig:
    return _config(dict(
        vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2,
        n_layers=2, d_ff=128, max_len=64,
    ), kw)


# ------------------------------------------------------------------ rotary
def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _scale_inv_freq(inv_freq: torch.Tensor, sc: RopeScaling) -> torch.Tensor:
    """Llama-3.1 "llama3" rope scaling: components whose wavelength fits
    well inside the original context are untouched, wavelengths past it
    are slowed by `factor`, the band between interpolates.  Every step
    is an f32 tensor op in the JAX package's order (python scalars become
    f32 tensors first, so no step is rewritten as a reciprocal
    multiply)."""
    wavelen = _f32(2.0 * math.pi) / inv_freq
    low_wavelen = sc.original_max_len / sc.low_freq_factor
    high_wavelen = sc.original_max_len / sc.high_freq_factor
    smooth = ((_f32(sc.original_max_len) / wavelen - _f32(sc.low_freq_factor))
              / _f32(sc.high_freq_factor - sc.low_freq_factor))
    smoothed = ((1.0 - smooth) * inv_freq / _f32(sc.factor)
                + smooth * inv_freq)
    return torch.where(wavelen > _f32(low_wavelen), inv_freq / _f32(sc.factor),
                       torch.where(wavelen < _f32(high_wavelen), inv_freq,
                                   smoothed))


def rope_table(max_len: int, head_dim: int, theta: float,
               scaling: Optional[RopeScaling] = None) -> torch.Tensor:
    """[max_len, head_dim/2] f32 rotation angles pos / theta^(2i/d), with
    optional llama-3.1 frequency scaling (computed on the CPU)."""
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32) / _f32(head_dim)
    inv_freq = torch.pow(_f32(theta), exps)
    if scaling is not None:
        inv_freq = _scale_inv_freq(inv_freq, scaling)
    return (torch.arange(max_len, dtype=torch.float32)[:, None]
            * inv_freq[None, :])


def _rope_cos_sin(angles: torch.Tensor):
    """cos/sin of [S, D/2] or [B, S, D/2] angles, shaped to broadcast
    over [B, S, H, D/2]."""
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    if angles.dim() == 2:  # [S, D/2] -> broadcast over batch
        cos, sin = cos[None], sin[None]
    return cos, sin


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate [B, S, H, D] by per-position angles [S, D/2] or [B, S, D/2].
    Split-halves convention (x[i] pairs with x[i + D/2]); the rotation
    runs in f32 and returns in x's dtype."""
    cos, sin = _rope_cos_sin(angles)
    return _rotate(x, cos, sin)


# --------------------------------------------------------------- attention
def cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_pos: torch.Tensor,
                     cache_len: int, window: Optional[int] = None
                     ) -> torch.Tensor:
    """Decode-mode attention: q [B, L, H, D] (the L new positions, already
    rotated) against the compact cache [B, C, KV, D], grouped over the
    KV heads.  The cache is a ring: slot j's last-written global position
    is q_pos - ((q_pos - j) mod C) (floor modulo), which also covers a
    linear cache (unwritten slots resolve negative and mask out).
    q_pos is [L] or [B, L].  Scores and softmax in f32 (bf16 inputs are
    upcast, as preferred_element_type=f32 does); p is rounded to V's
    dtype before the PV product.  An all-masked row averages uniformly
    (only frozen lanes produce one; their tokens are discarded).  int8
    caches (QTensor) are dequantized to q's dtype first, as the JAX
    read does."""
    if isinstance(k_cache, QTensor):
        k_cache = k_cache.dequantize(q.dtype)
        v_cache = v_cache.dequantize(q.dtype)
    b, l, h, d = q.shape
    kv_heads = k_cache.shape[2]
    group = h // kv_heads
    qg = q.reshape(b, l, kv_heads, group, d).float()
    s = torch.einsum("blhgd,bchd->bhglc", qg, k_cache.float()) / math.sqrt(d)
    slot = torch.arange(cache_len, device=q.device)
    qp = q_pos.to(torch.long)[..., None]
    k_global = qp - torch.remainder(qp - slot, cache_len)  # [L|B,L, C]
    mask = k_global >= 0
    if window is not None:
        mask &= k_global > qp - window
    mask = (mask[None, None, None] if q_pos.dim() == 1
            else mask[:, None, None])                      # [B?,1,1,L,C]
    s = torch.where(mask, s, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhglc,bchd->blhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, l, h, d).to(q.dtype)


# ------------------------------------------------------------ dense writes
def _ring_write(buf: torch.Tensor, val: torch.Tensor, pos,
                wrap: bool = False) -> torch.Tensor:
    """Write val [B, L, ...] into the ring buf [B, C, ...] at global
    position pos (slot pos % C), in place; returns buf.

    A VECTOR pos [B] writes each row at its own position, modulo C per
    (row, step), so the seam is always handled and `wrap` does not
    matter; a write of more than C positions a row is refused (its slots
    would alias).  A scalar pos with wrap=True (and L > 1) scatters each
    position to its own slot modulo C, as JAX's flag does; no caller of
    the port sets it, since every write that may cross the seam (a
    speculative verify) carries a [B] pos.  Otherwise one contiguous
    write at slot pos % C, its start clamped to [0, C - L] as
    dynamic_update_slice clamps it (callers guarantee no wrap)."""
    c = buf.shape[1]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        rows = torch.arange(buf.shape[0], device=buf.device)
        l = val.shape[1]
        if l > c:
            raise ValueError(
                f"per-row write of L={l} positions into a C={c} ring "
                f"would alias slots within a row")
        slots = torch.remainder(
            pos.to(torch.long)[:, None]
            + torch.arange(l, device=buf.device), c)
        buf[rows[:, None], slots] = val.to(buf.dtype)
        return buf
    pos = int(pos)
    l = val.shape[1]
    if wrap and l > 1:
        idx = torch.remainder(pos + torch.arange(l, device=buf.device), c)
        buf[:, idx] = val.to(buf.dtype)
        return buf
    start = max(min(pos % c, c - l), 0)
    buf[:, start:start + l] = val.to(buf.dtype)
    return buf


def _cache_write(cache_buf, val: torch.Tensor, pos, wrap: bool = False):
    """One K or V dense cache write, in place; an int8 cache (QTensor)
    quantizes at the write, one scale per (position, head) over
    head_dim, and writes payload and scale through the same slots."""
    if isinstance(cache_buf, QTensor):
        qv = quantize_tensor(val, axes=(3,))   # [B, L, KV, D]: [B, L, KV, 1]
        _ring_write(cache_buf.q, qv.q, pos, wrap)
        _ring_write(cache_buf.scale, qv.scale, pos, wrap)
        return cache_buf
    return _ring_write(cache_buf, val, pos, wrap)


def _supports_gqa(attn) -> bool:
    """Does the backend consume compact [B,S,KV,D] kv natively?  Looks
    through functools.partial layers."""
    while attn is not None:
        if getattr(attn, "supports_gqa", False):
            return True
        attn = getattr(attn, "func", None)
    return False


# ------------------------------------------------------------------ modules
def _weight(*shape: int, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


def _dense(module: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Weight `name` of `module` in `dtype` for one product: the stored
    weight cast (flax's DenseGeneral(dtype=...)), or an int8 weight
    dequantized as QTensor.dequantize does, (f32 payload * scale) rounded
    to dtype.  The dequantized copy lives only for this use."""
    w = getattr(module, name)
    if w.dtype == torch.int8:
        return QTensor(w, getattr(module, name + "_scale")).dequantize(dtype)
    return w.to(dtype)


class RMSNorm(nn.Module):
    """flax nn.RMSNorm as the JAX package uses it: mean of x² in f32,
    x · (rsqrt(var + eps) · scale) in f32, cast to dtype.  The scale is
    an f32 parameter, as flax keeps it."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * (torch.rsqrt(var + self.eps) * self.scale)).to(self.dtype)


class SwiGlu(nn.Module):
    """silu(x W_gate) * (x W_up) -> W_down, gate and up fused as
    wi [E, 2, F].  Weights stored in `wdt`, used in cfg.dtype."""

    def __init__(self, cfg: LlamaConfig, wdt: torch.dtype) -> None:
        super().__init__()
        self.dtype = cfg.dtype
        self.wi = _weight(cfg.d_model, 2, cfg.d_ff, dtype=wdt)
        self.wo = _weight(cfg.d_ff, cfg.d_model, dtype=wdt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e, _, f = self.wi.shape
        h = (x @ _dense(self, "wi", self.dtype).view(e, 2 * f)).unflatten(
            -1, (2, f))
        return (F.silu(h[..., 0, :]) * h[..., 1, :]) @ _dense(self, "wo",
                                                              self.dtype)


class GqaAttention(nn.Module):
    """Grouped-query attention with rotary embeddings.

    Paged decode (cache = a layer's (k, v) block pools, block_table set):
    project q and the fused k/v, rotate, write k/v into the lanes'
    blocks, then read every visible position through paged_attention
    (the CUDA kernel on the card, its plain version on the CPU).  Dense
    decode (cache = a layer's (k, v) rings [B, C, KV, D], block_table
    None): write through _cache_write at pos (an int: one contiguous
    segment; or [B]: each row at its own position, modulo the ring) and
    read the whole ring through cached_attention with the position
    mask.  Full-sequence
    path (cache None): causal attention through cfg.attention_fn over
    compact kv when the backend takes GQA natively, else over kv
    repeated to H heads."""

    def __init__(self, cfg: LlamaConfig, wdt: torch.dtype) -> None:
        super().__init__()
        self.cfg = cfg
        e, h, kv, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _weight(e, h, d, dtype=wdt)
        self.wkv = _weight(e, 2, kv, d, dtype=wdt)
        self.out = _weight(h, d, e, dtype=wdt)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                pos: Optional[torch.Tensor] = None,
                block_table: Optional[torch.Tensor] = None,
                write_index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        b, l, e = x.shape
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = (x @ _dense(self, "wq", dt).view(e, h * d)).view(b, l, h, d)
        kvp = (x @ _dense(self, "wkv", dt).view(e, 2 * kv * d)).view(
            b, l, 2, kv, d)
        q = _rotate(q, cos, sin)
        k = _rotate(kvp[:, :, 0], cos, sin)
        v = kvp[:, :, 1]
        if cache is not None and block_table is not None:
            k_pool, v_pool = cache
            paging.write_blocks(k_pool, k, write_index)
            paging.write_blocks(v_pool, v, write_index)
            out = _pa.paged_attention(q, k_pool, v_pool, block_table, pos,
                                      window=cfg.sliding_window)
        elif cache is not None:
            k_cache, v_cache = cache
            _cache_write(k_cache, k, pos)
            _cache_write(v_cache, v, pos)
            steps = torch.arange(l, device=x.device)
            q_pos = (pos.to(torch.long)[:, None] + steps
                     if isinstance(pos, torch.Tensor) else pos + steps)
            out = cached_attention(q, k_cache, v_cache, q_pos,
                                   k_cache.shape[1],
                                   window=cfg.sliding_window)
        else:
            attn = cfg.attention_fn or dot_product_attention
            if cfg.q_per_kv > 1 and not _supports_gqa(attn):
                k = k.repeat_interleave(cfg.q_per_kv, dim=2)
                v = v.repeat_interleave(cfg.q_per_kv, dim=2)
            kw = {}
            if cfg.sliding_window is not None:
                kw["window"] = cfg.sliding_window
            out = attn(q, k, v, True, **kw)
        return out.reshape(b, l, h * d) @ _dense(self, "out", dt).view(h * d,
                                                                      e)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, wdt: torch.dtype) -> None:
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        self.attn = GqaAttention(cfg, wdt)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        self.mlp = SwiGlu(cfg, wdt)

    def forward(self, x, cos, sin, cache=None, pos=None, block_table=None,
                write_index=None):
        x = x + self.attn(self.ln1(x), cos, sin, cache, pos, block_table,
                          write_index)
        return x + self.mlp(self.ln2(x))


class Llama(nn.Module):
    """Causal decoder LM.

    Paged decode, forward(tokens [B, L], cache, cache_pos, block_table):
    writes the L new positions' K/V into the pools of `cache` (per-layer
    (k, v) from paging.init_block_pool; updated IN PLACE) through
    block_table [B, T], a modular ring of T blocks for a sliding-window
    config (position p in table slot (p // bs) % T).  cache_pos is the
    position of tokens[:, 0]: an int for every row, or a [B] tensor
    giving each lane its own position.

    Dense decode, the same call with block_table None: `cache` is
    init_cache's per-layer (k, v) rings [B, C, KV, D] (position p in
    slot p % C; updated IN PLACE), an int cache_pos writes one
    contiguous segment (callers size the ring so it never wraps) and a
    [B] cache_pos each row at its own position, crossing the seam
    where it must.

    Full-sequence mode, forward(tokens [B, S]) (cache None): positions
    0..S-1, or `positions` ([S] or [B, S] ids into the RoPE table).

    Both return f32 logits [B, L, V] — or, with return_hidden=True, the
    final-norm hidden states in cfg.dtype, whose `logits()` the caller
    takes where it needs them (a prefill segment needs only its last
    position's; the blocked cross-entropy fuses the tied head into the
    loss).

    Parameters are stored in cfg.dtype for serving (f32 for the norm
    scales and the untied lm_head), or all in f32 (`train=True`): the
    master weights training updates, cast to cfg.dtype at each use.  A
    model built from a quantized state dict (models/quant) serves int8
    weights: each keeps its int8 payload and an f32 `<name>_scale`
    buffer, and is dequantized to cfg.dtype at each use."""

    def __init__(self, cfg: LlamaConfig, train: bool = False) -> None:
        super().__init__()
        self.cfg = cfg
        wdt = torch.float32 if train else cfg.dtype
        self.embed = _weight(cfg.vocab_size, cfg.d_model, dtype=wdt)
        self.blocks = nn.ModuleList(LlamaBlock(cfg, wdt)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        if not cfg.tie_embeddings:
            # f32 like flax's Dense(dtype=f32) lm_head on the upcast x
            self.lm_head = _weight(cfg.d_model, cfg.vocab_size,
                                   dtype=torch.float32)
        self._rope: Optional[torch.Tensor] = None

    @classmethod
    def from_params(cls, cfg: LlamaConfig, params: dict,
                    device: Union[str, torch.device, None] = None,
                    train: bool = False) -> "Llama":
        """Build the model around `params` (models/bridge: a state dict
        in the port's layouts) on `device` (default "cuda").  Tensors
        already on the device in the right dtype are used as they are,
        not copied.  train=True keeps every parameter in f32 with
        requires_grad and puts the model in training mode.  QTensor
        values (quant.quantize_params) stay int8 on the device, beside
        their f32 scales; they serve only (train=False)."""
        dev = resolve_device(device)
        with torch.device("meta"):
            model = cls(cfg, train=train)
        want = model.state_dict()
        missing = set(want) - set(params)
        extra = set(params) - set(want)
        if missing or extra:
            raise ValueError(
                f"params do not match the config: missing "
                f"{sorted(missing)[:5]}, unexpected {sorted(extra)[:5]}")
        int8 = sorted(k for k, v in params.items() if isinstance(v, QTensor))
        if int8 and train:
            raise ValueError("int8 weights serve only: train=True takes "
                             "float params")
        for k in int8:
            qt = params[k]
            if (qt.q.dtype != torch.int8 or qt.shape != want[k].shape
                    or torch.broadcast_shapes(qt.scale.shape,
                                              qt.shape) != qt.shape):
                raise ValueError(
                    f"{k}: QTensor {qt.q.dtype} {tuple(qt.shape)} with "
                    f"scale {tuple(qt.scale.shape)} does not fit "
                    f"{tuple(want[k].shape)}")
            mod_name, _, attr = k.rpartition(".")
            mod = model.get_submodule(mod_name)
            setattr(mod, attr, nn.Parameter(qt.q.to(dev), requires_grad=False))
            mod.register_buffer(attr + "_scale",
                                qt.scale.to(device=dev, dtype=torch.float32))
        model.load_state_dict(
            {k: params[k].to(device=dev, dtype=want[k].dtype)
             for k in want if k not in int8},
            strict=not int8, assign=True)
        for p in model.parameters():
            p.requires_grad_(train)
        return model.train(train)

    def rope(self) -> torch.Tensor:
        """The [max_len, D/2] angle table on the parameters' device."""
        dev = self.embed.device
        if self._rope is None or self._rope.device != dev:
            cfg = self.cfg
            self._rope = rope_table(cfg.max_len, cfg.head_dim,
                                    cfg.rope_theta, cfg.rope_scaling).to(dev)
        return self._rope

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """f32 logits of final-norm hidden states."""
        dt = self.cfg.dtype
        if self.cfg.tie_embeddings:
            # flax Embed.attend promotes both operands to cfg.dtype
            return (h.to(dt) @ _dense(self, "embed", dt).t()).float()
        if self.lm_head.dtype == torch.int8:
            # the JAX dequantizer rounds the kernel to cfg.dtype, and
            # flax's f32 Dense then promotes it
            return h.float() @ _dense(self, "lm_head", dt).float()
        return h.float() @ self.lm_head

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # flax Embed(dtype=...) looks up in cfg.dtype: cast after the
        # gather, which gives the same bits as casting the table first;
        # an int8 table gathers its rows and their scales, then
        # dequantizes them
        idx = tokens.to(torch.long)
        if self.embed.dtype == torch.int8:
            return QTensor(self.embed[idx], self.embed_scale[idx]).dequantize(
                self.cfg.dtype)
        return F.embedding(idx, self.embed).to(self.cfg.dtype)

    def forward(self, tokens: torch.Tensor,
                cache: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
                cache_pos: Union[int, torch.Tensor, None] = None,
                block_table: Optional[torch.Tensor] = None,
                return_hidden: bool = False,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if cache is None:
            return self._forward_full(tokens, return_hidden, positions)
        cfg = self.cfg
        b, l = tokens.shape
        table = self.rope()
        dev = table.device
        steps = torch.arange(l, device=dev)
        if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
            # a lane that finished mid-block keeps stepping past its
            # budget, so its index can pass max_len: JAX's gather clamps
            # there and torch would fault, so clamp explicitly
            idx = torch.clamp(cache_pos.to(torch.long)[:, None] + steps,
                              0, cfg.max_len - 1)
            angles = table[idx]                                # [B, L, D/2]
            pos = cache_pos.to(torch.int32)
        else:
            # dynamic_slice_in_dim clamps its start to [0, max_len - L]
            start = min(max(int(cache_pos), 0), cfg.max_len - l)
            angles = table[start:start + l]                    # [L, D/2]
            pos = (torch.full((b,), int(cache_pos), dtype=torch.int32,
                              device=dev) if block_table is not None
                   else int(cache_pos))
        cos, sin = _rope_cos_sin(angles)
        write_index = None
        if block_table is not None:
            # every layer writes the same positions through the same
            # table; a sliding-window model's table is a ring (modular)
            write_index = paging.block_write_index(
                pos, block_table, l, cache[0][0].shape[1],
                modular=cfg.sliding_window is not None)
        x = self._embed(tokens)
        for blk, layer_cache in zip(self.blocks, cache):
            x = blk(x, cos, sin, layer_cache, pos, block_table, write_index)
        x = self.ln_f(x)
        return x if return_hidden else self.logits(x)

    def _forward_full(self, tokens: torch.Tensor, return_hidden: bool,
                      positions: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        table = self.rope()
        if positions is None:
            angles = table[: tokens.shape[1]]                    # [S, D/2]
        else:
            # JAX's gather wraps negative ids once and clamps the rest;
            # torch would fault, so do both explicitly
            idx = positions.to(device=table.device, dtype=torch.long)
            idx = torch.where(idx < 0, idx + cfg.max_len, idx)
            angles = table[idx.clamp(0, cfg.max_len - 1)]
        cos, sin = _rope_cos_sin(angles)
        x = self._embed(tokens)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = torch.utils.checkpoint.checkpoint(blk, x, cos, sin,
                                                      use_reentrant=False)
            else:
                x = blk(x, cos, sin)
        x = self.ln_f(x)
        return x if return_hidden else self.logits(x)


def params_flops_per_token(cfg: LlamaConfig) -> float:
    """~6 * matmul-params FLOPs/token for a train step (fwd+bwd): q, k, v
    and out projections, the SwiGLU MLP and the (tied or untied) vocab
    projection."""
    attn = (cfg.n_heads + 2 * cfg.n_kv_heads + cfg.n_heads) * (
        cfg.d_model * cfg.head_dim)
    mlp = 3 * cfg.d_model * cfg.d_ff
    p = cfg.vocab_size * cfg.d_model + cfg.n_layers * (attn + mlp)
    return 6.0 * p


# ------------------------------------------------------------- cache sizing
def chunk_align_cache(cache_len: int, prefill_chunk: int,
                      max_len: int) -> int:
    """Round a cache length up to a prefill_chunk multiple (streaming
    prefill requires chunk | cache so no segment write wraps), falling
    back to the largest multiple under max_len when rounding would cross
    the RoPE-table bound."""
    c = -(-cache_len // prefill_chunk) * prefill_chunk
    if c > max_len:
        c = max(prefill_chunk, max_len // prefill_chunk * prefill_chunk)
    return c


def check_prefill_chunk(prefill_chunk: int, cache_len: int, window,
                        streams_past_cache: bool, who: str = "") -> None:
    """Streaming-prefill validation: the chunk must divide the cache, and
    when the ring wraps it must not evict positions its own segment's
    queries still attend."""
    if cache_len % prefill_chunk:
        raise ValueError(
            f"prefill_chunk {prefill_chunk} must divide {who}cache_len "
            f"{cache_len} — a segment write must never wrap the ring")
    if (window is not None and streams_past_cache
            and prefill_chunk > cache_len - window):
        # a segment write evicts the ring's oldest prefill_chunk positions
        # before the segment's attention runs; if any of them is still
        # inside the first query's window, that query would attend the
        # aliased (future) K/V in their slots
        raise ValueError(
            f"prefill_chunk {prefill_chunk} > {who}cache_len {cache_len} "
            f"- sliding_window {window}: a segment's write would evict "
            f"positions its own queries still attend (grow the cache or "
            f"shrink the chunk)")


def auto_cache_len(cfg: LlamaConfig, prompt_len: int, total: int,
                   prefill_chunk: Optional[int] = None) -> int:
    """The default KV ring length: 128-multiples of the longest sequence
    (capped at max_len).  A sliding-window model gets a ring of
    O(window) positions instead: room for the whole prompt, whose
    prefill write must not wrap, or, with prefill_chunk, window plus one
    chunk's eviction band (the prompt streams through the ring), rounded
    up to a chunk multiple."""
    def bucket(n):
        return min(cfg.max_len, (n + 127) // 128 * 128)

    cache_len = bucket(total)
    if cfg.sliding_window is not None:
        if prefill_chunk is None:
            cache_len = min(cache_len,
                            max(bucket(cfg.sliding_window),
                                bucket(prompt_len)))
        else:
            cache_len = min(cache_len,
                            bucket(cfg.sliding_window + prefill_chunk))
    if prefill_chunk is not None:
        cache_len = chunk_align_cache(cache_len, prefill_chunk,
                                      cfg.max_len)
    return cache_len


# ---------------------------------------------------------------- sampling
def prefill_segments(prompt_len: int, prefill_chunk: Optional[int]):
    """The segment schedule for streaming prefill: [(start, end,
    is_last), ...].  prefill_chunk None = one whole-prompt segment."""
    if prefill_chunk is None or prefill_chunk >= prompt_len:
        return [(0, prompt_len, True)]
    starts = list(range(0, prompt_len, prefill_chunk))
    return [(i, min(i + prefill_chunk, prompt_len), i == starts[-1])
            for i in starts]


def _truncate_logits(logits: torch.Tensor, temperature: float,
                     top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """[..., V] logits -> temperature-scaled logits with truncated-out
    tokens masked to the dtype's min.  softmax of the result IS the
    sampling distribution.  top_k keeps the k highest logits, top_p
    (nucleus) the smallest set whose probability mass reaches p."""
    logits = logits / temperature
    neg = torch.finfo(logits.dtype).min
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, neg, logits)
    if top_p and 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep tokens while the mass BEFORE them is < p (the first token
        # is always kept); the cutoff logit is the smallest kept one
        before = torch.roll(cum, 1, dims=-1)
        before[..., 0] = 0.0
        keep = before < top_p
        cutoff = torch.where(keep, sorted_logits, math.inf).min(
            dim=-1, keepdim=True).values
        logits = torch.where(logits < cutoff, neg, logits)
    return logits


def check_truncation(vocab_size: int, top_k: int, top_p: float) -> None:
    """top_k/top_p range validation shared by the sampling entry points."""
    if top_k < 0 or top_k > vocab_size:
        raise ValueError(
            f"top_k must be in [0, vocab_size={vocab_size}], got {top_k}")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")


def _select_token(logits: torch.Tensor, temperature: float,
                  generator: Optional[torch.Generator] = None,
                  top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """[B, V] logits -> [B] token ids (int64).  temperature 0 -> greedy
    argmax (first maximum, as jnp.argmax); else a draw from
    _truncate_logits' distribution with `generator`, which must live on
    the logits' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    probs = torch.softmax(
        _truncate_logits(logits.float(), temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


# ---------------------------------------------------------------- generate
def init_cache(cfg: LlamaConfig, batch: int, cache_len: Optional[int] = None,
               dtype: Optional[torch.dtype] = None, kv_quant: bool = False,
               device: Union[str, torch.device, None] = None) -> list:
    """Per-layer (k, v) dense ring caches [B, C, KV, D], zeroed, on
    `device` (default "cuda"): compact kv heads, C = cache_len or
    cfg.max_len, refused above max_len (the RoPE table's rows).
    kv_quant=True makes each leaf a QTensor: int8 zeros and f32 ones
    scales [B, C, KV, 1], quantized at the write; it takes no dtype."""
    c = cache_len or cfg.max_len
    if c > cfg.max_len:
        raise ValueError(
            f"cache_len {c} exceeds cfg.max_len {cfg.max_len} (the RoPE "
            f"table bound — raise max_len/rope_theta for longer contexts)")
    dev = resolve_device(device)
    shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
    if kv_quant:
        if dtype is not None:
            raise ValueError(
                "kv_quant and dtype are mutually exclusive: the int8 "
                "cache's layout is fixed (int8 payload + f32 scales)")

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


def check_transform(name: str, transform, model: "Llama") -> None:
    """A weight transform (params_transform, draft_transform, ...) takes
    None or quant.make_dequantizer(cfg.dtype): the port's model applies
    its weights as they are stored (int8 ones dequantized to cfg.dtype
    at each use) and runs no other transform of them."""
    if (transform is not None
            and transform is not quant.make_dequantizer(model.cfg.dtype)):
        raise ValueError(
            f"{name} takes None or quant.make_dequantizer(cfg.dtype): the "
            f"port's model applies its weights as they are stored (int8 "
            f"ones dequantized to cfg.dtype at each use), and runs no "
            f"other transform of them")


def check_model_device(name: str, model: "Llama", dev: torch.device) -> None:
    """Refuse a model whose weights live elsewhere than `dev`."""
    p_dev = model.embed.device
    if p_dev.type != dev.type or (dev.index is not None
                                  and p_dev.index != dev.index):
        raise ValueError(f"{name} is on {p_dev}, the call asked for {dev}")


def chunk_fill(model: "Llama", cache, segment: torch.Tensor, pos,
               table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A prompt segment [B, S] into `cache` at position `pos` (dense rings,
    or block pools through `table`): returns the last position's f32
    logits [B, V] (the head runs on that position alone)."""
    h = model(segment, cache, pos, table, return_hidden=True)
    return model.logits(h[:, -1])


def chunk_write(model: "Llama", cache, segment: torch.Tensor, pos,
                table: Optional[torch.Tensor] = None) -> None:
    """A non-final prompt segment: feeds the cache only (no lm_head)."""
    model(segment, cache, pos, table, return_hidden=True)


def stream_prefill(model: "Llama", cache, prompt: torch.Tensor,
                   prefill_chunk: Optional[int]) -> torch.Tensor:
    """The prompt [B, P] into dense rings along prefill_segments:
    intermediate segments feed only the cache, the final one returns its
    last position's logits [B, V].  Callers validate the sizing
    (check_prefill_chunk) first."""
    *head, (start, end, _) = prefill_segments(prompt.shape[1],
                                              prefill_chunk)
    for s, e, _ in head:
        chunk_write(model, cache, prompt[:, s:e], s)
    return chunk_fill(model, cache, prompt[:, start:end], start)


def decode(model: "Llama", cache, first: torch.Tensor, pos0: int,
           length: int, select: Callable[[torch.Tensor], torch.Tensor],
           eos: int = -1) -> torch.Tensor:
    """`length` single-token steps over dense rings from `first` [B] at
    position pos0 (every row): [B, length] tokens.  eos >= 0: a row that
    emitted it (`first` included) keeps emitting it."""
    tok, pos = first, pos0
    done = first == eos
    out = []
    for _ in range(length):
        nxt = select(model(tok[:, None], cache, pos)[:, 0])
        if eos >= 0:
            nxt = torch.where(done, eos, nxt)
            done = done | (nxt == eos)
        out.append(nxt)
        tok, pos = nxt, pos + 1
    return torch.stack(out, dim=1)


def generate(model: "Llama", prompt, max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             eos_id: Optional[int] = None, cache_len: Optional[int] = None,
             params_transform=None, prefill_chunk: Optional[int] = None,
             cache_sharding=None, kv_quant: bool = False,
             device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """Autoregressive decoding over dense ring caches: the prompt [B, P]
    prefills in one pass (or in segments of prefill_chunk), then
    max_new_tokens - 1 single-token steps.  Returns [B, max_new_tokens]
    int64 tokens on `device` (default "cuda", where the model must
    live).

    temperature 0 -> greedy; else a draw from _truncate_logits'
    distribution (top_k, top_p) with `generator`, a torch.Generator on
    the device.  eos_id: a row that emits it keeps emitting it.
    cache_len: ring slots (default llama.auto_cache_len: 128-multiples of
    prompt + new, an O(window) ring for a sliding-window model), with
    JAX's refusals.  prefill_chunk: stream the prompt through the ring
    (a sliding-window model's long prompt through an O(window) ring); it
    must divide the ring.  kv_quant: int8 rings, quantized at the write.
    params_transform: None or quant.make_dequantizer(cfg.dtype), the
    dequantization a model built from int8 weights already applies.
    cache_sharding raises NotImplementedError (ROADMAP item 11)."""
    if cache_sharding is not None:
        raise NotImplementedError(
            "generate: cache_sharding is not ported yet (ROADMAP Queue 1, "
            "item 11: distributed)")
    cfg = model.cfg
    check_transform("params_transform", params_transform, model)
    dev = resolve_device(device)
    check_model_device("model", model, dev)
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(dev)
    b, prompt_len = prompt.shape
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    check_truncation(cfg.vocab_size, top_k, top_p)
    eos = -1 if eos_id is None else int(eos_id)
    if eos_id is not None and not 0 <= eos < cfg.vocab_size:
        raise ValueError(
            f"eos_id {eos_id} out of range for vocab_size {cfg.vocab_size}")
    if max_new_tokens == 0:
        return torch.zeros((b, 0), dtype=torch.long, device=dev)
    total = prompt_len + max_new_tokens
    if total > cfg.max_len:
        raise ValueError(
            f"prompt {prompt_len} + new {max_new_tokens} exceeds RoPE "
            f"table length max_len={cfg.max_len}")
    if prefill_chunk is not None and prefill_chunk >= prompt_len:
        # one segment holds the whole prompt: the unchunked path
        prefill_chunk = None
    if cache_len is None:
        cache_len = auto_cache_len(cfg, prompt_len, total, prefill_chunk)
    if cfg.sliding_window is None and total > cache_len:
        raise ValueError(
            f"prompt {prompt_len} + new {max_new_tokens} exceeds cache "
            f"length {cache_len}")
    if prefill_chunk is not None:
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        check_prefill_chunk(prefill_chunk, cache_len, cfg.sliding_window,
                            streams_past_cache=total > cache_len)
    elif prompt_len > cache_len:
        raise ValueError(
            f"prompt {prompt_len} exceeds cache length {cache_len} "
            f"(a single-pass prefill write must not wrap the ring; pass "
            f"prefill_chunk to stream a long prompt through a smaller "
            f"cache)")
    if (cfg.sliding_window is not None
            and cache_len < min(cfg.sliding_window, total)):
        raise ValueError(
            f"cache_len {cache_len} < sliding window "
            f"{min(cfg.sliding_window, total)} — visible positions would "
            f"be overwritten")
    cache = init_cache(cfg, b, cache_len, kv_quant=kv_quant, device=dev)
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")

    def select(logits: torch.Tensor) -> torch.Tensor:
        return _select_token(logits, temperature, generator, top_k, top_p)

    with torch.inference_mode():
        first = select(stream_prefill(model, cache, prompt, prefill_chunk))
        if max_new_tokens == 1:
            return first[:, None]
        rest = decode(model, cache, first, prompt_len, max_new_tokens - 1,
                      select, eos)
    return torch.cat([first[:, None], rest], dim=1)
