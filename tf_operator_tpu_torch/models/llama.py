"""LLaMA-class decoder (RoPE + GQA + SwiGLU + RMSNorm) in PyTorch, paged.

The port of tf_operator_tpu/models/llama.py's serving half: the config and
its factories, rotary embeddings, RMSNorm, the fused SwiGLU MLP, the dense
ring-visibility attention (`cached_attention`, the plain read the paged
kernel is held against), and the decoder in decode mode over a paged KV
block pool.  Parameter layouts are the flax ones ([E, H, D] wq, fused
[E, 2, KV, D] wkv, [H, D, E] out, fused [E, 2, F] wi), so
models/bridge.params_from_jax is a rename.

Numerics follow the JAX package: weights stored in cfg.dtype (what
flax's DenseGeneral(dtype=...) casts to before every product), RoPE and
RMSNorm in f32, attention scores and softmax in f32, and the lm_head in
f32 on an upcast hidden state.  The large projections are plain
torch.matmul, as the JAX package left them to XLA; every paged KV read
goes through models/paged_attention.paged_attention.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models import paged_attention as _pa
from tf_operator_tpu_torch.models import paging


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
    # Mistral-style sliding window; the port does not serve it yet
    # (ROADMAP: sliding-window paged tables) and Llama refuses it
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
    (only frozen lanes produce one; their tokens are discarded)."""
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


# ------------------------------------------------------------------ modules
def _weight(*shape: int, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


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
    wi [E, 2, F]."""

    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.wi = _weight(cfg.d_model, 2, cfg.d_ff, dtype=cfg.dtype)
        self.wo = _weight(cfg.d_ff, cfg.d_model, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e, _, f = self.wi.shape
        h = (x @ self.wi.view(e, 2 * f)).unflatten(-1, (2, f))
        return (F.silu(h[..., 0, :]) * h[..., 1, :]) @ self.wo


class GqaAttention(nn.Module):
    """Grouped-query attention with rotary embeddings over a paged KV
    pool: project q and the fused k/v, rotate, write k/v into the lane's
    blocks, then read every visible position through paged_attention
    (the CUDA kernel on the card, its plain version on the CPU)."""

    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.cfg = cfg
        e, h, kv, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _weight(e, h, d, dtype=cfg.dtype)
        self.wkv = _weight(e, 2, kv, d, dtype=cfg.dtype)
        self.out = _weight(h, d, e, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cache: Tuple[torch.Tensor, torch.Tensor], pos: torch.Tensor,
                block_table: torch.Tensor,
                write_index: Tuple[torch.Tensor, torch.Tensor]
                ) -> torch.Tensor:
        cfg = self.cfg
        b, l, e = x.shape
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = (x @ self.wq.view(e, h * d)).view(b, l, h, d)
        kvp = (x @ self.wkv.view(e, 2 * kv * d)).view(b, l, 2, kv, d)
        q = _rotate(q, cos, sin)
        k = _rotate(kvp[:, :, 0], cos, sin)
        k_pool, v_pool = cache
        paging.write_blocks(k_pool, k, write_index)
        paging.write_blocks(v_pool, kvp[:, :, 1], write_index)
        out = _pa.paged_attention(q, k_pool, v_pool, block_table, pos,
                                  window=cfg.sliding_window)
        return out.reshape(b, l, h * d) @ self.out.view(h * d, e)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        self.attn = GqaAttention(cfg)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        self.mlp = SwiGlu(cfg)

    def forward(self, x, cos, sin, cache, pos, block_table, write_index):
        x = x + self.attn(self.ln1(x), cos, sin, cache, pos, block_table,
                          write_index)
        return x + self.mlp(self.ln2(x))


class Llama(nn.Module):
    """Causal decoder LM in decode mode over a paged KV pool.

    forward(tokens [B, L], cache, cache_pos, block_table) writes the L
    new positions' K/V into the pools of `cache` (per-layer (k, v) from
    paging.init_block_pool; updated IN PLACE) through block_table [B, T]
    and returns f32 logits [B, L, V] — or, with return_hidden=True, the
    final-norm hidden states, whose `logits()` the caller takes where it
    needs them (a prefill segment needs only its last position's).
    cache_pos is the position of tokens[:, 0]: an int for every row, or
    a [B] tensor giving each lane its own position."""

    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        if cfg.sliding_window is not None:
            raise NotImplementedError(
                "sliding_window models are not ported yet (ROADMAP Queue "
                "1: sliding-window paged tables)")
        self.cfg = cfg
        self.embed = _weight(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype)
        self.blocks = nn.ModuleList(LlamaBlock(cfg)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        # f32 like flax's Dense(dtype=f32) lm_head on the upcast x
        self.lm_head = _weight(cfg.d_model, cfg.vocab_size,
                               dtype=torch.float32)
        self._rope: Optional[torch.Tensor] = None

    @classmethod
    def from_params(cls, cfg: LlamaConfig, params: dict,
                    device: Union[str, torch.device, None] = None
                    ) -> "Llama":
        """Build the model around `params` (models/bridge: a state dict
        in the port's layouts) on `device` (default "cuda").  Tensors
        already on the device in the right dtype are used as they are,
        not copied."""
        dev = resolve_device(device)
        with torch.device("meta"):
            model = cls(cfg)
        want = {k: v.dtype for k, v in model.state_dict().items()}
        missing = set(want) - set(params)
        extra = set(params) - set(want)
        if missing or extra:
            raise ValueError(
                f"params do not match the config: missing "
                f"{sorted(missing)[:5]}, unexpected {sorted(extra)[:5]}")
        model.load_state_dict(
            {k: params[k].to(device=dev, dtype=want[k]) for k in want},
            assign=True)
        for p in model.parameters():
            p.requires_grad_(False)
        return model.eval()

    def rope(self) -> torch.Tensor:
        """The [max_len, D/2] angle table on the parameters' device."""
        dev = self.embed.device
        if self._rope is None or self._rope.device != dev:
            cfg = self.cfg
            self._rope = rope_table(cfg.max_len, cfg.head_dim,
                                    cfg.rope_theta, cfg.rope_scaling).to(dev)
        return self._rope

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return h.float() @ self.lm_head

    def forward(self, tokens: torch.Tensor,
                cache: List[Tuple[torch.Tensor, torch.Tensor]],
                cache_pos: Union[int, torch.Tensor],
                block_table: torch.Tensor,
                return_hidden: bool = False) -> torch.Tensor:
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
            pos = torch.full((b,), int(cache_pos), dtype=torch.int32,
                             device=dev)
        cos, sin = _rope_cos_sin(angles)
        # every layer writes the same positions through the same table
        write_index = paging.block_write_index(pos, block_table, l,
                                               cache[0][0].shape[1])
        x = F.embedding(tokens.to(torch.long), self.embed)
        for blk, layer_cache in zip(self.blocks, cache):
            x = blk(x, cos, sin, layer_cache, pos, block_table, write_index)
        x = self.ln_f(x)
        return x if return_hidden else self.logits(x)


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
