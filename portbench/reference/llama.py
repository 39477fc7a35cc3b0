"""The plain reference of a Llama-family decoder (Mistral, Mixtral).

Plain PyTorch in float32, written from the published description: token
embedding, RMSNorm before attention and before the feed-forward,
rotary embeddings on the split halves of each head (x[i] with
x[i + D/2]), grouped-query causal attention (optionally inside a sliding
window of W positions: a query at p sees keys in (p - W, p]), SwiGLU
(silu(x W_gate) * x W_up, then W_down), or a sparse layer of SwiGLU
experts behind a float32 router with top-k choices whose gates are
renormalised over the chosen experts; a final RMSNorm and the head
(the embedding's transpose when tied).

It imports nothing of the program.  It reads the weights in the
program's layouts by name ([E, H, D] wq, [E, 2, KV, D] wkv, [H, D, E]
out, [E, 2, F] dense wi with gate then up, [X, E, 2F] expert wi with
the gate half first, [X, F, E] expert wo), and int8 weights as
(payload, scale) pairs, which it dequantizes itself in float32.

`mm` is the matrix product every projection and attention product goes
through: the float32 product, or a lower-precision one (the controls).
Float32 products here run with TF32 off.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Dims:
    """The sizes the reference reads from a configuration file."""

    def __init__(self, cfg: dict):
        self.vocab = int(cfg["vocab_size"])
        self.d = int(cfg["hidden_size"])
        self.h = int(cfg["num_attention_heads"])
        self.kv = int(cfg["num_key_value_heads"])
        self.hd = self.d // self.h
        self.f = int(cfg["intermediate_size"])
        self.layers = int(cfg["num_hidden_layers"])
        self.experts = int(cfg.get("num_local_experts") or 0)
        self.top_k = int(cfg.get("num_experts_per_tok") or 0)
        self.window = cfg.get("sliding_window")
        self.tied = bool(cfg["tie_word_embeddings"])
        self.theta = float(cfg["rope_theta"])
        self.eps = float(cfg["rms_norm_eps"])


def plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def weight(w, dtype=torch.float32) -> torch.Tensor:
    """A leaf as a float tensor: an int8 (payload, scale) pair is
    payload * scale in float32."""
    if isinstance(w, tuple):
        q, scale = w
        return q.to(torch.float32) * scale.to(torch.float32)
    return w.to(dtype)


# ------------------------------------------------------------------ pieces
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(positions: torch.Tensor, head_dim: int, theta: float):
    """cos, sin [S, 1, D/2] of the angles p / theta^(2i/D), in float64
    then rounded to float32."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float64,
                     device=positions.device)
    inv = theta ** (-i / head_dim)
    ang = positions.to(torch.float64)[:, None] * inv[None, :]
    return (torch.cos(ang).float()[:, None, :],
            torch.sin(ang).float()[:, None, :])


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [S, H, D]: (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1)


def _band(qs: int, qe: int, ks: int, ke: int, window, device):
    q = torch.arange(qs, qe, device=device)[:, None]
    k = torch.arange(ks, ke, device=device)[None, :]
    m = k <= q
    if window is not None:
        m &= k > q - window
    return m


class BlockedAttention(torch.autograd.Function):
    """Causal grouped-query attention over [S, H, D] queries and
    [S, KV, D] keys and values, computed in blocks of query rows so that
    no [H, S, S] score tensor is held; the backward recomputes each
    block's probabilities from the saved log-sum-exp.  Each product goes
    through `mm`."""

    @staticmethod
    def forward(ctx, q, k, v, window, block, mm):
        s, h, d = q.shape
        kvh = k.shape[1]
        g = h // kvh
        scale = 1.0 / math.sqrt(d)
        qg = q.view(s, kvh, g, d).permute(1, 2, 0, 3)      # [KV, G, S, D]
        kt = k.permute(1, 2, 0)                             # [KV, D, S]
        vt = v.permute(1, 0, 2)                             # [KV, S, D]
        out = torch.empty_like(qg)
        lse = torch.empty(kvh, g, s, device=q.device, dtype=torch.float32)
        for qs in range(0, s, block):
            qe = min(s, qs + block)
            ks = 0 if window is None else max(0, qs - window + 1)
            sc = mm(qg[:, :, qs:qe], kt[:, None, :, ks:qe]) * scale
            sc = sc.masked_fill(~_band(qs, qe, ks, qe, window, q.device),
                                -math.inf)
            l = torch.logsumexp(sc, dim=-1)
            p = torch.exp(sc - l[..., None])
            out[:, :, qs:qe] = mm(p, vt[:, None, ks:qe])
            lse[:, :, qs:qe] = l
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.block, ctx.mm = window, block, mm
        return out.permute(2, 0, 1, 3).reshape(s, h, d)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        window, block, mm = ctx.window, ctx.block, ctx.mm
        s, h, d = q.shape
        kvh = k.shape[1]
        g = h // kvh
        scale = 1.0 / math.sqrt(d)
        qg = q.view(s, kvh, g, d).permute(1, 2, 0, 3)
        dog = dout.reshape(s, kvh, g, d).permute(1, 2, 0, 3)
        kt = k.permute(1, 2, 0)
        vt = v.permute(1, 0, 2)
        delta = (dog * out).sum(-1)                         # [KV, G, S]
        dq = torch.zeros_like(qg)
        dk = torch.zeros(kvh, s, d, device=q.device, dtype=torch.float32)
        dv = torch.zeros_like(dk)
        for qs in range(0, s, block):
            qe = min(s, qs + block)
            ks = 0 if window is None else max(0, qs - window + 1)
            sc = mm(qg[:, :, qs:qe], kt[:, None, :, ks:qe]) * scale
            sc = sc.masked_fill(~_band(qs, qe, ks, qe, window, q.device),
                                -math.inf)
            p = torch.exp(sc - lse[:, :, qs:qe, None])       # [KV,G,b,k]
            do = dog[:, :, qs:qe]
            dv[:, ks:qe] += mm(p.transpose(-1, -2), do).sum(1)
            dp = mm(do, vt[:, None, ks:qe].transpose(-1, -2))
            ds = p * (dp - delta[:, :, qs:qe, None]) * scale
            dq[:, :, qs:qe] = mm(ds, k.permute(1, 0, 2)[:, None, ks:qe])
            dk[:, ks:qe] += mm(ds.transpose(-1, -2), qg[:, :, qs:qe]).sum(1)
        dq = dq.permute(2, 0, 1, 3).reshape(s, h, d)
        return (dq, dk.permute(1, 0, 2), dv.permute(1, 0, 2), None, None,
                None)


def attention(x, p: Dict, prefix: str, dims: Dims, cos, sin, mm,
              block: int = 1024) -> torch.Tensor:
    """One attention sub-layer over one sequence x [S, E]."""
    s = x.shape[0]
    wq = weight(p[prefix + "attn.wq"])
    wkv = weight(p[prefix + "attn.wkv"])
    wo = weight(p[prefix + "attn.out"])
    q = mm(x, wq.reshape(dims.d, -1)).view(s, dims.h, dims.hd)
    kv = mm(x, wkv.reshape(dims.d, -1)).view(s, 2, dims.kv, dims.hd)
    q = rotate(q, cos, sin)
    k = rotate(kv[:, 0], cos, sin)
    v = kv[:, 1]
    o = BlockedAttention.apply(q, k, v, dims.window, block, mm)
    return mm(o.reshape(s, -1), wo.reshape(-1, dims.d))


def swiglu(x, wi, wo, mm) -> torch.Tensor:
    """Dense SwiGLU with wi [E, 2, F] (gate, up) and wo [F, E]."""
    e, _, f = wi.shape
    h = mm(x, wi.reshape(e, 2 * f)).view(-1, 2, f)
    return mm(F.silu(h[:, 0]) * h[:, 1], wo)


def moe(x, p: Dict, prefix: str, dims: Dims, mm) -> torch.Tensor:
    """Top-k routed SwiGLU experts: router logits x @ router in float32,
    softmax, the k largest probabilities renormalised to sum to one; each
    expert runs over the tokens that chose it."""
    router = weight(p[prefix + "moe.router"])
    probs = torch.softmax(x @ router, dim=-1)
    top_p, top_i = torch.topk(probs, dims.top_k, dim=-1)
    gates = top_p / top_p.sum(-1, keepdim=True)
    wi_all, wo_all = p[prefix + "moe.wi"], p[prefix + "moe.wo"]
    out = torch.zeros_like(x)
    for e in range(dims.experts):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        wi = weight(_expert(wi_all, e))
        wo = weight(_expert(wo_all, e))
        h = mm(x[rows], wi)
        gate, up = h.chunk(2, dim=-1)
        y = mm(F.silu(gate) * up, wo)
        out.index_add_(0, rows, y * gates[rows, slot][:, None])
    return out


def _expert(w, e: int):
    if isinstance(w, tuple):
        return (w[0][e], w[1][e])
    return w[e]


def block_forward(x, p: Dict, i: int, dims: Dims, cos, sin, mm):
    pre = f"blocks.{i}."
    x = x + attention(rms_norm(x, weight(p[pre + "ln1.scale"]), dims.eps),
                      p, pre, dims, cos, sin, mm)
    h = rms_norm(x, weight(p[pre + "ln2.scale"]), dims.eps)
    if dims.experts:
        return x + moe(h, p, pre, dims, mm)
    return x + swiglu(h, weight(p[pre + "mlp.wi"]), weight(p[pre + "mlp.wo"]),
                      mm)


def embed(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    w = p["embed"]
    if isinstance(w, tuple):
        return w[0][tokens].to(torch.float32) * w[1][tokens].to(torch.float32)
    return w[tokens].to(torch.float32)


def head(p: Dict, dims: Dims) -> torch.Tensor:
    """[E, V] float32."""
    if dims.tied:
        return weight(p["embed"]).t()
    return weight(p["lm_head"])


# ---------------------------------------------------------------- training
def lm_loss(p: Dict, tokens: torch.Tensor, dims: Dims,
            mm: Callable = plain_mm, remat: bool = True,
            rows: Optional[slice] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of one [S] sequence (the head in
    float32 over the final hidden states of positions 0..S-2 against
    tokens 1..S-1); each block recomputed in the backward when remat.
    rows: the positions whose loss is averaged (default every one)."""
    s = tokens.shape[0]
    cos, sin = rope(torch.arange(s, device=tokens.device), dims.hd,
                    dims.theta)
    x = embed(p, tokens)
    for i in range(dims.layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                block_forward, x, p, i, dims, cos, sin, mm,
                use_reentrant=False)
        else:
            x = block_forward(x, p, i, dims, cos, sin, mm)
    x = rms_norm(x, weight(p["ln_f.scale"]), dims.eps)
    logits = mm(x[:-1], head(p, dims))
    labels = tokens[1:]
    if rows is not None:
        logits, labels = logits[rows], labels[rows]
    return F.cross_entropy(logits, labels)


# ----------------------------------------------------------------- serving
def sequence_logits(p: Dict, seqs: Sequence[torch.Tensor], starts: List[int],
                    dims: Dims, layer_params: Callable[[int], Dict],
                    mm: Callable = plain_mm) -> List[torch.Tensor]:
    """Float32 logits [len(seq) - start, V] of positions start.. of each
    sequence, the whole model run over each sequence from position 0, one
    layer at a time for every sequence (`layer_params(i)` gives layer i's
    leaves, so a caller can dequantize one layer at a time)."""
    xs = [embed(p, t) for t in seqs]
    ropes = [rope(torch.arange(t.shape[0], device=t.device), dims.hd,
                  dims.theta) for t in seqs]
    for i in range(dims.layers):
        lp = layer_params(i)
        xs = [block_forward(x, lp, i, dims, c, s, mm)
              for x, (c, s) in zip(xs, ropes)]
        del lp
    out = []
    w = head(p, dims)
    for x, st in zip(xs, starts):
        x = rms_norm(x[st:], weight(p["ln_f.scale"]), dims.eps)
        out.append(mm(x, w))
    return out
