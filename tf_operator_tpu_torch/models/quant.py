"""Weight-only int8 quantization for inference, and the int8 KV layout.

The port of tf_operator_tpu/models/quant.py.  A `QTensor` is an int8
payload `q` and f32 scales `scale` broadcastable to it, w ≈ q * scale,
with symmetric absmax scales per output channel: `quantize_tensor`
reduces over the contraction axes of the consuming product and every
remaining channel keeps its own scale.  The same layout holds int8 KV
pools (models/paging.init_block_pool(kv_quant=True)): one scale per
(position, head), over head_dim.

`quantize_params` walks the port's state dict (models/bridge names) and
replaces every matmul weight with a QTensor; 1-D leaves (the RMSNorm
scales) stay as they are.  The contraction axes follow the JAX tree's
tags, not the port's names: `attn.out` [H, D, E] contracts over (H, D),
the embedding [V, E] over E (one scale per row, since a lookup reads one
row at a time), every other projection over its first axis.  Quantize
from f32 weights, as the JAX package does: quantizing the bf16-cast
serving weights gives other scales.

A model built from a quantized state dict (models/llama.Llama
.from_params) keeps the int8 payloads and scales and dequantizes each
weight to cfg.dtype at its use, one layer at a time: the port's form of
the JAX package's in-step `make_dequantizer`.  No dequantized copy of the
whole tree stays resident.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence

import torch


@dataclasses.dataclass
class QTensor:
    """int8 payload + f32 scales: w ≈ q * scale."""

    q: torch.Tensor      # int8, the original shape
    scale: torch.Tensor  # f32, broadcastable to q (size 1 on reduced axes)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def dequantize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """(f32 payload * scale) rounded to dtype, in one pass: the
        product is taken in f32, the promoted type of int8 and f32, and
        rounded to dtype as it is stored (the bits of
        `(q.float() * scale).to(dtype)` without its two f32 copies)."""
        out = torch.empty(self.q.shape, dtype=dtype, device=self.q.device)
        return torch.mul(self.q, self.scale, out=out)

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device))


def quantize_tensor(w: torch.Tensor, axes: Sequence[int] = (0,)) -> QTensor:
    """Symmetric absmax int8 over `axes` (the contraction axes of the
    consuming product); every remaining channel gets its own scale.  An
    all-zero channel takes scale 1.  Rounds half to even (torch.round,
    as jnp.round) after a true division by the scale."""
    wf = w.float()
    absmax = torch.amax(wf.abs(), dim=tuple(axes), keepdim=True)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        absmax / 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


# contraction axes by the JAX tree's leaf tag: DenseGeneral kernels are
# tagged '<module>.kernel', raw params by their own key.  The raw "wi" /
# "wo" entries are MoE expert matrices; the dense MLP's tags are
# "wi.kernel" / "wo.kernel" and take the default (0,)
_CONTRACT_AXES = {
    "out.kernel": (0, 1),
    "wi": (1,),
    "wo": (1,),
    "embedding": (1,),
}


def _tag(name: str) -> str:
    """The JAX tree's tag of a port state-dict name: the embedding table
    is flax's `embed.embedding`, every other matrix a `<module>.kernel`."""
    if name == "embed":
        return "embedding"
    return name.rsplit(".", 1)[-1] + ".kernel"


def quantize_params(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The state dict with every matmul weight (2-D or more) replaced by
    a QTensor; 1-D leaves stay as they are.  Pass f32 weights."""
    out = {}
    for name, w in params.items():
        if w.dim() < 2:
            out[name] = w
        else:
            out[name] = quantize_tensor(w, _CONTRACT_AXES.get(_tag(name),
                                                              (0,)))
    return out


def dequantize_params(qparams: Mapping[str, Any],
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The inverse map: QTensor leaves become dtype tensors, everything
    else passes through."""
    return {k: v.dequantize(dtype) if isinstance(v, QTensor) else v
            for k, v in qparams.items()}


# one transform per dtype, so that serve_loop can recognise it by identity
_DEQUANTIZERS: Dict[torch.dtype, Any] = {}


def make_dequantizer(dtype: torch.dtype = torch.bfloat16):
    """dequantize_params to `dtype`, one function object per dtype (the
    JAX package's params_transform seam; the port's quantized model
    already applies it at each weight's use)."""
    if dtype not in _DEQUANTIZERS:
        def transform(qparams, _dtype=dtype):
            return dequantize_params(qparams, _dtype)

        _DEQUANTIZERS[dtype] = transform
    return _DEQUANTIZERS[dtype]


def quantized_bytes(qparams: Mapping[str, Any]) -> int:
    """Device bytes of the (quantized) state dict: payloads, scales and
    the leaves left as they are."""
    total = 0
    for v in qparams.values():
        for t in ((v.q, v.scale) if isinstance(v, QTensor) else (v,)):
            total += t.numel() * t.element_size()
    return total
