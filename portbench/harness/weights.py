"""Seeded weights of a Llama-family configuration, drawn on the device.

The same draw feeds the program (models/llama.Llama.from_params) and the
plain reference, so both read the same tensors.  A draw is made per
group of leaves (the embedding, each layer, the head, the final norm):
one large random call a group, of which every leaf is a view, so any
group can be drawn again alone from the seed (the training check draws
each layer's start again to measure how far the steps moved it).

Float draws (training): every matrix N(0, 1/fan_in) (the embedding's
fan_in is d_model, so that tied logits too have unit spread), norm
scales 1 + 0.1 N(0, 1).

int8 draws (serving): every matrix an int8 payload uniform in
[-127, 127] and float32 scales, one per output channel as
models/quant's contraction axes place them, each
(0.5 + U(0, 1)) / (73.6 sqrt(fan_in)) so that the weight's spread is
about 1/sqrt(fan_in) (73.6 is the spread of the uniform payload); the
router and the norm scales stay float32, as the port serves them.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch

PAYLOAD_STD = math.sqrt((255 ** 2 - 1) / 12.0)


def derive(seed: int, *tags) -> int:
    """A 63-bit generator seed from the run's seed and tags."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g


class Shape:
    """The sizes of a Llama-family configuration file."""

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
        self.max_len = int(cfg["max_position_embeddings"])


# (name, shape, fan_in, contraction axes of models/quant) per leaf; a
# norm scale has fan_in 0 and the router no contraction axes (float32)
Leaf = Tuple[str, Tuple[int, ...], int, Optional[Tuple[int, ...]]]


def groups(s: Shape) -> List[Tuple[str, List[Leaf]]]:
    """The leaves in the port's state-dict names and layouts, by group."""
    out = [("embed", [("embed", (s.vocab, s.d), s.d, (1,))])]
    for i in range(s.layers):
        p = f"blocks.{i}."
        leaves = [
            (p + "ln1.scale", (s.d,), 0, None),
            (p + "attn.wq", (s.d, s.h, s.hd), s.d, (0,)),
            (p + "attn.wkv", (s.d, 2, s.kv, s.hd), s.d, (0,)),
            (p + "attn.out", (s.h, s.hd, s.d), s.h * s.hd, (0, 1)),
            (p + "ln2.scale", (s.d,), 0, None),
        ]
        if s.experts:
            leaves += [
                (p + "moe.router", (s.d, s.experts), s.d, None),
                (p + "moe.wi", (s.experts, s.d, 2 * s.f), s.d, (1,)),
                (p + "moe.wo", (s.experts, s.f, s.d), s.f, (1,)),
            ]
        else:
            leaves += [
                (p + "mlp.wi", (s.d, 2, s.f), s.d, (0,)),
                (p + "mlp.wo", (s.f, s.d), s.f, (0,)),
            ]
        out.append((f"layer{i}", leaves))
    if not s.tied:
        out.append(("head", [("lm_head", (s.d, s.vocab), s.d, (0,))]))
    out.append(("final", [("ln_f.scale", (s.d,), 0, None)]))
    return out


def _numel(shape) -> int:
    return math.prod(shape)


def float_group(s: Shape, seed: int, gi: int, leaves: List[Leaf],
                device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """One group's leaves: one float32 normal draw, views scaled per
    leaf; the matrices then rounded to `dtype` (the norm scales and the
    router stay float32, as the port serves them)."""
    flat = torch.randn(sum(_numel(sh) for _, sh, _, _ in leaves),
                       generator=generator(device, seed, "f32", gi),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, fan_in, _ in leaves:
        n = _numel(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if fan_in == 0:
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(1.0 / math.sqrt(fan_in))
            if dtype != torch.float32 and not name.endswith("router"):
                t = t.to(dtype)
        out[name] = t
    return out


def draw_float(cfg: dict, seed: int, device, dtype=torch.float32
               ) -> Dict[str, torch.Tensor]:
    """Every leaf, the matrices in `dtype` (float32: training's
    masters)."""
    s = Shape(cfg)
    out = {}
    for gi, (_, leaves) in enumerate(groups(s)):
        out.update(float_group(s, seed, gi, leaves, device, dtype))
    return out


def scale_shape(shape, axes) -> Tuple[int, ...]:
    return tuple(1 if i in axes else n for i, n in enumerate(shape))


def int8_group(s: Shape, seed: int, gi: int, leaves: List[Leaf], device
               ) -> Dict[str, object]:
    """One group's leaves as served: (int8 payload, float32 scales) for
    a matrix, float32 for the router and the norm scales.  One draw a
    group for the payloads, one for the scales, one for the float
    leaves."""
    mats = [lf for lf in leaves if lf[3] is not None]
    floats = [lf for lf in leaves if lf[3] is None]
    out = {}
    if mats:
        q = torch.randint(-127, 128, (sum(_numel(sh) for _, sh, _, _ in mats),),
                          generator=generator(device, seed, "q", gi),
                          device=device, dtype=torch.int8)
        sc = torch.rand(sum(_numel(scale_shape(sh, ax))
                            for _, sh, _, ax in mats),
                        generator=generator(device, seed, "scale", gi),
                        device=device, dtype=torch.float32)
        at = sat = 0
        for name, shape, fan_in, axes in mats:
            n = _numel(shape)
            ss = scale_shape(shape, axes)
            m = _numel(ss)
            scale = sc[sat:sat + m].view(ss)
            scale.add_(0.5).mul_(1.0 / (PAYLOAD_STD * math.sqrt(fan_in)))
            out[name] = (q[at:at + n].view(shape), scale)
            at += n
            sat += m
    if floats:
        out.update(float_group(s, seed, gi, floats, device))
    return out


def draw_int8(cfg: dict, seed: int, device) -> Dict[str, object]:
    s = Shape(cfg)
    out = {}
    for gi, (_, leaves) in enumerate(groups(s)):
        out.update(int8_group(s, seed, gi, leaves, device))
    return out


def iter_float_groups(cfg: dict, seed: int, device
                      ) -> Iterator[Dict[str, torch.Tensor]]:
    """The float32 groups one at a time, drawn again from the seed."""
    s = Shape(cfg)
    for gi, (_, leaves) in enumerate(groups(s)):
        yield float_group(s, seed, gi, leaves, device)
