"""LoRA: low-rank adaptation for parameter-efficient finetuning.

The port of tf_operator_tpu/models/lora.py over the port's Llama and
Transformer parameters.  Adapters live in their own dict, keyed by the
state-dict name of the kernel they adapt (`blocks.0.attn.wq`,
`blocks.0.moe.wi`, `blocks.0.attn.qkv`), each {"a", "b"} in f32, and the
effective kernel is W + (alpha/r)·(A@B) reshaped to W's shape:

  - the targets default to every projection of both families (wq, wkv,
    out, wi, wo, qkv); embeddings, norms and routers stay frozen;
  - a kernel adapts as one unit over its TRUE fan-in/fan-out split
    (bridge.kernel_dims): the attention out kernel [H, D, E] contracts
    (H, D), so A is [H·D, r] and B [r, E];
  - an expert bank [X, in, out] gets one adapter per expert, a
    [X, in, r] and b [X, r, out], of fan-in `in`, applied by a batched
    product;
  - A ~ N(0, 1)/sqrt(fan_in) and B = 0, so the adapted model starts
    exactly at the base model.

`init`, `apply_to`, `merge`, `n_params` and `make_lora_loss` are the JAX
module's functions on state dicts (`merge_into` is `merge` in place, for
a model too large for a second copy).  Training attaches the adapters to a
model instead (`attach`): each targeted weight gets a parametrization
(torch.nn.utils.parametrize) that returns W + (alpha/r)·(A@B) at every
use, so only one layer's effective weights exist at a time, and under
remat (torch.utils.checkpoint) the effective weight is rebuilt in the
recompute rather than kept.  The base's requires_grad is off, and the
optimizer holds the adapters alone (`adapter_params`, given to
runtime/train.TrainState.create).  The product runs on the effective
weight, so a step still takes the weight gradient of every adapted
kernel (the adapters' gradients come from it), as the JAX module's
apply_to does.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from tf_operator_tpu_torch.models.bridge import kernel_dims

DEFAULT_TARGETS = ("wq", "wkv", "out", "wi", "wo", "qkv")

Adapters = Dict[str, Dict[str, torch.Tensor]]


def _targeted(name: str, targets: Sequence[str]) -> bool:
    return name.rpartition(".")[2] in targets


def init(generator: torch.Generator, params: Mapping[str, torch.Tensor],
         rank: int, targets: Sequence[str] = DEFAULT_TARGETS) -> Adapters:
    """Adapters {name: {"a", "b"}} for every targeted kernel of `params`
    (a state dict), drawn from `generator` on its device, in state-dict
    order.  Dense kernel [in..., out...]: a [fan_in, r], b [r, fan_out];
    expert bank [X, in, out]: a [X, in, r], b [X, r, out]."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    adapters = {}
    dev = generator.device
    for name, w in params.items():
        if not _targeted(name, targets):
            continue
        bank, n_in = kernel_dims(name)
        shape = tuple(w.shape)
        lead = shape[:bank]
        fan_in = math.prod(shape[bank:bank + n_in])
        fan_out = math.prod(shape[bank + n_in:])
        a = torch.randn(lead + (fan_in, rank), generator=generator,
                        device=dev, dtype=torch.float32)
        b = torch.zeros(lead + (rank, fan_out), device=dev,
                        dtype=torch.float32)
        adapters[name] = {"a": a / math.sqrt(fan_in), "b": b}
    if not adapters:
        raise ValueError(
            f"no kernels matched targets {tuple(targets)} — wrong param "
            f"tree or target names")
    return adapters


def _delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A@B, per expert for a bank."""
    return torch.bmm(a, b) if a.dim() == 3 else a @ b


def _effective(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               alpha: float) -> torch.Tensor:
    # the JAX order: reshape, scale, cast to W's dtype, add
    return w + (_delta(a, b).reshape(w.shape) * (alpha / a.shape[-1])).to(
        w.dtype)


def _check_names(names, adapters: Mapping) -> None:
    leftover = set(adapters) - set(names)
    if leftover:
        raise ValueError(
            f"adapters reference kernels absent from the param tree "
            f"(stale save / different config?): {sorted(leftover)[:5]}")


def apply_to(params: Mapping[str, torch.Tensor], adapters: Adapters,
             alpha: float = 16.0) -> Dict[str, torch.Tensor]:
    """Effective params: targeted kernels + (alpha/r)·(A@B) reshaped, the
    rest as they are.  Differentiable in both arguments.  Every adapter
    must find its kernel: a stale adapter dict fails loudly."""
    _check_names(params, adapters)
    return {k: (_effective(w, adapters[k]["a"], adapters[k]["b"], alpha)
                if k in adapters else w) for k, w in params.items()}


def merge(params: Mapping[str, torch.Tensor], adapters: Adapters,
          alpha: float = 16.0) -> Dict[str, torch.Tensor]:
    """The adapters baked into a standalone state dict (deployment: the
    merged model runs at the base model's cost)."""
    return apply_to(params, adapters, alpha)


def n_params(adapters: Adapters) -> int:
    return sum(t.numel() for ad in adapters.values() for t in ad.values())


def make_lora_loss(loss_fn: Callable, params: Mapping[str, torch.Tensor],
                   alpha: float = 16.0) -> Callable:
    """Close `loss_fn(params, *args)` over the FROZEN base: returns
    f(adapters, *args), whose gradient reaches the adapters only."""
    frozen = {k: v.detach() for k, v in params.items()}

    def wrapped(adapters, *args):
        return loss_fn(apply_to(frozen, adapters, alpha), *args)

    return wrapped


def adapters_from_jax(tree: Mapping) -> Adapters:
    """The JAX module's adapter dict ({"block0/attn/wq/kernel": {"a",
    "b"}}, numpy or jax arrays) keyed by the port's state-dict names
    ({"blocks.0.attn.wq": ...}), in f32."""
    out = {}
    for path, ad in tree.items():
        parts = path.split("/")
        if parts[-1] == "kernel":
            parts = parts[:-1]
        if parts[0].startswith("block"):
            parts = ["blocks", parts[0][len("block"):]] + parts[1:]
        out[".".join(parts)] = {
            k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy())
            for k, v in ad.items()}
    return out


# ------------------------------------------------------------ training form
class LoraDelta(nn.Module):
    """The parametrization of one adapted weight: W -> W + scale·(A@B)
    reshaped to W's shape and cast to its dtype, at every read.  On a
    sharded model (parallel/placement) W is this rank's part of the
    weight: the delta is formed at the whole shape `whole` and `view`
    takes the same part of it (its tp slice)."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor,
                 alpha: float, whole=None, view=None) -> None:
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)
        self.alpha = alpha
        self.whole, self.view = whole, view

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        if self.view is None:
            return _effective(w, self.a, self.b, self.alpha)
        delta = (_delta(self.a, self.b).reshape(self.whole)
                 * (self.alpha / self.a.shape[-1])).to(w.dtype)
        return w + self.view(delta)


def attach(model: nn.Module, adapters: Adapters, alpha: float = 16.0
           ) -> Dict[str, nn.Parameter]:
    """Attach `adapters` to `model` in place: every parameter of the base
    is frozen (requires_grad off, no copy), and each adapted weight reads
    W + (alpha/r)·(A@B) at its use.  The adapters become parameters of
    the model on the base's device; returns adapter_params(model).

    On a sharded model (parallel/placement) the base stays sharded and
    the adapters are whole on every rank: each rank's W + s·A@B takes
    the part of A@B its block of W covers, and since every tp rank sees
    only its part, A's and B's gradients sum over tp."""
    placement = getattr(model, "placement", None)
    base = (placement.params(model) if placement is not None
            else dict(model.named_parameters()))
    _check_names(base, adapters)
    for p in model.parameters():
        p.requires_grad_(False)
    for name, ad in adapters.items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        dev = base[name].device
        extra = {}
        if placement is not None:
            extra = dict(whole=placement.shapes[name],
                         view=placement.views[name])
            if placement.tp is not None:
                placement.tp_partial |= {f"{name}.a", f"{name}.b"}
        parametrize.register_parametrization(
            mod, attr, LoraDelta(ad["a"].detach().to(dev, torch.float32),
                                 ad["b"].detach().to(dev, torch.float32),
                                 alpha, **extra), unsafe=True)
    return adapter_params(model)


def _attached(model: nn.Module):
    """(kernel name, LoraDelta) of every attached adapter."""
    for mod_name, mod in model.named_modules():
        if not parametrize.is_parametrized(mod):
            continue
        for attr, plist in mod.parametrizations.items():
            for p in plist:
                if isinstance(p, LoraDelta):
                    yield f"{mod_name}.{attr}" if mod_name else attr, p


def adapter_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The attached adapters' parameters, {"<kernel>.a", "<kernel>.b"}:
    what the optimizer holds and a checkpoint saves."""
    return {f"{name}.{k}": getattr(d, k) for name, d in _attached(model)
            for k in ("a", "b")}


def adapters_of(model: nn.Module) -> Adapters:
    """The attached adapters as an adapter dict (detached)."""
    return {name: {"a": d.a.detach(), "b": d.b.detach()}
            for name, d in _attached(model)}


@torch.no_grad()
def merge_into(model: nn.Module) -> None:
    """Bake the attached adapters into the base weights in place and
    detach them: the merged model runs at the base's cost, and no second
    copy of it is made (one weight's effective value at a time, as
    `merge` computes it)."""
    for name, delta in list(_attached(model)):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        w = mod.parametrizations[attr].original
        w.copy_(_effective(w, delta.a, delta.b, delta.alpha))
        parametrize.remove_parametrizations(mod, attr,
                                            leave_parametrized=False)


def base_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The frozen base's tensors by their plain state-dict names (the
    parametrized weights' originals, not copies)."""
    out = {}
    for k, v in model.state_dict().items():
        if ".parametrizations." in k:
            if not k.endswith(".original"):
                continue
            mod, _, rest = k.partition(".parametrizations.")
            k = f"{mod}.{rest[:-len('.original')]}"
        out[k] = v
    return out
