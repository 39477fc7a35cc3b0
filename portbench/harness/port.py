"""The harness's few calls into the port (tf_operator_tpu_torch): its
model configuration from a configuration file, and its kernel build.
The port is imported inside the functions, after the run has set its
environment."""
from __future__ import annotations

import torch

from portbench.harness import weights
from portbench.harness.core import log


def llama_config(cfg: dict, traffic: dict, train: bool):
    """The port's LlamaConfig of a Llama-family configuration file."""
    from tf_operator_tpu_torch.models.llama import LlamaConfig
    from tf_operator_tpu_torch.ops.flash_attention import flash_attention

    s = weights.Shape(cfg)
    return LlamaConfig(
        vocab_size=s.vocab, d_model=s.d, n_heads=s.h, n_kv_heads=s.kv,
        n_layers=s.layers, d_ff=s.f, max_len=s.max_len, rope_theta=s.theta,
        norm_eps=s.eps, dtype=getattr(torch, cfg["torch_dtype"]),
        tie_embeddings=s.tied, sliding_window=s.window,
        n_experts=s.experts, moe_every=1, moe_top_k=s.top_k or 1,
        remat=bool(traffic.get("remat")) and train,
        attention_fn=(flash_attention if traffic.get("attention") == "flash"
                      else None))


def build_kernels(ctx) -> None:
    """Build (or find in the checkout's cache) the CUDA sources the
    traffic names."""
    if ctx.device.type != "cuda":
        return
    from tf_operator_tpu_torch import kernels

    built = kernels.build_all(tuple(ctx.traffic.get("kernel_sources", ())))
    if built:
        log(f"built {sorted(built)} in {max(built.values()):.1f} s")
