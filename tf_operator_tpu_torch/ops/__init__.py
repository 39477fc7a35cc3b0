"""Fused operators of the port: flash, ring flash and Ulysses attention,
and blocked cross-entropy."""
from tf_operator_tpu_torch.ops.ulysses import (  # noqa: F401
    make_ulysses_attention_fn)
