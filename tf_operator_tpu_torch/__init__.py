"""PyTorch/CUDA port of the tf_operator_tpu compute stack, for NVIDIA Hopper.

`tf_operator_tpu/` (JAX on a TPU) stays the reference; this package is its
second implementation.  It imports `torch` and never `jax`, `flax` or any
`tf_operator_tpu` module: the small host-side pieces it needs from the
JAX package (the block allocator, the segment schedule) are copied here,
and `tests/test_torch_*.py` hold each copy against its original.

What is ported so far is the paged serving path of the Llama family:

  - models/llama.py           config, rotary, RMSNorm, SwiGLU, paged GQA
                              attention, the decoder, token selection
  - models/paging.py          block pool allocator and block-table writes
  - models/paged_attention.py the paged-attention wrapper: a hand-written
                              CUDA kernel (csrc/paged_attention.cu) on the
                              card, its plain PyTorch version on the CPU
  - models/bridge.py          flax parameter trees -> the port's state dict,
                              and seeded random weights at full width
  - models/serving.py         serve_loop's paged slot scheduler

Entry points take `device=` and default to "cuda"; without a card they
raise instead of running on the CPU (device.py).
"""
