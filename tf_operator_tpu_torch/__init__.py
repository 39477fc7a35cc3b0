"""PyTorch/CUDA port of the tf_operator_tpu compute stack, for NVIDIA Hopper.

`tf_operator_tpu/` (JAX on a TPU) stays the reference; this package is its
second implementation.  It imports `torch` and never `jax`, `flax` or any
`tf_operator_tpu` module: the small host-side pieces it needs from the
JAX package (the block allocator, the segment schedule) are copied here,
and `tests/test_torch_*.py` hold each copy against its original.

What is ported so far is the Llama family's paged serving path (slot and
continuous schedulers, bf16 or int8 weights and KV, speculation, serving
telemetry), its decoding over dense ring caches (generate,
speculative_generate, serve_loop(paged=False)) and its training step,
with attention on one device or split over a sequence ring:

  - models/llama.py           config, rotary, RMSNorm, SwiGLU, GQA
                              attention, the decoder (paged decode, dense
                              ring decode and full-sequence training),
                              token selection, init_cache and generate
  - models/paging.py          block pool allocator, the continuous
                              scheduler's gate, block-table writes (float
                              or int8 pools)
  - models/quant.py           weight-only int8 (QTensor, quantize_params)
                              and the int8 KV layout
  - models/paged_attention.py the paged-attention wrapper: hand-written
                              CUDA kernels (csrc/paged_attention.cu: K1,
                              and K1q for int8 pools) on the card, their
                              plain PyTorch versions on the CPU
  - models/bridge.py          flax parameter trees -> the port's state dict,
                              and seeded random weights at full width
  - models/serving.py         serve_loop's slot and continuous
                              schedulers over a paged pool (shared
                              prefix, the handoff, sliding windows,
                              speculation) or dense rings (paged=False)
  - models/speculative.py     the draft/verify round (paged pools or
                              dense rings) and speculative_generate
  - models/telemetry.py       serving telemetry: ServeTelemetry and
                              ServeStats, fed by serve_loop
  - engine/tracing.py         span tracer (Chrome trace export)
  - engine/metrics.py         the Prometheus serving families
  - models/transformer.py     the einsum attention and the CLM loss
  - ops/flash_attention.py    flash attention forward and backward: three
                              hand-written CUDA kernels
                              (csrc/flash_attention.cu) behind an autograd
                              Function, plain versions on the CPU
  - ops/ring_flash.py         sequence-parallel ring flash attention:
                              three hand-written CUDA kernels for the
                              ring's steps (csrc/ring_flash.cu) behind an
                              autograd Function, plain versions on the CPU
  - ops/ring_attention.py     the einsum ring (the ring's plain reference)
  - ops/zigzag.py             the load-balanced sequence layout
  - parallel/ring.py          the rings: LocalRing (members in one
                              process) and ProcessRing (torch.distributed)
  - parallel/mesh.py          mesh sizing
  - ops/blocked_ce.py         cross-entropy fused with the (tied) head
  - runtime/                  adafactor, train state and step, the
                              training loop, the profiler
  - train_llama.py            the training entry point
  - generate_llama.py         the inference entry point

Entry points take `device=` and default to "cuda"; without a card they
raise instead of running on the CPU (device.py).
"""
