"""GPU smoke run of the PyTorch/CUDA port (tf_operator_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (on PATH or under CUDA_HOME, default
/usr/local/cuda) and the repository checkout around this file.  Exits
non-zero, printing no result, when there is no card or no checkout.
Phases, in order, none of them caught:

  1. device:  the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build:   nvcc builds every kernel of the port from csrc/.
  3. kernel:  the paged-attention kernel (csrc/paged_attention.cu) against
              its plain PyTorch version on the card at the serving shapes
              of llama3_8b (H=32, KV=8, D=128, bs=16, 8 lanes up to ~1k
              positions, scratch padding, a frozen lane, a modular ring
              table), L=1 and L=512, bf16 (the tensor-core design, split
              over the table at decode) and f32 (the scalar design), with
              and without a window; the split's edges (contexts ending
              inside the first chunk, on chunk boundaries and inside
              chunks, a window that empties whole chunks, L*G = 12, 16 and
              17 rows), L=974 and bs=64, the spec phase's verify (8 lanes
              at L=5, each at its own position, 20 rows a kv head) and
              draft step (L=1) over 69-slot tables with lanes across,
              on and off block edges; two launches give the same bits;
              then its time beside the plain version's, an SDPA yardstick
              and the card's bound, and the kernel's and SDPA's device
              time alone, at decode, prefill and the verify.
  4. serve:   llama3_8b at full width and depth (bf16, random weights from
              a seed) serves 16 requests through serve_loop on a paged
              pool; every KV read goes through the kernel, whose launch
              count must equal layers x model calls, every one of them
              through the tensor-core design.  Its telemetry: a private
              Tracer holds one span tree a request (queued, prefill,
              decode), whose Chrome export parses; the card's memory
              peak is reported; TPOT, end-to-end latency and occupancy
              are printed (as in every serving phase).
  4b. spec:   the serve phase's model and prompts served speculatively,
              64 new tokens, 8 slots, spec_k 4, 4 rounds a block, the
              draft the target's own first 8 layers: (a) the slot
              scheduler, (b) the continuous one, which gives (a)'s
              tokens; then the target as its own draft (8 requests),
              whose acceptance rate must pass 0.9.  K1 launches equal
              target layers x target calls + draft layers x draft calls,
              all on the tensor cores.
  4c. dense:  the serve phase's model and prompts over dense per-lane
              rings, serve_loop(paged=False): (a) the slot scheduler, (b)
              the continuous one, which gives (a)'s tokens (how many
              requests give the serve phase's paged tokens is printed);
              generate on 8 equal 512-token prompts, one pass and in
              chunks of 128; the self-draft witnesses over the spec
              phase's witness requests, serve_loop and
              speculative_generate, each accepting more than 0.9; the
              rings' bytes beside the paged pool's.  No kernel reads a
              dense ring: K1 and K1q launch 0 times.
  5. handoff: the serve phase's model over one shared 1000-token prefix
              (62 whole blocks of 16 and a copy-on-write boundary block)
              and 16 suffixes of 32-256 tokens, 64 new tokens each, 8
              slots: (a) unified serve_loop(shared_prefix=), (b)
              prefill_only=True, (c) serve_loop(full prompts, adopt=(b)'s
              handoffs) under the slot scheduler, (d) the same under the
              continuous one; (c) and (d) give (a)'s tokens, CoW and
              prefix reuse happen, the first export carries the 62
              prefix payloads and no later one does, exports and
              adoptions are counted, K1 launches equal layers x model
              calls in every run, all on the tensor cores; then
              export_blocks and adopt_blocks timed alone for one 79-block
              lane (seconds, GB/s, the hashing's share).
  6. parity:  full width, 2 layers, f32 (TF32 off): serve_loop's greedy
              tokens on the card (kernel) equal those on the CPU (plain);
              then the handoff with int8 KV (K1q) over an unaligned
              prefix, exported on the card and adopted on the card and
              on the CPU under both schedulers, gives the CPU's unified
              tokens.
  6b. spec-parity: full width, 2 layers, f32 (TF32 off), a 1-layer draft
              from another seed, spec_k 3: tokens, schedule and each
              request's accepted/proposed drafts on the card equal the
              CPU's under both schedulers, over an unaligned prefix, with
              the target as its own draft (rounds that accept), and with
              int8 weights, KV and draft (K1q, over the parity-int8
              phase's first two requests); the card's speculative tokens
              equal its non-speculative ones.  Then, informational, how
              far int8 KV moves one prefill's logits between the card and
              the CPU.
  6c. dense-parity: full width, 2 layers, f32 (TF32 off): generate one
              pass and chunked, speculative_generate self-drafted and
              over a windowed ring the verify wraps (window 32, 40
              slots; = generate on the card), serve_loop(paged=False)
              under both schedulers, over an unaligned prefix, with a
              1-layer draft, and with int8 weights and KV over the
              spec-parity phase's int8 requests: tokens (and schedules)
              on the card equal the CPU's; dense = paged on the card.
  7. window:  mistral_7b at full width and depth (bf16, random weights
              from seed 0, sliding window 4096) over a 1024-token shared
              prefix and 16 suffixes of 1024-6656 tokens, 128 new tokens
              each, 8 slots, prefill_chunk 512: a modular ring of 288
              slots of 16 (4608 positions) per lane, through which the
              long prompts stream and onto whose prefix slots the rings
              wrap; (a) the slot scheduler, (b) the continuous one, (c)
              the first 8 requests as prefill_only, adopted under the
              continuous scheduler.  (b) and (c) give (a)'s tokens, every
              run evicts ring blocks and swaps prefix slots for shadows,
              each leaves the pool holding the prefix's blocks alone, K1
              launches equal layers x model calls, all on the tensor
              cores, and K1q is never launched.
  8. window-parity: mistral_7b at full width, 2 layers, f32 (TF32 off),
              window 64 and max_len 512 (a 128-position ring): prompts
              streaming past the ring over a shared prefix, under both
              schedulers, give the CPU's tokens and schedule; so do an
              unaligned prefix at window 120, unchunked (the rotation
              copies prefix blocks, the boundary is copied on write), and
              int8 KV (K1q); an int8-KV windowed handoff exported on the
              card and adopted on the card and on the CPU gives the CPU's
              unified tokens.  Then K1 and K1q at the window phase's
              shapes (8 lanes at L=1 over wrapped 288-slot rings, one
              lane's L=512 segment past the ring, window 4096) against
              their plain versions, timed beside them, SDPA with the
              window mask and the bound counting only the window's keys.
  9. kernel2: the flash-attention kernels (csrc/flash_attention.cu: K2f
              forward, K2q dQ, K2kv dK/dV) against their plain versions at
              the llama3_8b training shapes (B=1, S=2048, H=32, KV=8,
              D=128), bf16 (all three on the tensor cores) and f32:
              causal, non-causal, window 512, and S=1000 (no 128-aligned
              tiling); then at D=64: S=1000, S=64, window 512 and
              non-causal; at D=128: S=129 and S=192 non-causal; two
              launches give the same bits; then each kernel's time beside
              its plain version, SDPA and the card's bound, and each
              kernel's and SDPA's device time alone.
  9b. kernel2-window: K2f, K2q and K2kv at mistral_7b's training shape
              (B=1, S=8192, H=32, KV=8, D=128, causal, window 4096, bf16)
              against their plain versions, elementwise and by each
              output's relative error norm (which a planted fault, the
              kernels at window 4032, must exceed), two launches
              bit-equal; their times beside the plain versions,
              flex_attention with a band block mask (the JSON line's
              library_ms), SDPA over the boolean band mask and the bound
              (only the keys inside the window).
 10. train:   llama3_8b at full width and depth as train_llama builds it
              (tied embeddings, remat, flash attention, blocked CE,
              adafactor), f32 master weights from a seed, bf16 compute,
              batch 1 x 2048 (train_llama's 8 x 8192 cut to fit one card),
              4 steps through run_training; every loss finite, the first
              near ln(vocab); K2f launched 2 x 32 times a step (forward and
              remat recompute), K2q and K2kv 32 times, every launch on the
              tensor cores.
 10b. mistral-train: mistral_7b at full width and depth (tied, remat,
              flash attention, f32 masters, bf16 compute), batch 1 x 8192
              (two windows of 4096), 3 steps through run_training: every
              loss finite, the first near ln(vocab); K2f launched 2 x 32
              times a step, K2q and K2kv 32, all on the tensor cores; step
              time, tokens/s, MFU and the memory peak printed; then one
              full-depth save of the trained state (the save a preemption
              makes), its seconds to the host and to the disk printed.
 11. train-parity: full width, 2 layers, f32 (TF32 off), batch 2 x 128:
              the loss and every parameter's gradient norm of one step on
              the card (kernels) equal those on the CPU (plain versions).
 11b. checkpoint: llama3_8b at full width, 2 layers, f32 masters, batch
              1 x 2048, checkpoints in a temporary directory: 2 steps, a
              sync save, a fresh model of another seed resumed for 2 more
              give the 4-step unbroken run's losses and parameters bit for
              bit; an async save followed by an in-place step restores the
              saved step's bits; restore_params into a bf16 serving model
              gives the in-memory model's greedy tokens through K1; bytes,
              seconds and GB/s of each save and restore.
 12. kernel1q: the int8 paged-attention kernel (K1q, the same source)
              against its plain version on the kernel phase's cases, with
              int8 pools quantized from them and the scratch block
              poisoned (payload 127, scale 1e4); two launches give the
              same bits; then its time beside the plain version's, an SDPA
              yardstick over the gathered dequantized view and the bound.
 13. serve-int8: llama3_8b at full width and depth with int8 weights
              (quantized from the seeded f32 draws) and int8 KV serves the
              serve phase's 16 requests under scheduler="continuous",
              prefill_chunk=256 streamed one segment per turn, on a pool
              of 240 blocks (the slot loop's default is 520): the step
              gate blocks, lanes are preempted, prompt segments ride the
              decode dispatches; every read goes through K1q, whose launch
              count must equal layers x model calls, every one of them
              through the tensor-core design, and none through K1.
 14. parity-int8: full width, 2 layers, f32 (TF32 off), int8 weights and
              KV, prefill_chunk set: greedy tokens and schedule of the
              continuous scheduler on the card equal those on the CPU,
              and the card's continuous tokens equal its slot tokens.
 15. kernel3: the ring flash attention step kernels (csrc/ring_flash.cu:
              K3f forward step, K3q dQ, K3kv dK/dV) against their plain
              versions at the ring-train shapes (B=1, S_l=512, H=32, KV=8,
              D=128, a ring of 4), bf16 and f32: a diagonal, a past and a
              future step, zigzag offsets, window 512, a carry-in with rows
              that saw no key, and S_l=200 (tiles straddle the zigzag
              halves), the backward's lse as the forward leaves it; two
              launches give the same bits, a dead step leaves every
              accumulator as it was, and every bf16 K3q and K3kv launch
              runs on the tensor cores; then the time of
              the last member's launches over its ring beside the plain
              versions, the bound and SDPA of that member's q against the
              whole sequence, and their device time alone.
 16. ring-train: the train phase's model, tokens and recipe with
              attention_fn = ring flash attention over LocalRing(4)
              (contiguous, batch 1 x 2048, S_l = 512), 4 steps: every loss
              finite, the first equal to the train phase's; K2 launched
              never, K3f/K3q/K3kv exactly as the ring schedule's live
              (member, step) pairs say (K3f twice: forward and remat),
              every K3q and K3kv launch on the tensor cores.
 17. ring-parity: full width, 2 layers, f32 (TF32 off), batch 1 x 256,
              LocalRing(4), zigzag with positions: the loss and every
              gradient norm equal across the ring on the card (K3), the
              ring on the CPU (plain versions) and the one-device flash
              attention on the card (K2).
 18. entry:   train_llama.main(["--smoke", "--ring", "--steps", "2"]) on the
              card: its ring of one member launches K3 (bf16 compute
              at D = 16: K3q and K3kv on the tensor cores).
 19. entry-ckpt: two seeded .rec shards; train_llama --smoke --data-dir
              --ckpt-dir (a save a step) for 2 steps, then to 4, resuming
              from 2; train_llama --smoke --model mistral (window 16: K2 on
              the tensor cores); serve_llama --smoke --ckpt-dir dense,
              --paged (K1) and --paged --int8-kv (K1q), and generate_llama
              --smoke --ckpt-dir: dense = paged = generate tokens.
 20. mixtral-parity: mixtral_8x7b at full width (8 experts of 14336,
              top-2), 2 layers, f32 (TF32 off): the sparse MoE forward
              (parallel/ep.grouped_moe) equals the dense dispatch on the
              card within 1e-4; paged serve_loop's greedy tokens and
              schedule on the card equal the CPU's under the slot and the
              continuous scheduler (prefill_chunk 16), with int8 KV (K1q)
              and speculatively (the first layer as the draft).
 21. mixtral-serve: mixtral_8x7b at full depth and width with int8
              weights (the router in f32) drawn and quantized leaf by
              leaf, bf16 KV, tied: 8 prompts of 64-1024 tokens, 32 new,
              8 slots, blocks of 16, slot and continuous (chunk 512); K1
              launches equal layers x model calls, all on the tensor
              cores; tokens/s, TTFT, TPOT, quantized_bytes, the peak and
              the share of tokens the two schedulers agree on.
 22. mixtral-train: mixtral_8x7b at full width cut to 4 layers (tied,
              remat, flash attention, f32 masters, adafactor), 1 x 2048,
              3 steps: losses finite, K2 launched 2 x 4 / 4 / 4 times a
              step on the tensor cores; step time, tokens/s, MFU over
              the active FLOPs, the peak; before training, its router's
              drops a layer on the first batch in sharded-train (e)'s 2
              ep blocks at factor 1.25 (topk_route), which (e) holds its
              dispatch's against.
 23. entry-mixtral: train_llama --smoke --model mixtral with a checkpoint,
              then serve_llama --int8 (dense, and --paged through K1) and
              generate_llama --int8 from it: equal greedy tokens.

 24. transformer-parity: bert_large at full width, 2 layers, f32 (TF32
              off), flash attention (the scalar K2 kernels), masked-LM
              loss and adamw; the same with 4 experts in its second
              block; t5_3b_decoder at full width, 2 layers, remat,
              lm_train_loss and then the blocked CE with adafactor: 3
              steps of 2 x 128 each on the card and on the CPU from the
              same weights, every loss within 1e-5 and every gradient
              norm within 1e-4.
 25. kernel2-zoo: K2f, K2q and K2kv in bf16 at bert_large's attention
              (B=32, S=512, H=KV=16, D=64, non-causal) and the
              t5_3b_decoder's (B=8, S=512, H=KV=32, D=64, causal) against
              their plain versions, elementwise and by each output's
              relative error norm, two launches bit-equal; their times
              beside the plain versions, SDPA and the bound, and the
              kernels' and SDPA's device time alone.
 26. bert-train: bert_large at full width and depth (24 layers, remat,
              K2), f32 masters, bf16 compute, adamw, masked-LM batches of
              32 x 512, 4 steps: losses finite, K2f 2 x 24 launches a
              step, K2q and K2kv 24, all on the tensor cores; tokens/s,
              MFU and the memory peak.
 27. t5-train: t5_3b_decoder at full width and depth (48 layers, 2.48 B
              parameters, remat, K2 causal), adafactor, 8 x 512, 3 steps
              of lm_train_loss and 2 of the blocked CE: the same checks
              and numbers.
 28. vision-parity: a small f32 ResNet (4 stages of 1 block, width 16,
              64² images, SGD with momentum) and MnistCNN (adam) on the
              card (cuDNN, TF32 off) and on the CPU: logits, running
              stats, and 2 train steps' losses and gradient norms agree
              (and SGD's parameter updates).
 29. resnet-train: ResNet50 at 256 x 224² bf16 (channels_last, cuDNN),
              SGD with momentum, 4 steps: losses and running stats
              finite; images/s, MFU and the memory peak; then the entry
              point's flagship forward (ResNet50, eval, 8 x 224²) timed.
              bert-train, t5-train and resnet-train also print one
              more step's device time by kernel class and its idle
              share (torch.profiler), and resnet-train the flagship
              forward's.
 30. entry-zoo: train_bert --smoke, train_t5 --smoke --blocked-ce with a
              checkpoint and a resume, train_resnet at 64² (synthetic and
              from .rec shards), train_mnist and train_dist_mnist (worker
              and ps under TF_CONFIG) on the card.

 31. lora-train: llama3_8b at full width and depth as train_llama builds
              it, f32 masters frozen, rank-16 adapters (alpha 16) on its
              160 projections (models/lora, attached as parametrizations),
              Adam over the adapters alone, 1 x 2048, 4 steps: the adapter
              count and size from the shapes, the base held once, the
              first loss = the base model's, K2 64 / 32 / 32 a step on the
              tensor cores, the base bit-equal after the steps, the
              adapters merged in place = the attached model; step time,
              tokens/s, MFU, the peak and one step's device time by class.
 32. lora-parity: 2 layers f32, adapters with a random B: the loss and
              every adapter's gradient norm on the card = the CPU's.
 33. dp-train: train_resnet (128 x 224² a rank) and train_bert (bert_large,
              16 x 512 a rank) as jobs of two ranks on the one card (the
              PyTorchJob env, --backend gloo; `chip_smoke.py --dp-worker`
              runs each rank's entry points), against one process on the
              whole batch: losses, gradient norms and running stats within
              bf16 tolerances, both ranks' parameters bit-equal; images/s,
              tokens/s and the all-reduce's seconds a step (two ranks on
              one card: the collective's cost, not scaling).
 34. dp-parity: train_llama --smoke and --smoke --model mixtral in f32 as
              two-rank jobs = one process on the whole batch within 1e-5;
              rank 0's checkpoints, and both ranks resumed from them.
 35. (sharded-train's first job) the gloo probe: each collective on
              16 MB CUDA tensors between two gloo ranks on the one card
              (`--sharded-worker`), timed; fails if gloo refuses one the
              port calls (all_to_all_single with equal and with uneven
              chunks among them).
 36. kernel2-tp: kernel2-zoo's checks and times at the tp-local shapes
              of sharded-train: B=1 S=2048 H=16 KV=4 D=128 and B=4 S=512
              H=KV=16 D=64, causal.
 36b. kernel3-tp: kernel3's checks and times at the ring over tp 2's
              shape (S_l=1024, H=32, KV=8, D=128).
 37. sharded-train: `train_llama --tp 2` (llama3_8b at full width and
              depth, 1 x 2048, adafactor) as a job of two ranks, and
              t5_3b_decoder at full width cut to 12 layers
              (T5_TP_LAYERS) on a tp 2 x fsdp 2 mesh of four ranks
              through make_mesh / state_sharding / placement.place, 8 x
              512 global, 2 steps each, over gloo on the one card: the
              first loss within 2e-2 of one process's on the same
              weights and tokens (the train phase's; for t5 the cut
              model's forward in this process), every rank's losses equal, K2 at
              the tp-local heads on the tensor cores; step time,
              tokens/s, each rank's peak and the collectives' seconds.
              The two ranks then run `train_llama --tp 2 --ring` (the
              ring over tp: K3 launches a member's live steps, on the
              tensor cores, no K2; the exchange's and the rotations'
              calls, MiB and seconds), `train_llama --smoke --tp 2
              --ring`, and mixtral_8x7b at 4 layers with its experts over
              ep 2 through make_switch_moe (every loss finite, the first
              beside mixtral-train's, the share of (token, choice) pairs
              dropped at capacity factor 1.25, the all-to-all's calls,
              MiB and seconds); the four ranks `train_llama --smoke
              --model mixtral --tp 2 --ep 2`.  The two ranks also run
              (g) ops/ulysses: ulysses_attention over them on sequence
              blocks against one process's K2, and one step of (a)'s
              model with make_ulysses_attention_fn(mesh, "tp",
              use_flash=True), its first loss (a)'s bit for bit; (h)
              the pipelined llama (models/pipeline_llama) at
              llama3_8b's width, 4 layers, one stage a rank (pp 2), 4 x
              1024 in 4 microbatches, 2 adam steps, the first loss
              within 2e-2 of its sequential witness in one process, each
              rank's peak at most 30 GiB, the hops' calls, MiB and
              seconds; (i) an f32 1-layer mistral_7b-width model on
              fsdp 2 saved after a step, resharded to fsdp 4
              (models/reshard.reshard_checkpoint, timed) and resumed by
              the four ranks beside a never-resized fsdp 4 run: losses
              within 2e-4.
 38. sharded-parity: tests/test_torch_sharded.py's cases in f32 on eight
              ranks (tp 2 x fsdp 2 x dp 2, and tp 4 x fsdp 2), the ring
              over tp on tp 2 x fsdp 2 x dp 2 and the mixtral smoke model
              on tp 2 x ep 2 x dp 2 with a capacity that drops = one
              process on the card (for ep, the oracle of JAX's ep
              semantics); the sharded job's checkpoint resumed in one
              process; __graft_entry__.py's pipeline meshes (pp x tp, pp
              x fsdp, pp x ep with MoE and its aux in the stages) and the
              windowed pipelined llama, one stage a rank = the
              sequential witness in one process.
 39. kernel-tp: K1 and K1q against their plain versions at llama3_8b's
              tp 2 local shape (H=16, KV=4, D=128, bs=16, 8 lanes up to
              the serve phase's contexts, a frozen lane), decode L=1 and
              prefill L=512, bf16 (the tensor cores) and f32 (the scalar
              design); then timed as the kernel phase times them.
 40. tp-serve: llama3_8b at full width and depth served at tp 2 by two
              ranks sharing the card over gloo (`--sharded-worker`, the
              weights drawn leaf by leaf from the serve phase's seed, each
              rank its block; parallel/tp.kv_cache_sharding), with
              serve_loop(scheduler="continuous") on the first 8 of the
              serve phase's prompts (TP_SERVE_REQUESTS), 32 new tokens
              each (TP_SERVE_NEW), 8 slots: (a) bf16 weights and KV, (b)
              int8 weights
              quantized from the same draws and int8 KV (K1q).  Both
              ranks' tokens equal, every budget met and in the
              vocabulary, K1 (K1q) launches a rank = layers x model calls,
              all on the tensor cores, the first prefill's last-position
              logits within TP_LOGITS_TOL (relative error norm) of one
              process's on the same weights and prompt; tokens/s, TTFT,
              TPOT, each rank's peak beside the one-process phase's, the
              collectives a decode step, and the share of requests whose
              tokens equal the one-process phase's.
 41. tp-serve-parity: tests/test_torch_tp_serving.py's cases in f32 on
              eight ranks (tp 2 x dp 4, dp 2 x fsdp 2 x tp 2, tp 4 x dp 2,
              tp 2 and dp 2 x tp 2) = one process on the card: tokens,
              schedules, draft counts, each rank's cache its block, the
              handoff's exports and adoptions both ways.

The parity phases 6, 6b, 6c, 8, 14, 20 and 24 (their CPU halves most
of their time) run in a process of their own (`--parity-worker OUT
PHASE...`, PARITY_CHILD), started after the build beside the card's
phases and joined at the end; its log is replayed.

Prints the kernel table as one JSON line, then the device line, and last
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

instead builds the kernels and prints where the time goes at full width
(device time by kernel under torch.profiler, and the device's idle share)
for one decode block and one prefill segment (bf16, then int8 weights and
KV), one training step, one ring training step, one mistral_7b
training step at 1 x 8192, and one decode block and one prefill segment
of mixtral_8x7b at full depth with int8 weights (its elementwise time
split into the weights' dequantization, the experts' SwiGLU and the
routing and grouping).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # f32 outside the tensor cores
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ device
def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------------- build
def build() -> None:
    from tf_operator_tpu_torch import kernels

    t0 = time.perf_counter()
    per_source = kernels.build_all()
    log(f"[build] {len(per_source)} kernel source(s) built in "
        f"{time.perf_counter() - t0:.2f} s: "
        + json.dumps({k: round(v, 2) for k, v in per_source.items()}))
    for name, out in kernels.build_logs.items():
        for line in out.splitlines():
            # ptxas names each kernel (mangled) before its report
            if any(k in line for k in ("Function properties for",
                                       "registers", "spill")):
                log(f"[build] {name}: {line.strip()}")


# ------------------------------------------------------------ kernel phase
B, H, KV, D, BS = 8, 32, 8, 128, 16
MAX_CTX, MAX_NEW = 1024, 64


def make_case(dtype, l: int, window, ring: bool, seed: int, bs: int = BS,
              ctx=None, h: int = H, t_slots=None, kv: int = KV):
    """Pools, tables, positions and q for one kernel case.  Lanes 0..6
    are live at ragged positions (or at the contexts `ctx` gives); lane 7
    is frozen (all-scratch table).  The scratch block is poisoned, so a
    masking fault shows.  ring=True gives every live lane a full modular
    table with positions past T*bs (the sliding-window table
    discipline).  h: query heads over the kv (default KV = 8) kv heads.  t_slots: the
    table's width (default: the serve phase's, MAX_CTX + MAX_NEW)."""
    from tf_operator_tpu_torch.models.paging import blocks_for

    g = torch.Generator(device="cpu").manual_seed(seed)
    dev = torch.device("cuda")
    n_slots = t_slots or blocks_for(MAX_CTX + MAX_NEW, bs)
    if ring:
        ctx = [int(c) for c in torch.randint(
            n_slots * bs + l, 2 * n_slots * bs, (B - 1,), generator=g)]
        need = [n_slots] * (B - 1)
    else:
        if ctx is None:
            ctx = [int(c) for c in torch.randint(
                max(l, 8) + 8, MAX_CTX + 1, (B - 1,), generator=g)]
            ctx[0] = MAX_CTX  # the longest lane sits at the serve phase's cap
        need = [blocks_for(c, bs) for c in ctx]
    n_blocks = sum(need)
    ids = (torch.randperm(n_blocks, generator=g) + 1).tolist()
    table = torch.zeros((B, n_slots), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = torch.tensor(ids[at:at + n], dtype=torch.int32)
        at += n
    pos = torch.tensor([c - l for c in ctx] + [0], dtype=torch.int32)
    shape = (n_blocks + 1, bs, kv, D)
    k_pool = torch.randn(shape, generator=g)
    v_pool = torch.randn(shape, generator=g)
    k_pool[0] = 1e4
    v_pool[0] = 1e4
    q = torch.randn((B, l, h, D), generator=g)
    return dict(q=q.to(dev, dtype), k=k_pool.to(dev, dtype),
                v=v_pool.to(dev, dtype), table=table.to(dev),
                pos=pos.to(dev), window=window, ctx=ctx)


def bound_ms(case, dtype, int8: bool = False) -> tuple:
    """The least time the card could take for a full-causal linear-table
    case: the larger of the bytes the function must move over HBM
    bandwidth and its operations over the dtype's peak.  Bytes: each
    visible K/V block read once (a lane at ctx positions sees
    ceil(ctx / bs) blocks; int8 pools: one byte an element plus the f32
    scale of each (position, head)), q, out, the tables and positions.
    Operations: QK^T and PV of every query row against the positions
    visible to it (2 flops per multiply-add)."""
    from tf_operator_tpu_torch.models.paging import blocks_for

    esz = torch.finfo(dtype).bits // 8
    q = case["q"]
    b, l, h, d = q.shape
    kv = case["k"].shape[2]
    per_pos = kv * D * esz if not int8 else kv * D + kv * 4
    kv_bytes = sum(blocks_for(c, BS) for c in case["ctx"]) * BS * per_pos * 2
    io = 2 * q.numel() * esz + case["table"].numel() * 4 + b * 4
    flops = 0
    for c in case["ctx"]:
        # row i of L sees c - L + 1 + i positions
        flops += 2 * 2 * h * d * (l * (c - l + 1) + l * (l - 1) // 2)
    t_bytes = (kv_bytes + io) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 20, queued: bool = False) -> float:
    """Mean time of fn() over reps launches between two CUDA events, each
    after an L2 flush (the serving caller finds the pool cold: 31 other
    layers' weights pass through L2 between two reads of one layer's
    pool).  The events bracket the host's call too, so a wrapper's Python
    time counts where the card would wait for it.  queued=True first
    holds the card (torch.cuda._sleep, 1e6 cycles: about half a
    millisecond), so the call is enqueued before the start event fires
    and only device time is read.  Whether the hold covered the host's
    enqueue is checked on every launch: if the start event has already
    fired when the host is done, the card waited for the host, and the
    launch is taken again with the hold doubled (a ring member's four
    wrapper calls and SDPA's autograd backward are the longest enqueues
    timed here)."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total, done, hold = 0.0, 0, 1_000_000
    while done < reps:
        flush.zero_()
        if queued:
            torch.cuda._sleep(hold)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        late = queued and start.query()
        torch.cuda.synchronize()
        if late:
            if hold >= 2 ** 26:
                raise RuntimeError("a hold of 2^26 cycles did not cover "
                                   "the host's enqueue")
            hold *= 2
            log(f"[time] the hold did not cover the enqueue: now {hold} "
                f"cycles")
            continue
        total += start.elapsed_time(end)
        done += 1
    return total / reps


def sdpa_inputs(case):
    """The gathered linear view (int8 pools: dequantized to q's dtype)
    and mask that torch's scaled_dot_product_attention takes for the
    same function (the yardstick only: the port never calls SDPA)."""
    from tf_operator_tpu_torch.models import paging
    from tf_operator_tpu_torch.models.quant import QTensor

    q = case["q"]

    def view(pool):
        g = paging.gather_blocks(pool, case["table"])
        return g.dequantize(q.dtype) if isinstance(g, QTensor) else g

    k = view(case["k"]).transpose(1, 2)
    v = view(case["v"]).transpose(1, 2)
    c = k.shape[2]
    l = q.shape[1]
    qp = case["pos"].long()[:, None] + torch.arange(l, device=q.device)
    slot = torch.arange(c, device=q.device)
    kg = qp[..., None] - torch.remainder(qp[..., None] - slot, c)
    mask = kg >= 0
    if case["window"] is not None:
        mask &= kg > qp[..., None] - case["window"]
    return q.transpose(1, 2), k, v, mask[:, None]


# f32: the kernel folds 16-position blocks by online softmax, the plain
# version takes one softmax, so sums run in another order (~1e-6 on O(1)
# outputs).  bf16: both round p to bf16, but at different maxima (running
# vs final), and round the output to bf16 (2^-8 relative).  K1q holds the
# same: kernel and plain version read the same dequantized values.
PAGED_TOL = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}


# the handoff phase's shapes: a 1000-token shared prefix, suffixes of up
# to 256 tokens and 64 new tokens, over tables of blocks_for(1320, 16) = 83
# slots.  Its prefix write is L=1000 at position 0, its longest suffix
# fill L=256 at position 1000, and its decode runs 8 lanes at contexts of
# 1033 to 1320 (1024, 1152 and 1280 end on the split's chunk edges)
PREFIX_LEN, SUFFIX_MAX = 1000, 256
HANDOFF_CTX = [1320, 1033, 1024, 1152, 1256, 1280, 1001]


def handoff_t_slots() -> int:
    from tf_operator_tpu_torch.models.paging import blocks_for

    return blocks_for(PREFIX_LEN + SUFFIX_MAX + MAX_NEW, BS)


# the spec phase's verify: 8 lanes at L = SPEC_K + 1 = 5 (L*G = 20 rows a
# kv head, past the decode split's 16), each at its own position, over
# tables of blocks_for(1024 + 64 + 5, 16) = 69 slots (the worst case
# with the verify's headroom); the draft's L=1 steps run over its own
# pools through the same tables.  Contexts put the 5 positions across a
# block edge (18: 13..17), ending on one (16, 1024) and starting on one
# (21: 16..20; 517: 512..516); the first lane sits at the cap
SPEC_K = 4
VERIFY_CTX = [MAX_CTX + MAX_NEW + SPEC_K + 1, 16, 18, 21, 517, 1024, 700]


def verify_t_slots() -> int:
    from tf_operator_tpu_torch.models.paging import blocks_for

    return blocks_for(MAX_CTX + MAX_NEW + SPEC_K + 1, BS)


# the decode split's edges at the kernel phase's table (68 slots of 16,
# 64 (kv head, lane) pairs: chunks of 8 slots, 128 keys): contexts that
# end inside the first chunk (100), on chunk boundaries (128, 512, 1024)
# and inside chunks; lane 7 is frozen, so all its chunks are scratch
EDGE_CTX = [1024, 100, 128, 512, 600, 1000, 700]


def paged_cases() -> list:
    """The kernel phases' cases: dicts of make_case's arguments (dtype,
    L, window, ring; optionally bs, ctx, h)."""
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        cases += [dict(dtype=dt, l=l, window=w, ring=False)
                  for l in (1, 512) for w in (None, 256)]
        cases.append(dict(dtype=dt, l=1, window=512, ring=True))
        # serve_loop's default block size, 64: past 48 KB of shared memory
        cases.append(dict(dtype=dt, l=1, window=None, ring=False, bs=64))
        # the split's edges, and a window that empties whole chunks
        cases += [dict(dtype=dt, l=1, window=w, ring=False, ctx=EDGE_CTX)
                  for w in (None, 300)]
        # L*G = 12 and 16 rows (split, G = 4), 16 and 17 rows at G = 1
        # (H = KV = 8: the largest split and the smallest direct call)
        cases += [dict(dtype=dt, l=l, window=None, ring=False)
                  for l in (3, 4)]
        cases += [dict(dtype=dt, l=l, window=None, ring=False, h=KV)
                  for l in (16, 17)]
        # the serve phase's longest prompt; block size 64 at prefill
        cases.append(dict(dtype=dt, l=974, window=None, ring=False))
        cases.append(dict(dtype=dt, l=512, window=None, ring=False, bs=64))
        # the handoff phase's decode, suffix fill and prefix write
        t = handoff_t_slots()
        cases += [dict(dtype=dt, l=l, window=None, ring=False, t_slots=t,
                       ctx=ctx)
                  for l, ctx in ((1, HANDOFF_CTX),
                                 (SUFFIX_MAX, [PREFIX_LEN + SUFFIX_MAX] * 7),
                                 (PREFIX_LEN, [PREFIX_LEN] * 7))]
        # the spec phase's verify (L = 5, 20 rows) and draft step (L = 1)
        cases += [dict(dtype=dt, l=l, window=None, ring=False,
                       t_slots=verify_t_slots(), ctx=VERIFY_CTX)
                  for l in (SPEC_K + 1, 1)]
    return cases


def int8_pools(case) -> list:
    """The case's K and V pools quantized over head_dim (models/quant,
    as the int8 block write does), with the scratch block poisoned:
    payload 127 and scale 1e4, so a masking fault would show."""
    from tf_operator_tpu_torch.models import quant

    out = []
    for name in ("k", "v"):
        qt = quant.quantize_tensor(case[name], axes=(3,))
        qt.q[0] = 127
        qt.scale[0] = 1e4
        out.append(qt)
    return out


def kernel_phase(int8: bool = False) -> dict:
    """K1, or K1q (int8=True: the same draws quantized by int8_pools),
    against its plain version on paged_cases(): live rows within
    PAGED_TOL, the frozen lane finalizing to 0, two launches with the
    same bits.  Then its time at decode and prefill (bf16 queries)
    beside the plain version, SDPA over the gathered (dequantized) view
    and the bound."""
    from tf_operator_tpu_torch.models import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = "[kernel1q]" if int8 else "[kernel]"
    plain = (pa.paged_attention_int8_plain if int8
             else pa.paged_attention_plain)

    def inputs(case):
        k, v = int8_pools(case) if int8 else (case["k"], case["v"])
        return (case["q"], k, v, case["table"], case["pos"])

    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    # the verify cases' own (the spec phase's L = 5 at VERIFY_CTX)
    verify_errs = dict(errs)
    for i, kw in enumerate(paged_cases()):
        dt, l = kw["dtype"], kw["l"]
        case = make_case(seed=SEED + i, **kw)
        bs, h = kw.get("bs", BS), kw.get("h", H)
        chunk = (pa.split_slots(l * h // KV, case["table"].shape[1], bs,
                                KV * B) if dt == torch.bfloat16 else 0)
        err = check_paged(
            case, inputs(case), plain, dt, B - 1,
            f"{tag} {str(dt)[6:]:8s} L={l:<4d} H={h} bs={bs} "
            f"window={kw['window']} ring={kw['ring']} ctx={case['ctx']} "
            f"split_slots={chunk}")
        errs[dt] = max(errs[dt], err)
        if l == SPEC_K + 1 and kw.get("ctx") is VERIFY_CTX:
            verify_errs[dt] = max(verify_errs[dt], err)

    timings = {}
    for name, l in (("decode", 1), ("prefill", 512),
                    ("verify", SPEC_K + 1)):
        # the verify: the spec phase's tables, lanes at ragged contexts
        case = make_case(torch.bfloat16, l, None, False, SEED + 100,
                         t_slots=verify_t_slots() if l == SPEC_K + 1
                         else None)
        timings[name] = paged_timing(
            case, inputs(case), plain, bound_ms(case, torch.bfloat16, int8),
            f"{tag} timing {name} bf16 q, {'int8' if int8 else 'bf16'} KV, "
            f"B={B} L={l} H={H} KV={KV} D={D} bs={BS} ctx={case['ctx']}")
    return dict(errs=errs, verify_errs=verify_errs, timings=timings)


def check_paged(case, args, plain, dt, frozen, label: str) -> float:
    """K1 or K1q on args (the wrapper's inputs) against its plain version:
    the live rows within PAGED_TOL, lane `frozen` (None: none) finalizing
    to 0, two launches with the same bits.  Returns the largest error."""
    from tf_operator_tpu_torch.models import paged_attention as pa

    w = case["window"]
    got = pa.paged_attention(*args, window=w)
    again = pa.paged_attention(*args, window=w)
    ref = plain(*args, window=w)
    torch.cuda.synchronize()
    live = slice(0, frozen)
    diff = (got[live].float() - ref[live].float()).abs()
    atol, rtol = PAGED_TOL[dt]
    ok = bool((diff <= atol + rtol * ref[live].float().abs()).all())
    same = torch.equal(got, again)
    frozen_zero = frozen is None or bool((got[frozen] == 0).all())
    err = float(diff.max())
    log(f"{label} max_abs_err={err:.3e} (atol {atol}, rtol {rtol}) "
        f"frozen_lane_zero={frozen_zero} repeat={same}")
    if not (ok and same and frozen_zero and torch.isfinite(got).all()):
        raise AssertionError(
            f"{label}: the kernel disagrees with its plain version or does "
            f"not repeat: err={err} bit_identical={same}")
    return err


def paged_timing(case, args, plain, bound: tuple, label: str) -> dict:
    """K1's or K1q's time on args (the wrapper's inputs) beside its plain
    version, SDPA over the gathered (dequantized) view with the case's
    ring and window mask, and `bound` (ms, "bytes" or "operations"); and
    the kernel's and SDPA's device time alone."""
    from tf_operator_tpu_torch.models import paged_attention as pa

    w = case["window"]
    sq, sk, sv, mask = sdpa_inputs(dict(case, k=args[1], v=args[2]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fn = lambda: sdpa(sq, sk, sv, attn_mask=mask, enable_gqa=True)
    # plain, kernel, kernel, plain: one card, in turns
    p1 = time_ms(lambda: plain(*args, window=w))
    k1 = time_ms(lambda: pa.paged_attention(*args, window=w))
    k2 = time_ms(lambda: pa.paged_attention(*args, window=w))
    p2 = time_ms(lambda: plain(*args, window=w))
    lib = time_ms(lib_fn)
    # device time alone: the launches queued behind a wait on the card
    kq = time_ms(lambda: pa.paged_attention(*args, window=w), queued=True)
    libq = time_ms(lib_fn, queued=True)
    bnd, by = bound
    log(f"{label}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
        f"sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}); device time alone: "
        f"kernel {kq:.4f} ms, sdpa {libq:.4f} ms")
    return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib,
                bound_ms=bnd, bound_by=by, device_ms=kq,
                library_device_ms=libq)


# --------------------------------------------------------- kernel-2 phase
# llama3_8b training shapes at batch 1 (train_llama's 8 x 8192 cut to the
# train phase's 1 x 2048)
TB, TS, TH, TKV, TD = 1, 2048, 32, 8, 128
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")


def flash_case(dtype, s: int, seed: int, d: int = TD, b: int = TB,
               h: int = TH, kv_heads: int = TKV):
    """q [B, S, H, D], and k, v as the two halves of one fused
    [B, S, 2, KV, D] projection (strided views, as the model hands them
    over), and dO."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g)
    kv = torch.randn((b, s, 2, kv_heads, d), generator=g)
    do = torch.randn((b, s, h, d), generator=g)
    q, kv, do = (t.to("cuda", dtype) for t in (q, kv, do))
    return q, kv[:, :, 0], kv[:, :, 1], do


def flash_delta(out, do):
    return (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bound_ms(which: str, dtype, s: int, causal: bool, window,
                   b: int = TB, h: int = TH, kv_heads: int = TKV,
                   d: int = TD) -> tuple:
    """The least time the card could take for one kernel's work: the
    larger of its bytes (each input read once, each output written once)
    over HBM bandwidth and its products over the dtype's peak.  Products:
    2 flops per multiply-add over the visible (query, key) pairs of this
    case, for 2 matmuls (forward: QKᵀ, PV), 3 (dQ: QKᵀ, dO·Vᵀ, dS·K) or
    4 (dK/dV: QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q)."""
    esz = torch.finfo(dtype).bits // 8
    if not causal:
        pairs = s * s
    else:
        w = window or s
        pairs = sum(min(i + 1, w) for i in range(s))
    mm = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}[which]
    flops = mm * 2 * b * h * pairs * d
    qo = b * s * h * d * esz
    kv = b * s * kv_heads * d * esz
    stat = b * h * s * 4
    nbytes = {"flash_fwd": 2 * qo + 2 * kv + stat,           # q k v o lse
              "flash_dq": 3 * qo + 2 * kv + 2 * stat,        # + do delta dq
              "flash_dkv": 2 * qo + 4 * kv + 2 * stat}[which]  # + dk dv
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel2_phase() -> dict:
    """K2f, K2q and K2kv against their plain versions at the training
    shapes, bf16 and f32: causal; non-causal; window 512; and S=1000,
    which has no 128-aligned tiling.  The backward kernels take the plain
    forward's lse and delta, so each kernel is held to its own plain
    version.  Two launches must give the same bits.  Then each kernel's
    time beside its plain version, SDPA and the bound (bf16, causal)."""
    from tf_operator_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # f32: the kernels sum 64-wide tiles in another order than the whole-
    # sequence einsums (and fold the forward by online softmax), ~1e-6 on
    # O(1) values.  bf16: the outputs, p and dS are rounded to bf16 (2^-8
    # relative), at a running instead of the final maximum in the forward.
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    errs = {name: 0.0 for name in FLASH}
    # the training shapes, then the tensor-core kernels' edges: at D = 64
    # a tail tile (S = 1000), one tile (S = 64), a window that starts the
    # kv run past tile 0, and no mask at all; at D = 128 a lone row past
    # a whole tile (S = 129) and three tiles unmasked (S = 192)
    cases = [(dt, s, causal, w, d)
             for (s, causal, w, d) in (
                 (TS, True, None, TD), (TS, False, None, TD),
                 (TS, True, 512, TD), (1000, True, None, TD),
                 (1000, True, None, 64), (64, True, None, 64),
                 (1000, True, 512, 64), (1000, False, None, 64),
                 (129, True, None, TD), (192, False, None, TD))
             for dt in (torch.bfloat16, torch.float32)]
    for i, (dt, s, causal, w, d) in enumerate(cases):
        q, k, v, do = flash_case(dt, s, SEED + 10 + i, d)
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, w)
        delta = flash_delta(out_p, do)
        bwd = (q, k, v, do, lse_p, delta, causal, w)
        want = {"flash_fwd": (out_p, lse_p),
                "flash_dq": (fa.flash_dq_plain(*bwd),),
                "flash_dkv": fa.flash_dkv_plain(*bwd)}
        runs = [{"flash_fwd": fa.flash_fwd(q, k, v, causal, w),
                 "flash_dq": (fa.flash_dq(*bwd),),
                 "flash_dkv": fa.flash_dkv(*bwd)} for _ in range(2)]
        torch.cuda.synchronize()
        line = []
        for name in FLASH:
            same = all(torch.equal(a, b)
                       for a, b in zip(runs[0][name], runs[1][name]))
            err = 0.0
            ok = same
            for got, ref in zip(runs[0][name], want[name]):
                diff = (got.float() - ref.float()).abs()
                err = max(err, float(diff.max()))
                ok &= bool(torch.isfinite(got).all())
                ok &= bool((diff <= tol[dt] * (1 + ref.float().abs())).all())
            if dt == torch.bfloat16:
                errs[name] = max(errs[name], err)
            line.append(f"{name} err={err:.3e} repeat={same}")
            if not ok:
                raise AssertionError(
                    f"[kernel2] {name} disagrees with its plain version or "
                    f"does not repeat: dtype={dt} S={s} D={d} "
                    f"causal={causal} window={w} err={err} "
                    f"bit_identical={same}")
        log(f"[kernel2] {str(dt)[6:]:8s} S={s} D={d} causal={causal} "
            f"window={w} (atol=rtol={tol[dt]}): " + ", ".join(line))
        del runs, want, bwd

    q, k, v, do = flash_case(torch.bfloat16, TS, SEED + 30)
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = flash_delta(out, do)
    bwd = (q, k, v, do, lse, delta, True)
    fns = {"flash_fwd": (lambda: fa.flash_fwd(q, k, v, True),
                         lambda: fa.flash_fwd_plain(q, k, v, True)),
           "flash_dq": (lambda: fa.flash_dq(*bwd),
                        lambda: fa.flash_dq_plain(*bwd)),
           "flash_dkv": (lambda: fa.flash_dkv(*bwd),
                         lambda: fa.flash_dkv_plain(*bwd))}
    # the yardstick: SDPA (forward, and its backward through autograd,
    # which yields dq, dk and dv together); the port never calls it
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach() for x in (q, k, v))
    sdpa_fwd = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    with torch.no_grad():
        lib_fwd = time_ms(sdpa_fwd)
        lib_fwd_q = time_ms(sdpa_fwd, queued=True)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    o_s = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(o_s, (qg, kg, vg), dot,
                                           retain_graph=True)
    lib_bwd = time_ms(sdpa_bwd)
    lib_bwd_q = time_ms(sdpa_bwd, queued=True)
    timings = {}
    for name, (kern, plain) in fns.items():
        p1 = time_ms(plain)
        k1 = time_ms(kern)
        k2 = time_ms(kern)
        p2 = time_ms(plain)
        # device time alone: the launch queued behind a wait on the card
        kq = time_ms(kern, queued=True)
        bnd, by = flash_bound_ms(name, torch.bfloat16, TS, True, None)
        fwd = name == "flash_fwd"
        lib, lib_q = (lib_fwd, lib_fwd_q) if fwd else (lib_bwd, lib_bwd_q)
        timings[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             library_ms=lib, bound_ms=bnd, bound_by=by,
                             device_ms=kq, library_device_ms=lib_q)
        log(f"[kernel2] timing {name} bf16 causal B={TB} S={TS} H={TH} "
            f"KV={TKV} D={TD}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, sdpa {'fwd' if fwd else 'bwd'} "
            f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}); device time alone: "
            f"kernel {kq:.4f} ms, sdpa {lib_q:.4f} ms")
    # SDPA's backward yields dq, dk and dv together: its function is the
    # pair's
    pair = timings["flash_dq"]["device_ms"] + timings["flash_dkv"]["device_ms"]
    log(f"[kernel2] K2q + K2kv, device time alone: {pair:.4f} ms against "
        f"sdpa bwd {lib_bwd_q:.4f} ms ({pair / lib_bwd_q:.2f}x)")
    return dict(errs=errs, timings=timings)


# mistral_7b's training shape: S = 8192 tokens, two windows of 4096
MS, MWIN = 8192, 4096
# the outputs of each flash kernel, by name
FLASH_OUTS = {"flash_fwd": ("out", "lse"), "flash_dq": ("dq",),
              "flash_dkv": ("dk", "dv")}
# The window row's norm check, ||got - ref||_2 / ||ref||_2 for each output:
# the elementwise band (2e-2 + 2e-2 |ref|) is as wide as out, dq, dk and dv
# themselves at S = 8192 (|out| ~ 0.02 on unit randn), so it would pass a
# kernel that dropped the 64-key tile at the band's edge.  The limits sit a
# little above the sound bf16 readings (out, dq, dk, dv are rounded to
# bf16: 2^-9 relative; lse is f32); that fault, planted by launching the
# kernels at window MWIN - 64 against the MWIN reference, must exceed them.
WIN_NORM_TOL = {"out": 5e-3, "lse": 1e-6, "dq": 2e-3, "dk": 2e-3,
                "dv": 2e-3}
WIN_FAULT = MWIN - 64


def rel_l2(got, ref) -> float:
    """||got - ref||_2 / ||ref||_2, in f64."""
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm())


def kernel2_window_phase(kern2: dict) -> dict:
    """K2f, K2q and K2kv at mistral_7b's training shape (B=1, S=8192,
    H=32, KV=8, D=128, causal, window 4096, bf16) against their plain
    versions (whose [1, 32, 8192, 8192] f32 scores, 8.6 GB, fit beside
    the inputs): elementwise within 2e-2 + 2e-2 |ref|, each output's
    relative error norm within WIN_NORM_TOL, and the same kernels at
    window 4032 (a dropped edge tile) beyond it; two launches bit-equal.
    Then each kernel's time beside its plain version, flex_attention with
    a sliding-window block mask (which skips the tiles outside the band,
    as the kernels do), SDPA with the boolean band mask and the bound
    (only the keys inside the window), and the bound's share of device
    time beside the 2048-causal row's (kernel2 phase)."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    from tf_operator_tpu_torch.ops import flash_attention as fa

    tol = 2e-2
    q, k, v, do = flash_case(torch.bfloat16, MS, SEED + 31)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, True, MWIN)
    delta = flash_delta(out_p, do)
    bwd = (q, k, v, do, lse_p, delta, True)
    want = {"flash_fwd": (out_p, lse_p),
            "flash_dq": (fa.flash_dq_plain(*bwd, MWIN),),
            "flash_dkv": fa.flash_dkv_plain(*bwd, MWIN)}
    fa.reset_launches()
    runs = [{"flash_fwd": fa.flash_fwd(q, k, v, True, MWIN),
             "flash_dq": (fa.flash_dq(*bwd, MWIN),),
             "flash_dkv": fa.flash_dkv(*bwd, MWIN)} for _ in range(2)]
    torch.cuda.synchronize()
    if any(fa.launches[n] != 2 or fa.launches[n + "_mma"] != 2
           for n in FLASH):
        raise AssertionError(f"[kernel2-window] launches {fa.launches}")
    # the planted fault: the band's edge tile left out
    fault = {"flash_fwd": fa.flash_fwd(q, k, v, True, WIN_FAULT),
             "flash_dq": (fa.flash_dq(*bwd, WIN_FAULT),),
             "flash_dkv": fa.flash_dkv(*bwd, WIN_FAULT)}
    errs, norms, failed = {}, {}, []
    for name in FLASH:
        same = all(torch.equal(a, b)
                   for a, b in zip(runs[0][name], runs[1][name]))
        err, ok = 0.0, same
        for out, got, bad, ref in zip(FLASH_OUTS[name], runs[0][name],
                                      fault[name], want[name]):
            diff = (got.float() - ref.float()).abs()
            err = max(err, float(diff.max()))
            ok &= bool(torch.isfinite(got).all())
            ok &= bool((diff <= tol * (1 + ref.float().abs())).all())
            norms[out] = (rel_l2(got, ref), rel_l2(bad, ref))
            log(f"[kernel2-window] {out}: rel_l2 {norms[out][0]:.3e} "
                f"(limit {WIN_NORM_TOL[out]:.0e}); planted fault (window "
                f"{WIN_FAULT}) {norms[out][1]:.3e}")
            if norms[out][0] > WIN_NORM_TOL[out]:
                failed.append(f"{out} rel_l2 {norms[out][0]}")
            if norms[out][1] <= WIN_NORM_TOL[out]:
                failed.append(f"{out}: the norm check passes a dropped "
                              f"edge tile ({norms[out][1]})")
        errs[name] = err
        log(f"[kernel2-window] bf16 S={MS} window={MWIN} {name} "
            f"err={err:.3e} repeat={same} (atol=rtol={tol})")
        if not ok:
            failed.append(f"{name} elementwise err={err} bit_identical={same}")
    if failed:
        raise AssertionError(f"[kernel2-window] the kernels disagree with "
                             f"their plain versions or do not repeat: "
                             f"{failed}")
    del runs, fault, want, lse_p
    torch.cuda.empty_cache()

    out, lse = fa.flash_fwd(q, k, v, True, MWIN)
    bwd = (q, k, v, do, lse, flash_delta(out, do), True, MWIN)
    fns = {"flash_fwd": (lambda: fa.flash_fwd(q, k, v, True, MWIN),
                         lambda: fa.flash_fwd_plain(q, k, v, True, MWIN)),
           "flash_dq": (lambda: fa.flash_dq(*bwd),
                        lambda: fa.flash_dq_plain(*bwd)),
           "flash_dkv": (lambda: fa.flash_dkv(*bwd),
                         lambda: fa.flash_dkv_plain(*bwd))}
    qt, kt, vt = (x.transpose(1, 2).detach() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def library(attend) -> tuple:
        """Events and device-alone times of `attend`'s forward and of its
        backward through autograd (dq, dk and dv together), and its
        forward's rel_l2 against the plain version's out."""
        with torch.no_grad():
            fwd = lambda: attend(qt, kt, vt)
            o = fwd().transpose(1, 2)
            times = (time_ms(fwd, reps=5), time_ms(fwd, reps=5, queued=True))
        qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
        o_g = attend(qg, kg, vg)
        back = lambda: torch.autograd.grad(o_g, (qg, kg, vg), dot,
                                           retain_graph=True)
        times += (time_ms(back, reps=5), time_ms(back, reps=5, queued=True))
        return times + (rel_l2(o, out_p),)

    # the yardsticks; the port calls neither.  flex_attention (compiled)
    # with a block mask of the band skips the tiles outside it; SDPA takes
    # the band as a boolean mask (key j visible to query i when
    # i - 4096 < j <= i) and so computes every tile
    band_mod = lambda b, h, i, j: (j <= i) & (j > i - MWIN)
    block_mask = create_block_mask(band_mod, None, None, MS, MS,
                                   device="cuda")
    flex = torch.compile(flex_attention)
    t = time.perf_counter()
    # its backward is timed again and again over one graph (retain_graph),
    # which a compiled backward that donates its buffers refuses
    with torch._functorch.config.patch(donated_buffer=False):
        lib = {"flex": library(lambda a, b, c: flex(
            a, b, c, block_mask=block_mask, enable_gqa=True))}
    t_flex = time.perf_counter() - t
    i = torch.arange(MS, device="cuda")
    band = band_mod(None, None, i[:, None], i[None, :])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib["sdpa"] = library(lambda a, b, c: sdpa(a, b, c, attn_mask=band,
                                                  enable_gqa=True))
    for which, (*_, rel) in lib.items():
        log(f"[kernel2-window] {which} forward against the plain version: "
            f"rel_l2 {rel:.3e}")
        if rel > WIN_NORM_TOL["out"]:
            raise AssertionError(f"[kernel2-window] {which} does not compute "
                                 f"the windowed attention: rel_l2 {rel}")
    log(f"[kernel2-window] flex_attention compiled and timed in "
        f"{t_flex:.1f} s")
    del out_p
    timings = {}
    for name, (kern, plain) in fns.items():
        p1 = time_ms(plain, reps=3)
        k1 = time_ms(kern)
        k2 = time_ms(kern)
        p2 = time_ms(plain, reps=3)
        kq = time_ms(kern, queued=True)
        bnd, by = flash_bound_ms(name, torch.bfloat16, MS, True, MWIN)
        at = 0 if name == "flash_fwd" else 2
        fx, sd = lib["flex"][at:at + 2], lib["sdpa"][at:at + 2]
        timings[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             library_ms=fx[0], library_device_ms=fx[1],
                             sdpa_band_ms=sd[0], sdpa_band_device_ms=sd[1],
                             bound_ms=bnd, bound_by=by, device_ms=kq)
        causal = kern2["timings"][name]
        log(f"[kernel2-window] timing {name} bf16 causal window={MWIN} "
            f"B={TB} S={MS} H={TH} KV={TKV} D={TD}: kernel {k1:.4f}/"
            f"{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
            f"{'fwd' if at == 0 else 'bwd'}: flex (block mask) {fx[0]:.4f} "
            f"ms, sdpa (band mask) {sd[0]:.4f} ms, bound {bnd:.4f} ms "
            f"({by}); device time alone: kernel {kq:.4f} ms, flex "
            f"{fx[1]:.4f} ms, sdpa {sd[1]:.4f} ms; bound share "
            f"{bnd / kq:.4f} (2048 causal: "
            f"{causal['bound_ms'] / causal['device_ms']:.4f})")
    pair = timings["flash_dq"]["device_ms"] + timings["flash_dkv"]["device_ms"]
    log(f"[kernel2-window] K2q + K2kv, device time alone: {pair:.4f} ms "
        f"against flex bwd {lib['flex'][3]:.4f} ms "
        f"({pair / lib['flex'][3]:.2f}x), sdpa bwd {lib['sdpa'][3]:.4f} ms "
        f"({pair / lib['sdpa'][3]:.2f}x)")
    return dict(errs=errs, norms=norms, timings=timings)


# ------------------------------------------------------------- serve phase
def prompts_for(cfg, n: int, lo: int, hi: int, seed: int):
    g = torch.Generator(device="cpu").manual_seed(seed)
    lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
    return [torch.randint(0, cfg.vocab_size, (m,), generator=g)
            for m in lens]


def tel_line(stats) -> str:
    """The telemetry a serving run reports beside its throughput
    (models/telemetry.ServeStats; host clock, the memory peak from
    torch's allocator)."""
    tpot = ("None" if stats.tpot_mean_s is None
            else f"{stats.tpot_mean_s:.6f}")
    return (f"tpot_mean_s={tpot} "
            f"e2e_latency_mean_s={stats.e2e_latency_mean_s:.4f} "
            f"e2e_latency_max_s={stats.e2e_latency_max_s:.4f} "
            f"occupancy_mean={stats.occupancy_mean:.4f} "
            f"kv_block_occupancy_mean={stats.kv_block_occupancy_mean:.2f} "
            f"hbm_peak_bytes={json.dumps(stats.hbm_peak_bytes)}")


def check_spans(tracer, stats, n: int, tag: str) -> None:
    """A private tracer's serving spans: one root a request, each with
    the queued, prefill and decode children, and a Chrome export that
    parses with one complete event a span."""
    roots = tracer.traces()
    kids = [[c.name for c in r.children] for r in roots]
    reqs = sorted(r.attrs["request"] for r in roots)
    doc = json.loads(tracer.export_chrome_json())
    n_spans = sum(1 for r in roots for _ in r.walk())
    if (reqs != list(range(n)) or stats.requests != n
            or any(k != ["queued", "prefill", "decode"] for k in kids)
            or len(doc["traceEvents"]) != n_spans
            or not all(e["ph"] == "X" and e["cat"] == "serving"
                       for e in doc["traceEvents"])):
        raise AssertionError(
            f"[{tag}] spans: roots for requests {reqs} of {n}, children "
            f"{kids[:2]}, {len(doc['traceEvents'])} events of {n_spans}")


def serve_phase() -> dict:
    from tf_operator_tpu_torch.engine.tracing import Tracer
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.models.telemetry import ServeTelemetry

    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    model = llama.Llama.from_params(
        cfg, bridge.init_params(cfg, SEED, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] llama3_8b {cfg.n_layers} layers d_model={cfg.d_model} "
        f"vocab={cfg.vocab_size} {cfg.dtype}: random weights in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    kw = dict(slots=8, block_size=BS, steps_per_sync=8, device="cuda")
    prompts = prompts_for(cfg, 16, 64, MAX_CTX, SEED + 1)
    # warm-up (cuBLAS handles, allocator) on two short requests
    serve_loop(model, [p[:64] for p in prompts[:2]], max_new_tokens=8, **kw)
    torch.cuda.synchronize()

    calls = [0]
    hook = model.register_forward_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))
    torch.cuda.reset_peak_memory_stats()
    tracer = Tracer()
    pa.reset_launches()
    results, stats = serve_loop(model, prompts, max_new_tokens=MAX_NEW,
                                return_stats=True,
                                telemetry=ServeTelemetry(tracer=tracer), **kw)
    torch.cuda.synchronize()
    launches, mma = pa.launches, pa.launches_mma
    hook.remove()
    peak = torch.cuda.max_memory_allocated()
    check_spans(tracer, stats, len(prompts), "serve")
    dev_key = f"cuda:{torch.cuda.current_device()}"
    if not stats.hbm_peak_bytes.get(dev_key, 0) > 0:
        raise AssertionError(f"[serve] hbm_peak_bytes "
                             f"{stats.hbm_peak_bytes} has no {dev_key}")

    for i, r in enumerate(results):
        if len(r.tokens) != MAX_NEW:
            raise AssertionError(f"request {i} emitted {len(r.tokens)} "
                                 f"tokens, budget {MAX_NEW}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {i}: token out of vocab")
    if launches != cfg.n_layers * calls[0] or launches == 0:
        raise AssertionError(
            f"paged_attention launched {launches} times for {calls[0]} "
            f"model calls x {cfg.n_layers} layers")
    if mma != launches:
        raise AssertionError(f"[serve] {mma} of {launches} bf16-query K1 "
                             f"calls took the tensor-core design")
    ttft = sorted(r["ttft_s"] for r in stats.per_request)
    pct = lambda p: ttft[min(len(ttft) - 1, math.ceil(p * len(ttft)) - 1)]
    e2e = [r["e2e_latency_s"] for r in stats.per_request]
    log(f"[serve] {len(results)} requests, prompts "
        f"{[int(p.shape[0]) for p in prompts]}, {MAX_NEW} new tokens each")
    log(f"[serve] tokens={stats.total_tokens} wall_s={stats.wall_time_s:.4f} "
        f"tokens_per_s={stats.tokens_per_sec:.2f} "
        f"ttft_p50_s={pct(0.5):.4f} ttft_p99_s={pct(0.99):.4f} "
        f"e2e_max_s={max(e2e):.4f} prefill_s={stats.prefill_time_s:.4f} "
        f"decode_s={stats.decode_time_s:.4f} model_calls={calls[0]} "
        f"kernel_launches={launches} tensor_core_launches={mma} "
        f"max_memory_allocated_gib={peak / 2**30:.3f}")
    log(f"[serve] telemetry: {tel_line(stats)}; spans: "
        f"{len(tracer.traces())} request roots of queued/prefill/decode, "
        f"Chrome export parsed")
    # the spec and handoff phases serve on the same model; tp-serve holds
    # its tokens and its first prefill's logits against this run's
    return dict(launches=launches, model=model, prompts=prompts,
                tokens=[r.tokens for r in results], peak_gib=peak / 2**30,
                logits=first_prefill_logits(model, prompts[0], False))


def ttft_pcts(stats) -> tuple:
    """TTFT p50 and p99 of a run (with 16 requests p99 is the maximum)."""
    ttft = sorted(r["ttft_s"] for r in stats.per_request)
    pct = lambda p: ttft[min(len(ttft) - 1, math.ceil(p * len(ttft)) - 1)]
    return pct(0.5), pct(0.99)


# -------------------------------------------------------------- spec phase
SPEC_DRAFT_LAYERS, SPEC_ROUNDS, SPEC_WITNESS = 8, 4, 8


def early_exit_draft(model, n_layers: int):
    """The target's own first n_layers as a draft (bench.py's early-exit
    draft): the embedding, those blocks, the final norm and the head,
    the same tensors on the card (from_params copies none of them)."""
    from tf_operator_tpu_torch.models import llama

    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    params = {k: v for k, v in model.state_dict().items()
              if not k.startswith("blocks.")
              or int(k.split(".")[1]) < n_layers}
    return llama.Llama.from_params(cfg, params,
                                   device=model.embed.device)


def spec_phase(model, prompts, base_tokens) -> dict:
    """Speculative serving of the serve phase's llama3_8b (bf16, 32
    layers, its seeded weights) and its 16 prompts, 64 new tokens,
    greedy, 8 slots, spec_k = SPEC_K, SPEC_ROUNDS rounds a block; the
    draft is the target's own first 8 layers.  (a) the slot scheduler,
    (b) the continuous one: (b) gives (a)'s tokens.  Then the self-draft
    witness (the target as its own draft, 8 requests): the acceptance
    rate must pass 0.9 (a broken verify reads near 0).  In every run K1
    launches equal target layers x target calls + draft layers x draft
    calls, every one on the tensor cores."""
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    t_phase = time.perf_counter()
    cfg = model.cfg
    draft = early_exit_draft(model, SPEC_DRAFT_LAYERS)
    kw = dict(slots=8, block_size=BS, steps_per_sync=SPEC_ROUNDS,
              spec_k=SPEC_K, device="cuda", return_stats=True)
    # warm-up on two short requests
    serve_loop(model, [p[:64] for p in prompts[:2]], max_new_tokens=8,
               draft=draft, **kw)
    calls = {"target": 0, "draft": 0}
    hooks = [m.register_forward_hook(
        lambda *_, n=name: calls.__setitem__(n, calls[n] + 1))
        for name, m in (("target", model), ("draft", draft))]
    launches = []

    def run(tag, reqs, drafter, **extra):
        calls.update(target=0, draft=0)
        pa.reset_launches()
        torch.cuda.synchronize()
        out, stats = serve_loop(model, reqs, max_new_tokens=MAX_NEW,
                                draft=drafter, **kw, **extra)
        torch.cuda.synchronize()
        # the self-draft's draft calls are the target's module's
        want = (cfg.n_layers * calls["target"]
                + drafter.cfg.n_layers * calls["draft"])
        if pa.launches != want or pa.launches == 0:
            raise AssertionError(
                f"[spec] ({tag}) K1 launched {pa.launches} times for "
                f"{calls} model calls, {want} expected")
        if pa.launches_mma != pa.launches or pa.launches_int8:
            raise AssertionError(
                f"[spec] ({tag}) {pa.launches_mma} of {pa.launches} K1 "
                f"calls on the tensor cores, K1q {pa.launches_int8}")
        for i, r in enumerate(out):
            if len(r.tokens) != MAX_NEW or not all(
                    0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError(f"[spec] ({tag}) request {i}: "
                                     f"{len(r.tokens)} tokens or one out "
                                     f"of vocab")
        launches.append(pa.launches)
        p50, p99 = ttft_pcts(stats)
        log(f"[spec] ({tag}) tokens={stats.total_tokens} "
            f"wall_s={stats.wall_time_s:.4f} "
            f"tokens_per_s={stats.tokens_per_sec:.2f} ttft_p50_s={p50:.4f} "
            f"ttft_p99_s={p99:.4f} prefill_s={stats.prefill_time_s:.4f} "
            f"decode_s={stats.decode_time_s:.4f} "
            f"accepted_drafts={stats.accepted_drafts} "
            f"proposed_drafts={stats.proposed_drafts} "
            f"acceptance_rate={stats.acceptance_rate:.4f} "
            f"wasted_lane_steps={stats.wasted_lane_steps} "
            f"target_calls={calls['target']} draft_calls={calls['draft']} "
            f"kernel_launches={pa.launches} "
            f"tensor_core_launches={pa.launches_mma}")
        log(f"[spec] ({tag}) telemetry: {tel_line(stats)}")
        return out, stats

    slot, st_a = run("a slot", prompts, draft)
    cont, st_b = run("b continuous", prompts, draft, scheduler="continuous")
    for i, (r, w) in enumerate(zip(cont, slot)):
        if r.tokens != w.tokens:
            raise AssertionError(f"[spec] (b) request {i}: {r.tokens} != "
                                 f"(a)'s {w.tokens}")
    same = sum(r.tokens == w for r, w in zip(slot, base_tokens))
    log(f"[spec] llama3_8b target, its first {SPEC_DRAFT_LAYERS} layers as "
        f"the draft, spec_k={SPEC_K}, {SPEC_ROUNDS} rounds a block, "
        f"{len(prompts)} requests x {MAX_NEW} tokens: (b) tokens == (a) "
        f"tokens for all {len(prompts)}; {same} of {len(prompts)} requests "
        f"give the serve phase's non-speculative tokens (informational: "
        f"bf16 at L={SPEC_K + 1} and at L=1 may round differently)")
    hooks[1].remove()
    _, st_w = run("self-draft witness", prompts[:SPEC_WITNESS], model)
    hooks[0].remove()
    if not st_w.acceptance_rate > 0.9:
        raise AssertionError(f"[spec] the self-draft witness accepted "
                             f"{st_w.acceptance_rate} of its drafts")
    log(f"[spec] K1 launches per run (a, b, witness): {launches}, "
        f"{sum(launches)} in all; phase {time.perf_counter() - t_phase:.1f} s")
    del draft
    return dict(launches=sum(launches))


# ------------------------------------------------------------ dense phase
DENSE_BATCH, DENSE_PROMPT, DENSE_CHUNK = 8, 512, 128


def ring_bytes(cfg, lanes: int, slots: int) -> int:
    """Bytes of dense rings (or of a paged pool of `lanes` blocks of
    `slots` positions): K and V of every layer, in cfg.dtype."""
    return (2 * cfg.n_layers * lanes * slots * cfg.n_kv_heads * cfg.head_dim
            * torch.finfo(cfg.dtype).bits // 8)


def dense_phase(model, prompts, paged_tokens) -> None:
    """Dense-ring decoding of the serve phase's llama3_8b (bf16, 32
    layers, its seeded weights): serve_loop(paged=False) over its 16
    prompts, 64 new tokens, 8 lanes, under (a) the slot and (b) the
    continuous scheduler, whose tokens must be equal; how many requests
    give the paged serve phase's tokens is printed (bf16: K1 and the
    dense einsum sum in other orders).  Then generate on a batch of 8
    equal 512-token prompts, one pass and in chunks of 128 (rows that
    agree printed).  Then the self-draft witnesses (the target as its
    own draft, spec_k 4) over that batch: serve_loop(paged=False) and
    speculative_generate in bf16 must accept more than 0.5 (sound runs
    read 0.85-0.90, bf16 near ties flipping between the draft's L=1 and
    the verify's L=5 rounding; a broken verify reads near 0), and
    speculative_generate over the same weights upcast to f32 more than
    0.9 (rounding flips almost no tie there).  No kernel reads a dense
    ring: K1 and K1q are launched 0 times in every run."""
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.models.speculative import speculative_generate

    t_phase = time.perf_counter()
    cfg = model.cfg
    kw = dict(slots=8, steps_per_sync=8, device="cuda", paged=False,
              return_stats=True)
    serve_loop(model, [p[:64] for p in prompts[:2]], max_new_tokens=8, **kw)
    calls = [0]
    hook = model.register_forward_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))

    def no_kernel(tag):
        if pa.launches or pa.launches_int8:
            raise AssertionError(f"[dense] ({tag}) K1 {pa.launches}, K1q "
                                 f"{pa.launches_int8} launches on dense "
                                 f"rings")

    runs = {}
    for tag, sched in (("a slot", "slot"), ("b continuous", "continuous")):
        calls[0] = 0
        pa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, st = serve_loop(model, prompts, max_new_tokens=MAX_NEW,
                             scheduler=sched, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        no_kernel(tag)
        for i, r in enumerate(out):
            if len(r.tokens) != MAX_NEW or not all(
                    0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError(f"[dense] ({tag}) request {i}: "
                                     f"{len(r.tokens)} tokens or one out "
                                     f"of vocab")
        if st.paged or st.kv_blocks_total:
            raise AssertionError(f"[dense] ({tag}) stats say paged")
        p50, p99 = ttft_pcts(st)
        log(f"[dense] ({tag}) tokens={st.total_tokens} "
            f"wall_s={st.wall_time_s:.4f} "
            f"tokens_per_s={st.tokens_per_sec:.2f} ttft_p50_s={p50:.4f} "
            f"ttft_p99_s={p99:.4f} prefill_s={st.prefill_time_s:.4f} "
            f"decode_s={st.decode_time_s:.4f} model_calls={calls[0]} "
            f"kernel_launches=0 max_memory_allocated_gib="
            f"{peak / 2**30:.3f}")
        log(f"[dense] ({tag}) telemetry: {tel_line(st)}")
        runs[sched] = [r.tokens for r in out]
    if runs["slot"] != runs["continuous"]:
        bad = [i for i, (a, b) in enumerate(zip(runs["slot"],
                                                runs["continuous"]))
               if a != b]
        raise AssertionError(f"[dense] (b) continuous tokens differ from "
                             f"(a) slot's at requests {bad}")
    same = sum(a == b for a, b in zip(runs["slot"], paged_tokens))
    longest = max(int(p.shape[0]) for p in prompts)
    c = llama.auto_cache_len(cfg, longest, longest + MAX_NEW)
    pool = 8 * -(-(longest + MAX_NEW) // BS) + 1
    log(f"[dense] {len(prompts)} requests x {MAX_NEW} tokens: (b) tokens "
        f"== (a) tokens for all; {same} of {len(prompts)} requests give "
        f"the paged serve phase's tokens (informational: K1 and the dense "
        f"einsum round bf16 sums in other orders); dense rings 8 lanes x "
        f"{c} slots = {ring_bytes(cfg, 8, c) / 2**30:.4f} GiB, the paged "
        f"pool for the same requests {pool} blocks x {BS} = "
        f"{ring_bytes(cfg, pool, BS) / 2**30:.4f} GiB")

    g = torch.Generator(device="cpu").manual_seed(SEED + 40)
    batch = torch.randint(0, cfg.vocab_size,
                          (DENSE_BATCH, DENSE_PROMPT), generator=g).cuda()
    gen = {}
    for tag, chunk in (("one pass", None), ("chunked", DENSE_CHUNK)):
        calls[0] = 0
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen[tag] = llama.generate(model, batch, MAX_NEW, device="cuda",
                                  prefill_chunk=chunk)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        no_kernel(f"generate {tag}")
        if gen[tag].shape != (DENSE_BATCH, MAX_NEW) or not bool(
                ((gen[tag] >= 0) & (gen[tag] < cfg.vocab_size)).all()):
            raise AssertionError(f"[dense] generate {tag}: shape "
                                 f"{tuple(gen[tag].shape)} or a token out "
                                 f"of vocab")
        log(f"[dense] generate ({tag}) {DENSE_BATCH} x {DENSE_PROMPT} "
            f"prompt tokens + {MAX_NEW} new: wall_s={dt:.4f} "
            f"tokens_per_s={DENSE_BATCH * MAX_NEW / dt:.2f} "
            f"model_calls={calls[0]}")
    rows = int((gen["one pass"] == gen["chunked"]).all(dim=1).sum())
    log(f"[dense] generate: {rows} of {DENSE_BATCH} rows one pass == "
        f"chunked (informational: bf16 segments round differently)")
    hook.remove()

    def witness(tag, reqs, fn):
        """A self-draft run (the target as its own draft, spec_k=SPEC_K):
        its acceptance, launches checked, timed."""
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, acc, prop = fn(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        no_kernel(tag)
        rate = acc / max(prop, 1)
        log(f"[dense] {tag}, the target as its own draft, spec_k={SPEC_K}: "
            f"accepted {acc} of {prop}, acceptance_rate={rate:.4f}, "
            f"wall_s={dt:.4f} tokens_per_s="
            f"{len(reqs) * MAX_NEW / dt:.2f}")
        return out, rate

    def serve_spec(reqs):
        out, st = serve_loop(model, reqs, max_new_tokens=MAX_NEW, draft=model,
                             spec_k=SPEC_K, **dict(kw, steps_per_sync=
                                                   SPEC_ROUNDS))
        return out, st.accepted_drafts, st.proposed_drafts

    def spec_gen(target):
        def fn(batch_):
            out, st = speculative_generate(target, target, batch_, MAX_NEW,
                                           k=SPEC_K, device="cuda",
                                           return_stats=True)
            return out, st["accepted_drafts"], st["proposed_drafts"]
        return fn

    # the self-draft witnesses over the generate batch.  In bf16 the
    # draft's L=1 steps and the verify's L=k+1 pass round near ties apart
    # and reject some drafts (sound runs read 0.85-0.90 here, a broken
    # verify near 0); the same weights in f32 leave almost no tie that
    # rounding flips, so there the rate must pass 0.9
    _, r_serve = witness("serve_loop(paged=False) over the generate batch, "
                         "bf16", list(batch.cpu()), serve_spec)
    spec, r_gen = witness("speculative_generate over the generate batch, "
                          "bf16", batch, spec_gen(model))
    agree = int((spec == gen["one pass"]).all(dim=1).sum())
    log(f"[dense] speculative_generate bf16: {agree} of {DENSE_BATCH} rows "
        f"== generate's (informational: bf16 at L={SPEC_K + 1} and at L=1 "
        f"may round differently)")
    for tag, rate in (("serve_loop", r_serve), ("speculative_generate",
                                                r_gen)):
        if not rate > 0.5:
            raise AssertionError(f"[dense] the bf16 {tag} self-draft "
                                 f"witness accepted {rate} of its drafts")
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = llama.Llama.from_params(
        dataclasses.replace(cfg, dtype=torch.float32),
        {k: v.float() for k, v in model.state_dict().items()}, device="cuda")
    spec32, r32 = witness("speculative_generate over the generate batch, "
                          "f32 (the same weights upcast)", batch,
                          spec_gen(f32))
    gen32 = llama.generate(f32, batch, MAX_NEW, device="cuda")
    agree32 = int((spec32 == gen32).all(dim=1).sum())
    del f32
    torch.cuda.empty_cache()
    log(f"[dense] speculative_generate f32: {agree32} of {DENSE_BATCH} rows "
        f"== f32 generate's; acceptance bf16 {r_gen:.4f} -> f32 {r32:.4f} "
        f"on the same batch and weights")
    if not r32 > 0.9:
        raise AssertionError(f"[dense] the f32 speculative_generate "
                             f"self-draft witness accepted {r32} of its "
                             f"drafts")
    log(f"[dense] phase {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()


# ------------------------------------------------------ dense-parity phase
def dense_parity_phase() -> None:
    """Full width, 2 layers, f32 (TF32 off): dense decoding on the card
    gives the CPU's tokens: generate one pass and chunked;
    speculative_generate with the target as its own draft, and over a
    windowed ring smaller than the sequence (window 32, ring 40, chunk
    8: the verify's write wraps); serve_loop(paged=False) under both
    schedulers (schedules too), over an unaligned prefix, with
    speculation (a 1-layer draft), and with int8 weights and KV over the
    spec-parity phase's int8 requests; and on the card, dense serving
    gives paged serving's tokens."""
    from tf_operator_tpu_torch.models import bridge, llama, quant
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.models.speculative import speculative_generate

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.llama3_8b(n_layers=2, dtype=torch.float32)
    wcfg = llama.llama3_8b(n_layers=2, dtype=torch.float32,
                           sliding_window=32, max_len=512)
    dcfg = llama.llama3_8b(n_layers=1, dtype=torch.float32)

    def both(params, c):
        return (llama.Llama.from_params(c, params, device="cuda"),
                llama.Llama.from_params(
                    c, {k: v.to("cpu") for k, v in params.items()},
                    device="cpu"))

    def same(tag, fn):
        """fn(model index, device) on the card and the CPU: equal."""
        t0 = time.perf_counter()
        got = fn(0, "cuda")
        t1 = time.perf_counter()
        want = fn(1, "cpu")
        t2 = time.perf_counter()
        if got != want:
            raise AssertionError(f"[dense-parity] ({tag}) cuda {got} != "
                                 f"cpu {want}")
        log(f"[dense-parity] ({tag}) identical on cuda and cpu; cuda "
            f"{t1 - t0:.1f} s, cpu {t2 - t1:.1f} s")
        return got

    params = bridge.init_params(cfg, SEED + 41, device="cuda")
    m = both(params, cfg)
    w = both(params, wcfg)   # the same weights under a window of 32
    del params
    d = both(bridge.init_params(dcfg, SEED + 42, device="cuda"), dcfg)
    pa.reset_launches()
    g = torch.Generator(device="cpu").manual_seed(SEED + 43)
    batch = torch.randint(0, cfg.vocab_size, (2, 48), generator=g)
    toks = lambda t: t.cpu().tolist()
    same("generate one pass", lambda i, dev: toks(llama.generate(
        m[i], batch, 8, device=dev)))
    same("generate chunked", lambda i, dev: toks(llama.generate(
        m[i], batch, 8, device=dev, prefill_chunk=16)))
    same("speculative_generate, self-draft", lambda i, dev: toks(
        speculative_generate(m[i], m[i], batch, 8, k=3, device=dev)))
    ring = dict(cache_len=40, prefill_chunk=8)
    wrapped = same("speculative_generate, window 32 over a 40-slot ring",
                   lambda i, dev: toks(speculative_generate(
                       w[i], w[i], batch, 8, k=3, device=dev,
                       draft_cache_len=40, **ring)))
    if wrapped != toks(llama.generate(w[0], batch, 8, device="cuda",
                                      **ring)):
        raise AssertionError("[dense-parity] windowed speculation differs "
                             "from generate on the card")
    reqs = prompts_for(cfg, 4, 24, 96, SEED + 44)
    pfx = prompts_for(cfg, 1, 40, 40, SEED + 45)[0]
    sufs = prompts_for(cfg, 4, 8, 40, SEED + 46)
    kw = dict(slots=2, max_new_tokens=[6, 12, 8, 10], steps_per_sync=4,
              paged=False)
    sched = lambda rs: [(r.tokens, r.admitted_at_step, r.finished_at_step,
                         r.slot, r.accepted_drafts, r.proposed_drafts)
                        for r in rs]
    slot = same("serve slot", lambda i, dev: sched(serve_loop(
        m[i], reqs, device=dev, **kw)))
    same("serve continuous", lambda i, dev: sched(serve_loop(
        m[i], reqs, device=dev, scheduler="continuous", **kw)))
    same("serve prefix", lambda i, dev: sched(serve_loop(
        m[i], sufs, device=dev, shared_prefix=pfx, **kw)))
    same("serve speculative", lambda i, dev: sched(serve_loop(
        m[i], reqs, device=dev, draft=d[i], spec_k=3, **kw)))
    if pa.launches or pa.launches_int8:
        raise AssertionError("[dense-parity] a kernel read a dense ring")
    paged = serve_loop(m[0], reqs, device="cuda", block_size=BS,
                       **{k: v for k, v in kw.items() if k != "paged"})
    if [r.tokens for r in paged] != [t[0] for t in slot]:
        raise AssertionError("[dense-parity] dense tokens on the card "
                             "differ from paged tokens")
    paged_k1 = pa.launches
    del m, w, d
    torch.cuda.empty_cache()
    # int8 weights and KV over the spec-parity phase's int8 requests
    q = both(int8_params(cfg, SEED + 7), cfg)
    dq = quant.make_dequantizer(torch.float32)
    pa.reset_launches()
    same("serve int8 weights and KV", lambda i, dev: sched(serve_loop(
        q[i], prompts_for(cfg, 4, 24, 96, SEED + 3)[:2], device=dev,
        scheduler="continuous", kv_quant=True, prefill_chunk=32,
        params_transform=dq, slots=2, max_new_tokens=[4, 8],
        steps_per_sync=4, paged=False)))
    if pa.launches or pa.launches_int8:
        raise AssertionError("[dense-parity] a kernel read a dense ring")
    del q
    torch.cuda.empty_cache()
    log(f"[dense-parity] 2 layers f32: every run identical on cuda and "
        f"cpu, no kernel launched on a dense ring; dense == paged tokens "
        f"on cuda (the paged run: {paged_k1} K1 launches); phase "
        f"{time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------- spec-parity phase
def int8_tie_witness(models, prompt) -> None:
    """Informational: one prefill of `prompt` by an int8-weight model on
    the card and on the CPU, with int8 and with f32 KV: the int8 KV
    values that differ between the two devices, the largest logit
    difference, and each device's top two tokens and logits (a greedy
    choice whose top two lie closer than that difference can differ)."""
    from tf_operator_tpu_torch.models import paging

    for kv_quant in (True, False):
        res = []
        for m in models:
            dev = m.embed.device
            n = paging.blocks_for(int(prompt.shape[0]), BS)
            cache = paging.init_block_pool(m.cfg, n, BS, device=dev,
                                           kv_quant=kv_quant)
            table = torch.arange(1, n + 1, dtype=torch.int32,
                                 device=dev)[None]
            with torch.inference_mode():
                lg = m(prompt[None].to(dev), cache, 0, table)[0, -1]
            res.append((lg.float().cpu(), [t.cpu() for t in
                                           paging._leaves(cache)]))
        (lg_g, pool_g), (lg_c, pool_c) = res
        flips = (sum(int((a != b).sum()) for a, b in zip(pool_g, pool_c)
                     if a.dtype == torch.int8) if kv_quant else 0)
        top = [torch.topk(lg, 2) for lg in (lg_g, lg_c)]
        log(f"[spec-parity] int8 weights, {'int8' if kv_quant else 'f32'} "
            f"KV, one {int(prompt.shape[0])}-token prefill: int8 KV values "
            f"differing cuda/cpu {flips}; max logit diff "
            f"{float((lg_g - lg_c).abs().max()):.3e}; top two cuda "
            f"{top[0].indices.tolist()} {top[0].values.tolist()}, cpu "
            f"{top[1].indices.tolist()} {top[1].values.tolist()}")


def spec_parity_phase() -> dict:
    """Full width, 2 layers, f32 (TF32 off), a 1-layer draft from another
    seed, spec_k 3: the card's greedy tokens, schedule and per-request
    accepted/proposed drafts equal the CPU's under both schedulers, over
    an unaligned shared prefix (a CoW block in both pools), with the
    target as its own draft (rounds that accept), and with int8 weights
    and KV and an int8 draft through draft_transform (K1q; over the
    parity-int8 phase's target, first two requests and chunking); the card's
    speculative tokens equal its non-speculative ones.  Then
    int8_tie_witness, informational."""
    from tf_operator_tpu_torch.models import bridge, llama, quant
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.llama3_8b(n_layers=2, dtype=torch.float32)
    dcfg = llama.llama3_8b(n_layers=1, dtype=torch.float32)

    def both(params, c):
        on_card = llama.Llama.from_params(c, params, device="cuda")
        on_cpu = llama.Llama.from_params(
            c, {k: v.to("cpu") for k, v in params.items()}, device="cpu")
        return on_card, on_cpu

    m_gpu, m_cpu = both(bridge.init_params(cfg, SEED + 31, device="cuda"),
                        cfg)
    d_gpu, d_cpu = both(bridge.init_params(dcfg, SEED + 32, device="cuda"),
                        dcfg)
    prompts = prompts_for(cfg, 4, 24, 96, SEED + 33)
    pfx = prompts_for(cfg, 1, 40, 40, SEED + 34)[0]
    sufs = prompts_for(cfg, 4, 8, 40, SEED + 35)
    kw = dict(slots=2, max_new_tokens=[6, 16, 10, 12], block_size=BS,
              steps_per_sync=2, spec_k=3)
    sched = lambda rs: [(r.tokens, r.admitted_at_step, r.finished_at_step,
                         r.slot, r.accepted_drafts, r.proposed_drafts,
                         r.kv_blocks) for r in rs]
    out = {}

    def check(tag, models, reqs, **extra):
        (tg, dg), (tc, dc) = models
        run_kw = dict(kw, **extra)
        pa.reset_launches()
        t0 = time.perf_counter()
        got = serve_loop(tg, reqs, device="cuda", draft=dg, **run_kw)
        torch.cuda.synchronize()
        n_k1, n_k1q = pa.launches, pa.launches_int8
        t1 = time.perf_counter()
        want = serve_loop(tc, reqs, device="cpu", draft=dc, **run_kw)
        t2 = time.perf_counter()
        if sched(got) != sched(want):
            raise AssertionError(f"[spec-parity] ({tag}) cuda {sched(got)} "
                                 f"!= cpu {sched(want)}")
        acc = [(r.accepted_drafts, r.proposed_drafts) for r in got]
        log(f"[spec-parity] ({tag}) tokens, schedule and drafts identical "
            f"on cuda and cpu: accepted/proposed {acc}; K1 launches {n_k1}, "
            f"K1q {n_k1q}; cuda {t1 - t0:.1f} s, cpu {t2 - t1:.1f} s")
        out[tag] = (got, n_k1, n_k1q)
        return got

    pair = ((m_gpu, d_gpu), (m_cpu, d_cpu))
    slot = check("slot", pair, prompts)
    check("continuous", pair, prompts, scheduler="continuous")
    check("prefix", pair, sufs, shared_prefix=pfx)
    plain = serve_loop(m_gpu, prompts, device="cuda",
                       **{k: v for k, v in kw.items() if k != "spec_k"})
    if [r.tokens for r in slot] != [r.tokens for r in plain]:
        raise AssertionError("[spec-parity] speculative tokens on the card "
                             "differ from its non-speculative tokens")
    # the target as its own draft: rounds that accept (a random draft,
    # or the first layer of random weights at this width, accepts none)
    got = check("self-draft", ((m_gpu, m_gpu), (m_cpu, m_cpu)), prompts)
    if sum(r.accepted_drafts for r in got) == 0:
        raise AssertionError("[spec-parity] the self-draft accepted "
                             "nothing")
    del m_gpu, m_cpu, d_gpu, d_cpu, pair
    torch.cuda.empty_cache()
    # int8 weights and KV, an int8 draft (K1q at the verify shape), over
    # the parity-int8 phase's target, first two requests and chunking:
    # int8 KV turns last-bit f32 differences into flipped int8 values,
    # so card = CPU holds only where no greedy choice is a near tie (the
    # witness below measures how near).  Two requests and short budgets:
    # the CPU dequantizes each int8 weight, the 0.5 G-element lm_head
    # included, at every model call, four calls a round
    q_pair = list(zip(both(int8_params(cfg, SEED + 7), cfg),
                      both(int8_params(dcfg, SEED + 37), dcfg)))
    dq = quant.make_dequantizer(torch.float32)
    check("int8", q_pair, prompts_for(cfg, 4, 24, 96, SEED + 3)[:2],
          scheduler="continuous", kv_quant=True, prefill_chunk=32,
          max_new_tokens=[4, 8], params_transform=dq, draft_transform=dq)
    if out["int8"][1] or not out["int8"][2]:
        raise AssertionError(f"[spec-parity] int8 KV: K1 {out['int8'][1]}, "
                             f"K1q {out['int8'][2]}")
    del q_pair
    int8_tie_witness(both(int8_params(cfg, SEED + 36), cfg), prompts[0])
    log(f"[spec-parity] 2 layers f32: every run identical on cuda and cpu; "
        f"speculative == non-speculative tokens on cuda; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return dict(launches_int8=out["int8"][2])


# ----------------------------------------------------------- handoff phase
@contextlib.contextmanager
def handoff_timers():
    """Host seconds spent inside paging.export_blocks (the device gather,
    the copy to the host and the hashing), inside its hashing
    (paging._hash_block) and inside paging.adopt_blocks (the upload and
    the scatter), while the block is open: each is wrapped by a timer
    and put back on exit."""
    from tf_operator_tpu_torch.models import paging

    names = ("export_blocks", "_hash_block", "adopt_blocks")
    originals = {name: getattr(paging, name) for name in names}
    spent = dict.fromkeys(names, 0.0)

    def timed(name):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return originals[name](*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapper

    for name in names:
        setattr(paging, name, timed(name))
    try:
        yield spent
    finally:
        for name, fn in originals.items():
            setattr(paging, name, fn)


def handoff_phase(model) -> None:
    """The serve phase's llama3_8b over one shared 1000-token prefix and
    16 suffixes of 32-256 tokens, 64 new tokens each, greedy, 8 slots:
    (a) unified under the slot scheduler, (b) prefill_only, (c) the
    decode side adopting (b)'s handoffs under the slot scheduler and (d)
    under the continuous one.  Gates: (c) and (d) give (a)'s tokens; CoW
    and prefix reuse happen; the prefix crosses the wire once; every K1
    launch is on the tensor cores.  Then export_blocks and adopt_blocks
    timed alone for one 79-block lane at llama3_8b's block shape."""
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models import paging
    from tf_operator_tpu_torch.models.serving import serve_loop

    cfg = model.cfg
    prefix = prompts_for(cfg, 1, PREFIX_LEN, PREFIX_LEN, SEED + 11)[0]
    sufs = prompts_for(cfg, 16, 32, SUFFIX_MAX, SEED + 12)
    full = [torch.cat([prefix, x]) for x in sufs]
    kw = dict(slots=8, block_size=BS, steps_per_sync=8,
              max_new_tokens=MAX_NEW, device="cuda", return_stats=True)
    calls = [0]
    hook = model.register_forward_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))

    def run(tag, prompts, **extra):
        calls[0] = 0
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with handoff_timers() as spent:
            out, stats = serve_loop(model, prompts, **kw, **extra)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if pa.launches != cfg.n_layers * calls[0] or pa.launches == 0:
            raise AssertionError(
                f"[handoff] ({tag}) K1 launched {pa.launches} times for "
                f"{calls[0]} model calls x {cfg.n_layers} layers")
        if pa.launches_mma != pa.launches:
            raise AssertionError(
                f"[handoff] ({tag}) {pa.launches_mma} of {pa.launches} K1 "
                f"calls took the tensor-core design")
        log(f"[handoff] ({tag}) wall_s={wall:.4f} model_calls={calls[0]} "
            f"kernel_launches={pa.launches} "
            f"tensor_core_launches={pa.launches_mma} "
            f"in_export_blocks_s={spent['export_blocks']:.4f} "
            f"of_it_hashing_s={spent['_hash_block']:.4f} "
            f"in_adopt_blocks_s={spent['adopt_blocks']:.4f} shares: "
            f"export/wall={spent['export_blocks'] / wall:.3f} "
            f"hashing/export="
            f"{spent['_hash_block'] / max(spent['export_blocks'], 1e-9):.3f}"
            f" adopt/wall={spent['adopt_blocks'] / wall:.3f}")
        return out, stats, wall

    uni, st_a, _ = run("a", sufs, shared_prefix=prefix)
    hand, st_b, wall_b = run("b", sufs, shared_prefix=prefix,
                             prefill_only=True)
    slot, st_c, _ = run("c", full, adopt=hand)
    cont, st_d, _ = run("d", full, adopt=hand, scheduler="continuous")
    hook.remove()

    want = [r.tokens for r in uni]
    for tag, res in (("c", slot), ("d", cont)):
        for i, (r, w) in enumerate(zip(res, want)):
            if r.tokens != w:
                raise AssertionError(
                    f"[handoff] ({tag}) request {i}: {r.tokens} != the "
                    f"unified run's {w}")
    n_shared = PREFIX_LEN // BS
    if not (st_a.cow_copies == st_b.cow_copies == len(sufs)
            and st_a.prefix_block_hits > 0 and st_c.prefix_block_hits > 0):
        raise AssertionError(
            f"[handoff] cow_copies (a) {st_a.cow_copies} (b) "
            f"{st_b.cow_copies}, prefix_block_hits (a) "
            f"{st_a.prefix_block_hits} (c) {st_c.prefix_block_hits}")
    exports = [h.export for h in hand]
    pfx_hashes = exports[0].hashes[:n_shared]
    if not (all(e.shared[:n_shared] == [True] * n_shared for e in exports)
            and all(h in exports[0].payload for h in pfx_hashes)
            and not any(h in e.payload for e in exports[1:]
                        for h in e.hashes[:n_shared])
            and all(e.hashes[:n_shared] == pfx_hashes for e in exports)):
        raise AssertionError("[handoff] the prefix's payload did not cross "
                             "the wire exactly once")
    live = sum(1 for h in hand if not h.completed)
    if not (st_b.handoff_exports == st_c.handoff_adoptions
            == st_d.handoff_adoptions == live):
        raise AssertionError(
            f"[handoff] exports {st_b.handoff_exports}, adoptions "
            f"{st_c.handoff_adoptions} / {st_d.handoff_adoptions}, "
            f"handoffs to adopt {live}")
    blocks = sum(len(e) for e in exports)
    payload = sum(e.payload_blocks() for e in exports)
    wire = sum(e.nbytes() for e in exports)
    log(f"[handoff] llama3_8b, shared prefix {PREFIX_LEN} tokens "
        f"({n_shared} shared blocks + a CoW block), {len(sufs)} suffixes "
        f"{[int(x.shape[0]) for x in sufs]}, {MAX_NEW} new tokens each, "
        f"8 slots; (c) and (d) tokens == (a) tokens for all {len(sufs)}")
    for tag, st in (("a", st_a), ("c", st_c), ("d", st_d)):
        p50, p99 = ttft_pcts(st)
        log(f"[handoff] ({tag}) tokens={st.total_tokens} "
            f"wall_s={st.wall_time_s:.4f} "
            f"tokens_per_s={st.tokens_per_sec:.2f} ttft_p50_s={p50:.4f} "
            f"ttft_p99_s={p99:.4f} prefill_s={st.prefill_time_s:.4f} "
            f"decode_s={st.decode_time_s:.4f} "
            f"cow_copies={st.cow_copies} "
            f"prefix_block_hits={st.prefix_block_hits} "
            f"handoff_adoptions={st.handoff_adoptions} "
            f"kv_blocks_peak_used={st.kv_blocks_peak_used} "
            f"preemptions={st.preemptions}")
        log(f"[handoff] ({tag}) telemetry: {tel_line(st)}")
    log(f"[handoff] (b) prefill_only wall_s={wall_b:.4f} "
        f"handoff_exports={st_b.handoff_exports} "
        f"cow_copies={st_b.cow_copies}; exported_blocks={blocks} "
        f"payload_blocks={payload} wire_bytes={wire} "
        f"({wire / 2**30:.3f} GiB; {wire / max(payload, 1)} bytes a block)")
    del uni, hand, slot, cont

    # export and adoption alone: one 79-block lane (a 1256-token prompt)
    n_blk = 79
    src = paging.init_block_pool(cfg, n_blk, BS, device="cuda")
    dst = paging.init_block_pool(cfg, n_blk, BS, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for t in paging._leaves(src):
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    ids = list(range(1, n_blk + 1))
    times = {"export_blocks": [], "_hash_block": [], "adopt_blocks": []}
    for _ in range(3):
        # the export ends in its copy to the host, a device sync
        with handoff_timers() as spent:
            exp = paging.export_blocks(src, ids, [False] * n_blk, BS)
        times["export_blocks"].append(spent["export_blocks"])
        times["_hash_block"].append(spent["_hash_block"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paging.adopt_blocks(dst, paging.BlockPool(n_blk, BS), exp)
        torch.cuda.synchronize()
        times["adopt_blocks"].append(time.perf_counter() - t0)
    for a, b in zip(paging._leaves(src), paging._leaves(dst)):
        if not torch.equal(a[1:], b[1:]):
            raise AssertionError("[handoff] adopted blocks differ from the "
                                 "exported ones")
    nbytes = exp.nbytes()
    med = {k: sorted(v)[1] for k, v in times.items()}
    share = [h / e for h, e in zip(times["_hash_block"],
                                   times["export_blocks"])]
    log(f"[handoff] export_blocks alone, {n_blk} blocks of "
        f"{nbytes // n_blk} bytes ({nbytes} bytes): "
        f"s={[round(x, 4) for x in times['export_blocks']]} median "
        f"{med['export_blocks']:.4f} s, "
        f"{nbytes / med['export_blocks'] / 1e9:.3f} GB/s; hashing inside "
        f"it s={[round(x, 4) for x in times['_hash_block']]}, share of "
        f"the export {[round(x, 3) for x in share]}")
    log(f"[handoff] adopt_blocks alone, same lane: "
        f"s={[round(x, 4) for x in times['adopt_blocks']]} median "
        f"{med['adopt_blocks']:.4f} s, "
        f"{nbytes / med['adopt_blocks'] / 1e9:.3f} GB/s")
    del src, dst, exp, model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ parity phase
def parity_phase() -> None:
    from tf_operator_tpu_torch.models import bridge, llama, paging
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.llama3_8b(n_layers=2, dtype=torch.float32)
    params = bridge.init_params(cfg, SEED + 2, device="cuda")
    m_gpu = llama.Llama.from_params(cfg, params, device="cuda")
    m_cpu = llama.Llama.from_params(
        cfg, {k: v.cpu() for k, v in params.items()}, device="cpu")
    del params
    prompts = prompts_for(cfg, 4, 24, 96, SEED + 3)
    kw = dict(slots=2, max_new_tokens=16, block_size=BS, steps_per_sync=8)
    got = serve_loop(m_gpu, prompts, device="cuda", **kw)
    want = serve_loop(m_cpu, prompts, device="cpu", **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        log(f"[parity] request {i}: cuda {g.tokens}")
        if g.tokens != w.tokens:
            raise AssertionError(
                f"[parity] request {i}: cuda tokens {g.tokens} != cpu "
                f"tokens {w.tokens}")
    # logits of one prefill on both devices: finite, same shape, close
    # (f32, TF32 off; only the summation order differs)
    tok = prompts[0][None, :32]
    out = []
    for m, dev in ((m_gpu, "cuda"), (m_cpu, "cpu")):
        cache = paging.init_block_pool(cfg, 2, BS, device=dev)
        table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            out.append(m(tok.to(dev), cache, 0, table).float().cpu())
    diff = float((out[0] - out[1]).abs().max())
    log(f"[parity] {len(prompts)} requests x 16 greedy tokens identical "
        f"on cuda and cpu; prefill logits {tuple(out[0].shape)} "
        f"max_abs_diff={diff:.3e} (atol 1e-3)")
    if not (torch.isfinite(out[0]).all() and diff <= 1e-3):
        raise AssertionError(f"[parity] logits differ by {diff}")

    # the handoff over int8 KV (K1q) and an unaligned prefix (40 % 16: a
    # CoW block): exported on the card, adopted on the card and on the
    # CPU, under both schedulers, against the CPU's unified run
    pfx = prompts_for(cfg, 1, 40, 40, SEED + 13)[0]
    sufs = prompts_for(cfg, 4, 8, 40, SEED + 14)
    full = [torch.cat([pfx, x]) for x in sufs]
    hkw = dict(slots=2, max_new_tokens=16, block_size=BS, steps_per_sync=8,
               kv_quant=True)
    want = [r.tokens for r in serve_loop(m_cpu, sufs, device="cpu",
                                         shared_prefix=pfx, **hkw)]
    pa.reset_launches()
    hand, st = serve_loop(m_gpu, sufs, device="cuda", shared_prefix=pfx,
                          prefill_only=True, return_stats=True, **hkw)
    if not (st.cow_copies == len(sufs) and pa.launches_int8 > 0
            and pa.launches == 0):
        raise AssertionError(
            f"[parity] handoff prefill: cow_copies {st.cow_copies}, K1q "
            f"launches {pa.launches_int8}, K1 launches {pa.launches}")
    if not all(h.export.payload_blocks() < len(h.export) for h in hand[1:]):
        raise AssertionError("[parity] a later export shipped the prefix "
                             "again")
    for m, dev in ((m_gpu, "cuda"), (m_cpu, "cpu")):
        for sched in ("slot", "continuous"):
            got = [r.tokens for r in serve_loop(
                m, full, device=dev, adopt=hand, scheduler=sched, **hkw)]
            if got != want:
                raise AssertionError(
                    f"[parity] handoff adopted on {dev} ({sched}): {got} "
                    f"!= the cpu's unified tokens {want}")
    log(f"[parity] handoff, int8 KV, prefix {int(pfx.shape[0])} tokens: "
        f"{len(sufs)} exports made on cuda ({st.handoff_exports} exports, "
        f"payload blocks {[h.export.payload_blocks() for h in hand]} of "
        f"{[len(h.export) for h in hand]}), adopted on cuda and cpu under "
        f"slot and continuous: tokens identical to the cpu's unified run")


# ------------------------------------------------------------ window phase
# mistral_7b's serving: a 1024-token shared prefix (64 whole blocks, two
# chunks), 16 suffixes of 1024-6656 tokens (full prompts 2048-7680), 128
# new tokens, prefill_chunk 512: a ring of bucket(4096 + 512) = 4608
# positions, 288 slots of 16
WIN_PREFIX, WIN_SUFFIX, WIN_NEW, WIN_CHUNK = 1024, (1024, 6656), 128, 512
WIN_REQUESTS = 16


@contextlib.contextmanager
def window_tally():
    """While the block is open: the shared slots the rings swapped for a
    shadow (`swaps`) and how many of those first copied the shared block
    (`copies`), counted in paging.WindowRotation.advance, and the
    BlockPool of each serve_loop call (`pools`), so a run's end state can
    be read."""
    from tf_operator_tpu_torch.models import paging

    tally = {"swaps": 0, "copies": 0, "pools": []}
    advance, pool_cls = paging.WindowRotation.advance, paging.BlockPool

    def counted(self, upto_pos, q_min):
        edits, released, evicted = advance(self, upto_pos, q_min)
        tally["swaps"] += len(edits)
        tally["copies"] += sum(c is not None for _, _, c in edits)
        return edits, released, evicted

    class Recorded(pool_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            tally["pools"].append(self)

    paging.WindowRotation.advance = counted
    paging.BlockPool = Recorded
    try:
        yield tally
    finally:
        paging.WindowRotation.advance = advance
        paging.BlockPool = pool_cls


def window_phase() -> dict:
    """mistral_7b at full width and depth (bf16, lm_head f32, random
    weights from seed 0) over a 1024-token shared prefix and 16 suffixes
    streamed through its 288-slot ring, 128 new tokens, greedy, 8 slots:
    (a) the slot scheduler, (b) the continuous one, (c) the windowed
    handoff of the first 8 requests (prefill_only under the slot
    scheduler, adopt under the continuous one).  Gates: (b) gives (a)'s
    tokens and (c) (a)'s first 8; every run's rings wrap; prefix blocks
    are shared and rotated out; each run leaves the pool holding the
    prefix's blocks alone; K1 launches equal layers x model calls, all
    on the tensor cores, and K1q is never launched."""
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    torch.cuda.empty_cache()
    cfg = llama.mistral_7b()
    t0 = time.perf_counter()
    model = llama.Llama.from_params(
        cfg, bridge.init_params(cfg, SEED, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    log(f"[window] mistral_7b {cfg.n_layers} layers d_model={cfg.d_model} "
        f"vocab={cfg.vocab_size} window={cfg.sliding_window} {cfg.dtype}: "
        f"random weights in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prefix = prompts_for(cfg, 1, WIN_PREFIX, WIN_PREFIX, SEED + 21)[0]
    sufs = prompts_for(cfg, WIN_REQUESTS, *WIN_SUFFIX, SEED + 22)
    full = [torch.cat([prefix, x]) for x in sufs]
    n_pfx = WIN_PREFIX // BS
    kw = dict(slots=8, block_size=BS, steps_per_sync=8,
              prefill_chunk=WIN_CHUNK, max_new_tokens=WIN_NEW,
              device="cuda", return_stats=True)
    # warm-up: one request that streams past the ring and wraps
    serve_loop(model, [full[0][:4700]], **dict(kw, max_new_tokens=8,
                                               slots=1))
    calls = [0]
    hook = model.register_forward_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))
    launches = []

    def run(tag, prompts, pool_left, **extra):
        calls[0] = 0
        pa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with window_tally() as tally, handoff_timers() as spent:
            out, stats = serve_loop(model, prompts, **kw, **extra)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if pa.launches != cfg.n_layers * calls[0] or pa.launches == 0:
            raise AssertionError(
                f"[window] ({tag}) K1 launched {pa.launches} times for "
                f"{calls[0]} model calls x {cfg.n_layers} layers")
        if pa.launches_mma != pa.launches or pa.launches_int8:
            raise AssertionError(
                f"[window] ({tag}) {pa.launches_mma} of {pa.launches} K1 "
                f"calls on the tensor cores, K1q {pa.launches_int8}")
        if stats.window_evicted_blocks == 0 or tally["swaps"] == 0:
            raise AssertionError(
                f"[window] ({tag}) the rings did not wrap onto the prefix: "
                f"{stats.window_evicted_blocks} evictions, "
                f"{tally['swaps']} shared slots swapped")
        launches.append(pa.launches)
        [pool] = tally["pools"]
        if pool.used != pool_left:
            raise AssertionError(
                f"[window] ({tag}) the pool holds {pool.used} blocks after "
                f"the run, not {pool_left}")
        log(f"[window] ({tag}) wall_s={wall:.4f} model_calls={calls[0]} "
            f"kernel_launches={pa.launches} "
            f"tensor_core_launches={pa.launches_mma} "
            f"window_evicted_blocks={stats.window_evicted_blocks} "
            f"shared_slots_swapped={tally['swaps']} "
            f"rotation_copies={tally['copies']} "
            f"kv_blocks_total={stats.kv_blocks_total} "
            f"kv_blocks_peak_used={stats.kv_blocks_peak_used} "
            f"prefix_block_hits={stats.prefix_block_hits} "
            f"cow_copies={stats.cow_copies} "
            f"in_export_blocks_s={spent['export_blocks']:.4f} "
            f"of_it_hashing_s={spent['_hash_block']:.4f} "
            f"in_adopt_blocks_s={spent['adopt_blocks']:.4f} "
            f"max_memory_allocated_gib={peak / 2**30:.3f}")
        return out, stats

    uni, st_a = run("a", sufs, n_pfx, shared_prefix=prefix)
    cont, st_b = run("b", sufs, n_pfx, shared_prefix=prefix,
                     scheduler="continuous")
    hand, st_p = run("c prefill", sufs[:8], n_pfx, shared_prefix=prefix,
                     prefill_only=True)
    dec, st_c = run("c decode", full[:8], 0, adopt=hand,
                    scheduler="continuous")
    hook.remove()
    want = [r.tokens for r in uni]
    for tag, res in (("b", cont), ("c", dec)):
        for i, r in enumerate(res):
            if r.tokens != want[i]:
                raise AssertionError(
                    f"[window] ({tag}) request {i}: {r.tokens} != (a)'s "
                    f"{want[i]}")
    for i, r in enumerate(uni):
        if len(r.tokens) != WIN_NEW or not all(0 <= t < cfg.vocab_size
                                               for t in r.tokens):
            raise AssertionError(f"[window] request {i}: {len(r.tokens)} "
                                 f"tokens or one out of vocab")
    if not (st_a.prefix_block_hits == st_b.prefix_block_hits
            == n_pfx * WIN_REQUESTS and st_c.prefix_block_hits > 0):
        raise AssertionError(
            f"[window] prefix_block_hits (a) {st_a.prefix_block_hits} (b) "
            f"{st_b.prefix_block_hits} (c) {st_c.prefix_block_hits}")
    wins = [h.export.window for h in hand]
    if not all(w["ring"] == 288 for w in wins):
        raise AssertionError(f"[window] rings {[w['ring'] for w in wins]}")
    log(f"[window] mistral_7b, shared prefix {WIN_PREFIX} tokens "
        f"({n_pfx} shared blocks), {WIN_REQUESTS} suffixes, full prompts "
        f"{[int(x.shape[0]) for x in full]}, {WIN_NEW} new tokens each, "
        f"8 slots, prefill_chunk {WIN_CHUNK}, ring {wins[0]['ring']} slots "
        f"of {BS}: (b) tokens == (a) tokens for all {WIN_REQUESTS}, (c) "
        f"== (a) for its 8")
    for tag, st in (("a", st_a), ("b", st_b), ("c decode", st_c)):
        p50, p99 = ttft_pcts(st)
        log(f"[window] ({tag}) tokens={st.total_tokens} "
            f"wall_s={st.wall_time_s:.4f} "
            f"tokens_per_s={st.tokens_per_sec:.2f} ttft_p50_s={p50:.4f} "
            f"ttft_p99_s={p99:.4f} prefill_s={st.prefill_time_s:.4f} "
            f"decode_s={st.decode_time_s:.4f} "
            f"fused_prefill_tokens={st.fused_prefill_tokens} "
            f"handoff_adoptions={st.handoff_adoptions}")
        log(f"[window] ({tag}) telemetry: {tel_line(st)}")
    log(f"[window] (c prefill) handoff_exports={st_p.handoff_exports} "
        f"exported_blocks={sum(len(h.export) for h in hand)} "
        f"payload_blocks={sum(h.export.payload_blocks() for h in hand)} "
        f"wire_bytes={sum(h.export.nbytes() for h in hand)} next_block="
        f"{[w['next_block'] for w in wins]} shared_slots_left="
        f"{[len(w['shared_slots']) for w in wins]}")
    log(f"[window] K1 launches per run (a, b, c prefill, c decode): "
        f"{launches}, {sum(launches)} in all")
    del uni, cont, hand, dec, model
    torch.cuda.empty_cache()
    return dict(launches=sum(launches))


# ----------------------------------------------------- window-parity phase
def window_parity_phase() -> dict:
    """mistral_7b at full width, 2 layers, f32 (TF32 off), window 64 and
    max_len 512 so the ring (128 positions) wraps at lengths the CPU can
    serve: greedy tokens and schedule on the card (K1) equal the CPU's
    (plain) for prompts streaming past the ring over a shared prefix,
    under both schedulers; over an unaligned prefix and window 120 (the
    rotation copies shared blocks, the boundary is copied on write); with
    int8 KV (K1q); and a windowed int8-KV handoff exported on the card and
    adopted on the card and on the CPU gives the CPU's unified tokens."""
    import dataclasses

    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.mistral_7b(n_layers=2, sliding_window=64, max_len=512,
                           dtype=torch.float32)
    cfg120 = dataclasses.replace(cfg, sliding_window=120)
    params = bridge.init_params(cfg, SEED + 23, device="cuda")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    models = {(w, dev): llama.Llama.from_params(c, p, device=dev)
              for w, c in ((64, cfg), (120, cfg120))
              for dev, p in (("cuda", params), ("cpu", cpu_params))}
    del params, cpu_params
    sched = lambda rs: [(r.tokens, r.admitted_at_step, r.finished_at_step,
                         r.slot, r.kv_blocks) for r in rs]
    pfx = prompts_for(cfg, 1, 32, 32, SEED + 24)[0]
    sufs = prompts_for(cfg, 4, 110, 200, SEED + 25)
    base = dict(slots=2, block_size=BS, steps_per_sync=8,
                return_stats=True)
    runs = {
        # prompts of 142-232 tokens stream past the 128-position ring in
        # chunks of 32 (<= ring - window) over a 32-token prefix
        "stream": (64, sufs, dict(base, max_new_tokens=24, prefill_chunk=32,
                                  shared_prefix=pfx)),
        # a 40-token prefix (2 whole blocks and a CoW block), unchunked,
        # window 120: each decode wrap onto a prefix slot copies it first
        "copy": (120, prompts_for(cfg, 4, 50, 80, SEED + 26),
                 dict(base, max_new_tokens=40,
                      shared_prefix=prompts_for(cfg, 1, 40, 40,
                                                SEED + 27)[0])),
        "int8": (64, sufs, dict(base, max_new_tokens=24, prefill_chunk=32,
                                shared_prefix=pfx, kv_quant=True)),
    }
    out = {"launches_int8": 0}
    for name, (w, reqs, kw) in runs.items():
        with window_tally() as tally:
            want, st_cpu = serve_loop(models[w, "cpu"], reqs, device="cpu",
                                      **kw)
        copies_cpu = tally["copies"]
        for scheduler in ("slot", "continuous"):
            pa.reset_launches()
            with window_tally() as tally:
                got, st = serve_loop(models[w, "cuda"], reqs, device="cuda",
                                     scheduler=scheduler, **kw)
            int8 = kw.get("kv_quant", False)
            if (pa.launches_int8 if int8 else pa.launches) == 0 or (
                    pa.launches if int8 else pa.launches_int8):
                raise AssertionError(
                    f"[window-parity] ({name}, {scheduler}) K1 "
                    f"{pa.launches}, K1q {pa.launches_int8} launches")
            if int8:
                out["launches_int8"] += pa.launches_int8
            same = (sched(got) == sched(want) if scheduler == "slot"
                    else [r.tokens for r in got] == [r.tokens for r in want])
            if not same:
                raise AssertionError(
                    f"[window-parity] ({name}, {scheduler}) cuda "
                    f"{sched(got)} != cpu {sched(want)}")
            if st.window_evicted_blocks == 0 or (
                    name == "copy" and (tally["copies"] == 0
                                        or st.cow_copies == 0)):
                raise AssertionError(
                    f"[window-parity] ({name}, {scheduler}) evictions "
                    f"{st.window_evicted_blocks}, rotation copies "
                    f"{tally['copies']}, cow copies {st.cow_copies}")
            log(f"[window-parity] ({name}, {scheduler}) {len(reqs)} "
                f"requests, cuda's "
                f"{'tokens and schedule' if scheduler == 'slot' else 'tokens'}"
                f" == cpu's (slot); "
                f"window_evicted_blocks={st.window_evicted_blocks} "
                f"rotation_copies={tally['copies']} (cpu {copies_cpu}) "
                f"cow_copies={st.cow_copies} "
                f"prefix_block_hits={st.prefix_block_hits} "
                f"K1={pa.launches} K1q={pa.launches_int8}")
        if name == "int8":
            unified = [r.tokens for r in want]
    # the windowed handoff, int8 KV: exported on the card, adopted on
    # the card (both schedulers) and on the CPU
    kw = dict(runs["int8"][2])
    full = [torch.cat([pfx, x]) for x in sufs]
    hand, st = serve_loop(models[64, "cuda"], sufs, device="cuda",
                          prefill_only=True, **kw)
    if not all(h.export.window["ring"] == 8 for h in hand):
        raise AssertionError("[window-parity] the exports carry no ring")
    del kw["shared_prefix"]
    for dev in ("cuda", "cpu"):
        for scheduler in ("slot", "continuous"):
            got, _ = serve_loop(models[64, dev], full, device=dev,
                                adopt=hand, scheduler=scheduler, **kw)
            if [r.tokens for r in got] != unified:
                raise AssertionError(
                    f"[window-parity] handoff adopted on {dev} "
                    f"({scheduler}): {[r.tokens for r in got]} != the "
                    f"cpu's unified {unified}")
    log(f"[window-parity] windowed handoff, int8 KV: {len(hand)} exports "
        f"made on cuda (next_block "
        f"{[h.export.window['next_block'] for h in hand]}, payload blocks "
        f"{[h.export.payload_blocks() for h in hand]} of "
        f"{[len(h.export) for h in hand]}), adopted on cuda and cpu under "
        f"slot and continuous: tokens identical to the cpu's unified run")
    del models
    torch.cuda.empty_cache()
    return out


# --------------------------------------------- window kernel shapes (K1/K1q)
WIN_W, WIN_SLOTS = 4096, 288


def window_case(l: int, seed: int, dtype=torch.bfloat16) -> dict:
    """The window phase's kernel shapes: at L=1, 8 lanes over wrapped
    288-slot rings of 16-position blocks (contexts 4609 to 7815, the
    phase's full prompts plus their decode); at L=512, one lane's segment
    at positions 5120-5631, streamed past the ring.  Window 4096; the
    scratch block is poisoned."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if l == 1:
        ctx = [4609, 7815] + torch.randint(4610, 7815, (6,),
                                           generator=g).tolist()
    else:
        ctx = [5120 + l]
    b = len(ctx)
    dev = torch.device("cuda")
    table = (torch.randperm(b * WIN_SLOTS, generator=g) + 1).to(
        torch.int32).view(b, WIN_SLOTS)
    shape = (b * WIN_SLOTS + 1, BS, KV, D)
    k_pool = torch.randn(shape, generator=g)
    v_pool = torch.randn(shape, generator=g)
    k_pool[0] = 1e4
    v_pool[0] = 1e4
    q = torch.randn((b, l, H, D), generator=g)
    return dict(q=q.to(dev, dtype), k=k_pool.to(dev, dtype),
                v=v_pool.to(dev, dtype), table=table.to(dev),
                pos=torch.tensor([c - l for c in ctx], dtype=torch.int32,
                                 device=dev), window=WIN_W, ctx=ctx)


def window_bound_ms(case, dtype, int8: bool = False) -> tuple:
    """bound_ms for a window case, counting only the keys inside the
    window: a lane's L rows at pos..pos+L-1 read the positions
    pos+L-window .. pos+L-1 (each once) and row i does its products
    against min(pos+i+1, window) of them."""
    esz = torch.finfo(dtype).bits // 8
    q = case["q"]
    b, l, h, d = q.shape
    kv = case["k"].shape[2]
    per_pos = kv * D * esz if not int8 else kv * D + kv * 4
    keys = pairs = 0
    for p in case["pos"].tolist():
        keys += (p + l) - max(0, p + l - WIN_W)
        pairs += sum(min(p + i + 1, WIN_W) for i in range(l))
    io = 2 * q.numel() * esz + case["table"].numel() * 4 + b * 4
    t_bytes = (keys * per_pos * 2 + io) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 2 * h * d * pairs / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_kernel_phase(int8: bool = False) -> dict:
    """K1 (or K1q over int8_pools of the same draws) at the window
    phase's shapes against its plain version, bf16 and f32 queries: live
    rows within PAGED_TOL, two launches with the same bits; then the bf16
    decode and prefill times beside the plain version, SDPA over the
    gathered view with the ring and window mask, and the bound."""
    from tf_operator_tpu_torch.models import paged_attention as pa

    tag = "[kernel1q-window]" if int8 else "[kernel-window]"
    plain = (pa.paged_attention_int8_plain if int8
             else pa.paged_attention_plain)

    def inputs(case):
        k, v = int8_pools(case) if int8 else (case["k"], case["v"])
        return (case["q"], k, v, case["table"], case["pos"])

    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timings = {}
    for name, l in (("decode", 1), ("prefill", 512)):
        for dt in (torch.float32, torch.bfloat16):
            case = window_case(l, SEED + 200 + l, dt)
            args = inputs(case)
            errs[dt] = max(errs[dt], check_paged(
                case, args, plain, dt, None,
                f"{tag} {str(dt)[6:]:8s} {name} L={l} "
                f"B={len(case['ctx'])} ring {WIN_SLOTS} slots window "
                f"{WIN_W} ctx={case['ctx']}"))
        timings[name] = paged_timing(
            case, args, plain, window_bound_ms(case, torch.bfloat16, int8),
            f"{tag} timing {name} bf16 q, {'int8' if int8 else 'bf16'} KV, "
            f"B={len(case['ctx'])} L={l} ring {WIN_SLOTS} x {BS} window "
            f"{WIN_W} ctx={case['ctx']}")
    return dict(errs=errs, timings=timings)


# -------------------------------------------------------------- train phase
TRAIN_STEPS = 4


def train_model(cfg, seed: int = SEED):
    """The model train_llama builds for `cfg`, around f32 masters drawn
    from `seed`, and its train state and step."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.runtime.optim import Adafactor
    from tf_operator_tpu_torch.runtime.train import TrainState

    model = llama.Llama.from_params(
        cfg, bridge.init_params(cfg, seed, device="cuda", train=True),
        device="cuda", train=True)
    state = TrainState.create(model, Adafactor(1e-3))
    return model, state, train_llama.make_lm_step(model)


def llama3_train_cfg(**kw):
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.ops.flash_attention import flash_attention

    kw.setdefault("attention_fn", flash_attention)
    return llama.llama3_8b(tie_embeddings=True, remat=True, **kw)


def train_phase() -> dict:
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models.llama import params_flops_per_token
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.runtime.loop import run_training
    from tf_operator_tpu_torch.runtime.profiler import Profiler

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama3_train_cfg()
    t0 = time.perf_counter()
    model, state, step = train_model(cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] llama3_8b tied, remat, flash attention, {cfg.n_layers} "
        f"layers, {n_params / 1e9:.4f} B f32 master params in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB); compute "
        f"{cfg.dtype}; batch {TB} x {TS}")
    losses, times = [], []

    def timed_step(state, tokens):
        t = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return state, metrics

    batches = train_llama.lm_batches(TB, TS, cfg.vocab_size, SEED + 4,
                                     device="cuda")
    fa.reset_launches()
    res = run_training(state, timed_step, batches, num_steps=TRAIN_STEPS,
                       profiler=Profiler(batch_size=TB), log_interval_steps=1,
                       metrics_sink=lambda line: log(f"[train] metrics {line}"))
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    del model, state, step, res
    torch.cuda.empty_cache()

    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[train] losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.5:
        raise AssertionError(f"[train] first loss {losses[0]} is not within "
                             f"1.5 of ln({cfg.vocab_size})")
    # bf16 compute: every launch takes a tensor-core kernel
    want = {"flash_fwd": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_fwd_mma": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_dq": cfg.n_layers * TRAIN_STEPS,
            "flash_dq_mma": cfg.n_layers * TRAIN_STEPS,
            "flash_dkv": cfg.n_layers * TRAIN_STEPS,
            "flash_dkv_mma": cfg.n_layers * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"[train] kernel launches {launches}, "
                             f"expected {want}")
    steady = sorted(times[1:])
    step_s = steady[len(steady) // 2]
    tokens_per_s = TB * TS / step_s
    mfu = tokens_per_s * params_flops_per_token(cfg) / PEAK_OPS_PER_S[
        torch.bfloat16]
    log(f"[train] losses {[round(x, 4) for x in losses]} "
        f"(ln V = {math.log(cfg.vocab_size):.4f}); step_s "
        f"{[round(x, 4) for x in times]}; steady step_s (median of steps "
        f"2-{TRAIN_STEPS}) {step_s:.4f}, tokens_per_s {tokens_per_s:.2f}, "
        f"mfu {mfu:.4f}, max_memory_allocated_gib {peak / 2**30:.3f}, "
        f"kernel_launches {json.dumps(launches)}")
    return dict(launches=launches, losses=losses, peak_gib=peak / 2**30)


MISTRAL_STEPS = 3


def mistral_train_phase() -> dict:
    """mistral_7b at full width and depth as train_llama builds it (tied,
    remat, flash attention), batch 1 x 8192 (its preset max_len: two
    windows of 4096, so K2's window cuts every sequence), 3 steps through
    run_training: every loss finite, the first within 1.5 of ln(vocab);
    K2f launched 2 x 32 times a step, K2q and K2kv 32 times, all on the
    tensor cores.  Then one full-depth save of the trained state (about
    28.5 GB), timed to the host and to the disk."""
    import shutil
    import tempfile

    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.models.llama import params_flops_per_token
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops.flash_attention import flash_attention
    from tf_operator_tpu_torch.runtime.loop import run_training
    from tf_operator_tpu_torch.runtime.profiler import Profiler
    from tf_operator_tpu_torch.runtime.train import Checkpointer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama.mistral_7b(tie_embeddings=True, remat=True,
                           attention_fn=flash_attention)
    t0 = time.perf_counter()
    model, state, step = train_model(cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[mistral-train] mistral_7b tied, remat, flash attention, window "
        f"{cfg.sliding_window}, {cfg.n_layers} layers, "
        f"{n_params / 1e9:.4f} B f32 master params in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB); compute "
        f"{cfg.dtype}; batch {TB} x {MS}")
    losses, times = [], []

    def timed_step(state, tokens):
        t = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return state, metrics

    batches = train_llama.lm_batches(TB, MS, cfg.vocab_size, SEED + 7,
                                     device="cuda")
    fa.reset_launches()
    res = run_training(state, timed_step, batches, num_steps=MISTRAL_STEPS,
                       profiler=Profiler(batch_size=TB), log_interval_steps=1,
                       metrics_sink=lambda line: log(f"[mistral-train] "
                                                     f"metrics {line}"))
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    # the full-depth save that a preemption makes (run_training saves with
    # wait=True on SIGTERM): async here, waited for at once, so the host
    # snapshot's seconds and the write's show apart
    root = tempfile.mkdtemp(prefix="chip_smoke_mistral_ckpt_")
    try:
        ckpt = Checkpointer(root, async_save=True)
        t = time.perf_counter()
        ckpt.save(MISTRAL_STEPS, res.state)
        t_snap = time.perf_counter() - t
        ckpt.wait_until_finished()
        t_save = time.perf_counter() - t
        nbytes = _dir_bytes(f"{root}/{MISTRAL_STEPS}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model, state, step, res
    torch.cuda.empty_cache()

    if len(losses) != MISTRAL_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[mistral-train] losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.5:
        raise AssertionError(f"[mistral-train] first loss {losses[0]} is "
                             f"not within 1.5 of ln({cfg.vocab_size})")
    n = cfg.n_layers * MISTRAL_STEPS
    want = {"flash_fwd": 2 * n, "flash_fwd_mma": 2 * n, "flash_dq": n,
            "flash_dq_mma": n, "flash_dkv": n, "flash_dkv_mma": n}
    if launches != want:
        raise AssertionError(f"[mistral-train] kernel launches {launches}, "
                             f"expected {want}")
    steady = sorted(times[1:])
    step_s = steady[len(steady) // 2]
    tokens_per_s = TB * MS / step_s
    mfu = tokens_per_s * params_flops_per_token(cfg) / PEAK_OPS_PER_S[
        torch.bfloat16]
    log(f"[mistral-train] losses {[round(x, 4) for x in losses]} "
        f"(ln V = {math.log(cfg.vocab_size):.4f}); step_s "
        f"{[round(x, 4) for x in times]}; steady step_s (median of steps "
        f"2-{MISTRAL_STEPS}) {step_s:.4f}, tokens_per_s {tokens_per_s:.2f}, "
        f"mfu {mfu:.4f}, max_memory_allocated_gib {peak / 2**30:.3f}, "
        f"kernel_launches {json.dumps(launches)}")
    gb = nbytes / 1e9
    log(f"[mistral-train] full-depth save: bytes_saved {nbytes} ({gb:.3f} "
        f"GB); host snapshot {t_snap:.3f} s ({gb / t_snap:.3f} GB/s), on "
        f"disk (fsynced) after {t_save:.3f} s ({gb / t_save:.3f} GB/s)")
    return dict(launches=launches, losses=losses)


# K2 launches of one f32 step of 2 layers with remat: the scalar kernels
F32_K2_LAUNCHES = {"flash_fwd": 4, "flash_fwd_mma": 0, "flash_dq": 2,
                   "flash_dq_mma": 0, "flash_dkv": 2, "flash_dkv_mma": 0}


def train_parity_phase() -> None:
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_train_cfg(n_layers=2, dtype=torch.float32)
    params = bridge.init_params(cfg, SEED + 5, device="cuda", train=True)
    models = {"cuda": llama.Llama.from_params(cfg, params, device="cuda",
                                              train=True),
              "cpu": llama.Llama.from_params(
                  cfg, {k: v.cpu() for k, v in params.items()},
                  device="cpu", train=True)}
    del params
    g = torch.Generator(device="cpu").manual_seed(SEED + 6)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=g)
    fa.reset_launches()
    out = {}
    for dev, model in models.items():
        loss = lm_blocked_loss(model, tokens.to(dev))
        loss.backward()
        # norms in f64: torch's f32 norm of a 117M-element tensor on the
        # CPU is off by 1.6 % (measured on blocks.1.mlp.wi), the card's
        # by 1e-8
        out[dev] = (loss.item(), {
            k: torch.linalg.vector_norm(p.grad, dtype=torch.float64).item()
            for k, p in model.named_parameters()})
    launches = dict(fa.launches)
    del models
    torch.cuda.empty_cache()
    (l_gpu, n_gpu), (l_cpu, n_cpu) = out["cuda"], out["cpu"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    norm_rel = {k: abs(n_gpu[k] - n_cpu[k]) / max(n_cpu[k], 1e-30)
                for k in n_cpu}
    worst = max(norm_rel, key=norm_rel.get)
    log(f"[train-parity] 2 layers f32, batch 2 x 128: loss cuda {l_gpu:.7f} "
        f"cpu {l_cpu:.7f} (rel {loss_rel:.2e}, limit 1e-5); "
        f"{len(norm_rel)} gradient norms, worst rel {norm_rel[worst]:.2e} "
        f"({worst}, limit 1e-4); launches {json.dumps(launches)}")
    if not (math.isfinite(l_gpu) and loss_rel <= 1e-5
            and norm_rel[worst] <= 1e-4):
        raise AssertionError("[train-parity] the card and the CPU disagree")
    # f32: the scalar kernels, never the tensor cores (TF32)
    if launches != F32_K2_LAUNCHES:
        raise AssertionError(f"[train-parity] launches {launches}")


# ------------------------------------------------------- checkpoint phase
CKPT_LAYERS = 2


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def checkpoint_phase() -> None:
    """Checkpointed training at full width: llama3_8b cut to 2 layers
    (tied, remat, flash attention, f32 masters, bf16 compute; about 0.96 B
    parameters, 3.85 GB of f32 a save), batch 1 x 2048, in a temporary
    directory removed at the end.  (a) 4 steps unbroken; (b) from the
    same seed 2 steps with a sync save at step 2, then a fresh model from
    another seed resumed from it for 2 more: steps 3-4's losses and the
    final parameters equal (a)'s bit for bit; (c) an async save at step 2,
    step 3 updating the parameters in place, wait_until_finished, restore:
    the step-2 parameters bit for bit; (d) restore_params into a bf16
    serving model, whose greedy serve_loop(paged=True) tokens (through K1)
    equal those of a serving model built from the trained model in memory.
    Prints the bytes saved and each save's and restore's seconds and
    GB/s."""
    import shutil
    import tempfile

    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.runtime.loop import run_training
    from tf_operator_tpu_torch.runtime.train import Checkpointer

    class Timed(Checkpointer):
        """Checkpointer that records each save's and restore's seconds."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.times = []

        def save(self, step, state, wait=False):
            t = time.perf_counter()
            out = super().save(step, state, wait=wait)
            self.times.append(("save", step, time.perf_counter() - t))
            return out

        def restore(self, state, step=None):
            t = time.perf_counter()
            state = super().restore(state, step)
            torch.cuda.synchronize()
            self.times.append(("restore", step, time.perf_counter() - t))
            return state

    cfg = llama3_train_cfg(n_layers=CKPT_LAYERS)
    stream = lambda: train_llama.lm_batches(TB, TS, cfg.vocab_size,
                                            SEED + 8, device="cuda")

    def run(seed, batches, num_steps, ckpt=None):
        model, state, step = train_model(cfg, seed)
        losses = []

        def logged(state, tokens):
            state, m = step(state, tokens)
            losses.append(float(m["loss"]))
            return state, m

        res = run_training(state, logged, batches, num_steps=num_steps,
                           checkpointer=ckpt, save_interval_steps=2)
        torch.cuda.synchronize()
        return model, res, losses

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # (a) unbroken
        model, res, unbroken = run(SEED, stream(), 4)
        want = {k: p.detach().clone() for k, p in res.state.params.items()}
        del model, res
        # (b) sync save at step 2, resume in a fresh model of another seed
        sync = Timed(f"{root}/sync")
        model, res, first = run(SEED, stream(), 2, sync)
        del model, res
        rest = stream()
        for _ in range(2):
            next(rest)  # the resumed job reads on from batch 3
        model, res, second = run(SEED + 1, rest, 4, sync)
        if (res.resumed_from, res.steps_run, res.last_saved_step) != (2, 2, 4):
            raise AssertionError(
                f"[checkpoint] resumed_from {res.resumed_from}, steps_run "
                f"{res.steps_run}, last_saved_step {res.last_saved_step}")
        if first + second != unbroken:
            raise AssertionError(f"[checkpoint] losses {first + second} != "
                                 f"unbroken {unbroken}")
        differ = [k for k, p in res.state.params.items()
                  if not torch.equal(p, want[k])]
        if differ:
            raise AssertionError(f"[checkpoint] resumed parameters differ "
                                 f"from the unbroken run's: {differ[:5]}")
        trained = {k: p.detach() for k, p in res.state.params.items()}
        del want
        nbytes = _dir_bytes(f"{root}/sync/2")

        # (c) async save at step 2, then step 3 in place
        asyn = Checkpointer(f"{root}/async", async_save=True)
        model2, state2, step2 = train_model(cfg, SEED)
        it = stream()
        for _ in range(2):
            state2, _ = step2(state2, *next(it))
        torch.cuda.synchronize()
        t = time.perf_counter()
        asyn.save(2, state2)
        t_return = time.perf_counter() - t
        state2, _ = step2(state2, *next(it))
        torch.cuda.synchronize()
        asyn.wait_until_finished()
        t_durable = time.perf_counter() - t
        t = time.perf_counter()
        asyn.restore(state2)
        torch.cuda.synchronize()
        t_async_restore = time.perf_counter() - t
        at_2 = sync.restore_params(step=2, device="cuda")
        differ = [k for k, p in state2.params.items()
                  if not torch.equal(p, at_2[k])]
        if differ or state2.step != 2 or state2.opt_state["count"] != 2:
            raise AssertionError(f"[checkpoint] async restore differs from "
                                 f"step 2: {differ[:5]}, step {state2.step}")
        del model2, state2, step2, at_2

        # (d) the checkpoint into a bf16 serving model
        serve_cfg = llama.llama3_8b(n_layers=CKPT_LAYERS,
                                    tie_embeddings=True)
        with torch.device("meta"):
            storage = llama.Llama(serve_cfg).state_dict()
        t = time.perf_counter()
        params = sync.restore_params(storage, device="cuda")
        torch.cuda.synchronize()
        t_params = time.perf_counter() - t
        restored = llama.Llama.from_params(serve_cfg, params, device="cuda")
        memory = llama.Llama.from_params(serve_cfg, trained, device="cuda")
        del params, trained, model, res
        prompts = prompts_for(serve_cfg, 4, 16, 128, SEED + 9)
        kw = dict(slots=4, max_new_tokens=16, block_size=BS, paged=True,
                  device="cuda")
        pa.reset_launches()
        got = [r.tokens for r in serve_loop(restored, prompts, **kw)]
        k1 = pa.launches
        ref = [r.tokens for r in serve_loop(memory, prompts, **kw)]
        del restored, memory
        if got != ref or k1 == 0:
            raise AssertionError(f"[checkpoint] restored model's tokens "
                                 f"{got} != in memory {ref} (K1 {k1})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    gb = nbytes / 1e9
    (_, _, t_save), = [x for x in sync.times if x[0] == "save" and x[1] == 2]
    (_, _, t_restore), = [x for x in sync.times if x[0] == "restore"]
    log(f"[checkpoint] llama3_8b x {CKPT_LAYERS} layers: losses unbroken "
        f"{[round(x, 6) for x in unbroken]} = resumed "
        f"{[round(x, 6) for x in first + second]} bit for bit, final "
        f"parameters equal; async save + in-place step 3 restores step 2 "
        f"bit for bit; restored bf16 model = in-memory model, "
        f"{sum(map(len, got))} greedy tokens through K1 ({k1} launches)")
    log(f"[checkpoint] bytes_saved {nbytes} ({gb:.3f} GB); sync save "
        f"{t_save:.3f} s ({gb / t_save:.3f} GB/s); async save returns in "
        f"{t_return:.3f} s ({gb / t_return:.3f} GB/s), durable after "
        f"{t_durable:.3f} s ({gb / t_durable:.3f} GB/s, step 3 included); "
        f"restore {t_restore:.3f} s ({gb / t_restore:.3f} GB/s), async "
        f"restore {t_async_restore:.3f} s; restore_params into bf16 "
        f"{t_params:.3f} s ({gb / t_params:.3f} GB/s of f32 read)")


# ------------------------------------------------------- serve-int8 phase
# blocks of the serve-int8 pool: the slot loop's default for the serve
# phase's requests is 8 lanes x 65 blocks = 520; at 240 the continuous
# scheduler's step gate blocks and growth preempts
INT8_POOL = 240


def int8_params(cfg, seed: int):
    """int8 weights on the card, quantized from the f32 draws of `seed`
    (bridge.init_params(train=True)); the f32 tree is freed here."""
    from tf_operator_tpu_torch.models import bridge, quant

    master = bridge.init_params(cfg, seed, device="cuda", train=True)
    params = quant.quantize_params(master)
    del master
    return params


def serve_int8_phase() -> dict:
    from tf_operator_tpu_torch.models import llama, quant
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    params = int8_params(cfg, SEED)
    qbytes = quant.quantized_bytes(params)
    model = llama.Llama.from_params(cfg, params, device="cuda")
    del params
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    log(f"[serve-int8] llama3_8b {cfg.n_layers} layers, int8 weights "
        f"quantized from the f32 draws of seed {SEED} in "
        f"{time.perf_counter() - t0:.1f} s (peak while quantizing "
        f"{build_peak / 2**30:.3f} GiB); quantized_bytes {qbytes} "
        f"({qbytes / 2**30:.3f} GiB), resident "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB; compute "
        f"{cfg.dtype}")
    kw = dict(slots=8, block_size=BS, steps_per_sync=8, device="cuda",
              scheduler="continuous", kv_quant=True, prefill_chunk=256,
              prefill_chunks_per_sync=1)
    prompts = prompts_for(cfg, 16, 64, MAX_CTX, SEED + 1)
    # warm-up (cuBLAS handles, allocator) on two short requests
    serve_loop(model, [p[:64] for p in prompts[:2]], max_new_tokens=8, **kw)
    torch.cuda.synchronize()

    calls = [0]
    hook = model.register_forward_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launches()
    results, stats = serve_loop(model, prompts, max_new_tokens=MAX_NEW,
                                pool_blocks=INT8_POOL, return_stats=True,
                                **kw)
    torch.cuda.synchronize()
    launches, k1_launches = pa.launches_int8, pa.launches
    mma = pa.launches_int8_mma
    hook.remove()
    peak = torch.cuda.max_memory_allocated()

    for i, r in enumerate(results):
        if len(r.tokens) != MAX_NEW:
            raise AssertionError(f"[serve-int8] request {i} emitted "
                                 f"{len(r.tokens)} tokens, budget {MAX_NEW}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"[serve-int8] request {i}: token out of "
                                 f"vocab")
    if launches != cfg.n_layers * calls[0] or launches == 0 or k1_launches:
        raise AssertionError(
            f"[serve-int8] K1q launched {launches} times and K1 "
            f"{k1_launches} times for {calls[0]} model calls x "
            f"{cfg.n_layers} layers")
    if mma != launches:
        raise AssertionError(f"[serve-int8] {mma} of {launches} bf16-query "
                             f"K1q calls took the tensor-core design")
    if not (stats.fused_prefill_tokens > 0
            and stats.admissions_blocked_on_memory > 0
            and stats.kv_blocks_peak_used <= INT8_POOL):
        raise AssertionError(f"[serve-int8] the continuous scheduler did not "
                             f"fuse, gate and bound as planned: {stats}")
    ttft = sorted(r["ttft_s"] for r in stats.per_request)
    pct = lambda p: ttft[min(len(ttft) - 1, math.ceil(p * len(ttft)) - 1)]
    e2e = [r["e2e_latency_s"] for r in stats.per_request]
    log(f"[serve-int8] {len(results)} requests, {MAX_NEW} new tokens each, "
        f"scheduler continuous, prefill_chunk 256 one segment a turn, pool "
        f"{INT8_POOL} blocks of {BS}")
    log(f"[serve-int8] tokens={stats.total_tokens} "
        f"wall_s={stats.wall_time_s:.4f} "
        f"tokens_per_s={stats.tokens_per_sec:.2f} "
        f"ttft_p50_s={pct(0.5):.4f} ttft_p99_s={pct(0.99):.4f} "
        f"e2e_max_s={max(e2e):.4f} prefill_s={stats.prefill_time_s:.4f} "
        f"decode_s={stats.decode_time_s:.4f} "
        f"fused_prefill_tokens={stats.fused_prefill_tokens} "
        f"preemptions={stats.preemptions} "
        f"admissions_blocked_on_memory={stats.admissions_blocked_on_memory} "
        f"kv_blocks_peak_used={stats.kv_blocks_peak_used} "
        f"model_calls={calls[0]} k1q_launches={launches} "
        f"k1q_tensor_core_launches={mma} "
        f"k1_launches={k1_launches} quantized_bytes={qbytes} "
        f"max_memory_allocated_gib={peak / 2**30:.3f}")
    log(f"[serve-int8] telemetry: {tel_line(stats)}")
    logits = first_prefill_logits(model, prompts[0], True)
    del model
    torch.cuda.empty_cache()
    return dict(launches=launches, tokens=[r.tokens for r in results],
                peak_gib=peak / 2**30, logits=logits)


# ------------------------------------------------------ parity-int8 phase
def parity_int8_phase() -> None:
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.models.serving import serve_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.llama3_8b(n_layers=2, dtype=torch.float32)
    params = int8_params(cfg, SEED + 7)
    m_gpu = llama.Llama.from_params(cfg, params, device="cuda")
    m_cpu = llama.Llama.from_params(
        cfg, {k: v.to("cpu") for k, v in params.items()}, device="cpu")
    del params
    prompts = prompts_for(cfg, 4, 24, 96, SEED + 3)
    # staggered budgets: a newcomer's segments ride a neighbour's decode
    kw = dict(slots=2, max_new_tokens=[6, 16, 10, 12], block_size=BS,
              steps_per_sync=8, prefill_chunk=32, kv_quant=True)
    sched = lambda rs: [(r.tokens, r.admitted_at_step, r.finished_at_step,
                         r.slot, r.kv_blocks) for r in rs]
    got, stats = serve_loop(m_gpu, prompts, device="cuda",
                            scheduler="continuous", return_stats=True, **kw)
    want = serve_loop(m_cpu, prompts, device="cpu", scheduler="continuous",
                      **kw)
    slot = serve_loop(m_gpu, prompts, device="cuda", scheduler="slot", **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        log(f"[parity-int8] request {i}: cuda {g.tokens}")
    if sched(got) != sched(want):
        raise AssertionError(f"[parity-int8] cuda {sched(got)} != cpu "
                             f"{sched(want)}")
    if [r.tokens for r in got] != [r.tokens for r in slot]:
        raise AssertionError("[parity-int8] continuous tokens differ from "
                             "slot tokens on the card")
    if stats.fused_prefill_tokens == 0:
        raise AssertionError("[parity-int8] no segment was fused")
    log(f"[parity-int8] 2 layers f32, int8 weights and KV: {len(prompts)} "
        f"requests, greedy tokens and schedule identical on cuda and cpu "
        f"(continuous, {stats.fused_prefill_tokens} fused prefill tokens), "
        f"and continuous == slot on cuda")
    del m_gpu, m_cpu
    torch.cuda.empty_cache()



# --------------------------------------------------------- kernel-3 phase
# the ring of the ring-train phase: llama3_8b's 2048 training positions
# over 4 members
RING_N, RING_SL = 4, TS // 4
RING = ("ring_fwd", "ring_dq", "ring_dkv")


def ring_case(dtype, s_l: int, seed: int, carry: str):
    """One (member, step) of the ring at the training widths: q and dO
    [B, S_l, H, D], k and v as the halves of a fused [B, S_l, 2, KV, D]
    projection, the forward carry (m, l [B, H, S_l], acc [B, S_l, H, D]:
    "fresh" as the ring starts it, "mid" as after earlier steps, "masked"
    with a third of the rows having seen no key), and lse, delta for the
    backward with a few rows at lse = POS_INF.  This lse stands for the
    mass of the ring's other steps only; `forward_lse` adds the step's
    own, as the forward pass does."""
    from tf_operator_tpu_torch.ops import ring_flash as rf

    g = torch.Generator(device="cpu").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g)
    q, do = rn(TB, s_l, TH, TD), rn(TB, s_l, TH, TD)
    kv = rn(TB, s_l, 2, TKV, TD)
    m, l, acc = rn(TB, TH, s_l), rn(TB, TH, s_l).abs() + 1, rn(TB, s_l, TH, TD)
    if carry == "fresh":
        m.fill_(rf.NEG_INF)
        l.zero_()
        acc.zero_()
    if carry == "masked":
        m[:, :, :s_l // 3] = rf.NEG_INF
        l[:, :, :s_l // 3] = 0.0
        acc[:, :s_l // 3] = 0.0
    lse, delta = rn(TB, TH, s_l) + 3, rn(TB, TH, s_l)
    lse[:, 0, :8] = rf.POS_INF
    q, do, kv = (t.to("cuda", dtype) for t in (q, do, kv))
    state = [t.cuda() for t in (m, l, acc, lse, delta)]
    return (q, kv[:, :, 0], kv[:, :, 1], do), state


def forward_lse(lse, q, steps, q_off, window=None):
    """lse as the ring's forward leaves it for these steps ((k, k_off)
    pairs): the logsumexp of each row's scaled visible scores over them,
    added to `lse` (the other steps' mass; POS_INF rows stay POS_INF).
    So p = exp(s - lse) <= 1, as in every real backward step."""
    from tf_operator_tpu_torch.ops import ring_flash as rf

    b, s_l, h, _ = q.shape
    terms = [lse]
    for k, k_off in steps:
        sc = rf._scores(q, k, rf._mask(q_off, k_off, s_l, True, window,
                                       q.device))
        terms.append(torch.logsumexp(sc, dim=-1).reshape(b, h, s_l))
    return torch.logsumexp(torch.stack(terms), dim=0)


def ring_launch_bound(which: str, dtype, s_l: int, pairs: int) -> tuple:
    """(bytes, flops) of one K3 launch over `pairs` visible (query, key)
    pairs: each input read once and each output written once, the f32
    carry or accumulators both read and written (they are updated in
    place); products 2 flops per multiply-add for 2 matmuls (forward:
    QKᵀ, PV), 3 (dQ: QKᵀ, dO·Vᵀ, dS·K) or 4 (dK/dV: QKᵀ, dO·Vᵀ, Pᵀ·dO,
    dSᵀ·Q)."""
    esz = torch.finfo(dtype).bits // 8
    qo = TB * s_l * TH * TD * esz
    kv = TB * s_l * TKV * TD * esz
    stat = TB * TH * s_l * 4
    acc_q = TB * s_l * TH * TD * 4
    acc_kv = TB * s_l * TKV * TD * 4
    nbytes = {"ring_fwd": qo + 2 * kv + 4 * stat + 2 * acc_q,
              "ring_dq": 2 * qo + 2 * kv + 2 * stat + 2 * acc_q,
              "ring_dkv": 2 * qo + 2 * kv + 2 * stat + 4 * acc_kv}[which]
    mm = {"ring_fwd": 2, "ring_dq": 3, "ring_dkv": 4}[which]
    return nbytes, mm * 2 * TB * TH * pairs * TD


def bound_of(launches: list, dtype) -> tuple:
    """The least time for a list of (bytes, flops): the larger of all the
    bytes over HBM bandwidth and all the products over the peak."""
    t_bytes = sum(b for b, _ in launches) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f for _, f in launches) / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def visible_pairs(q_off, k_off, s_l: int, window=None) -> int:
    from tf_operator_tpu_torch.ops import ring_flash as rf

    return int(rf._mask(q_off, k_off, s_l, True, window, "cpu").sum())


def kernel3_phase() -> dict:
    """K3f, K3q and K3kv against their plain versions on one (member,
    step) each of the cases below, bf16 and f32; two launches must give
    the same bits, a dead step must leave every accumulator as it was,
    and every bf16 K3f, K3q and K3kv launch must run on the tensor cores
    (no f32 one).  Then, in bf16, the last member's launches over its
    ring (3 past steps and its diagonal: the most work of any member)
    timed beside the same plain calls, their bound, and SDPA of that
    member's q against the whole sequence's k/v under the global causal
    mask (forward, and backward through autograd)."""
    # (S_l, layout, member, resident shard's member, window, carry)
    cases = [(RING_SL, "contiguous", 2, 2, None, "fresh"),
             (RING_SL, "contiguous", 2, 1, None, "mid"),
             (RING_SL, "contiguous", 1, 2, None, "mid"),
             (RING_SL, "zigzag", 1, 2, None, "mid"),
             (RING_SL, "zigzag", 2, 2, None, "fresh"),
             (RING_SL, "contiguous", 3, 2, 512, "mid"),
             (RING_SL, "contiguous", 3, 3, None, "masked"),
             (200, "zigzag", 1, 3, None, "mid")]
    errs = kernel3_check(cases, RING_N, SEED + 40)
    return dict(errs=errs, timings=kernel3_timing(RING_N, RING_SL,
                                                  SEED + 60))


# the ring over tp 2 of llama3_8b at 1 x 2048: each member's sequence
# block of every head after the exchange
TP_RING_N, TP_RING_SL = 2, TS // 2


def kernel3_tp_phase() -> dict:
    """K3f, K3q and K3kv at the shape the ring over tp 2 gives them
    (S_l = 1024, all 32 query and 8 kv heads), against their plain
    versions (kernel3_phase's checks), and member 1's launches over its
    2 live steps timed as kernel3_phase times them."""
    cases = [(TP_RING_SL, "contiguous", 1, 1, None, "fresh"),
             (TP_RING_SL, "contiguous", 1, 0, None, "mid"),
             (TP_RING_SL, "contiguous", 0, 1, None, "mid"),
             (TP_RING_SL, "contiguous", 1, 0, 512, "masked")]
    errs = kernel3_check(cases, TP_RING_N, SEED + 86, tag="kernel3-tp")
    return dict(errs=errs, timings=kernel3_timing(
        TP_RING_N, TP_RING_SL, SEED + 90, tag="kernel3-tp"))


def kernel3_check(cases: list, n: int, seed: int, tag: str = "kernel3"
                  ) -> dict:
    """kernel3_phase's checks of each (S_l, layout, member, resident,
    window, carry) case on a ring of n members: the bf16 errors."""
    from tf_operator_tpu_torch.ops import ring_flash as rf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # f32: 64-wide tiles folded by online softmax against whole-shard
    # einsums (~1e-6 on O(1) values).  bf16: p and dS rounded to bf16
    # (2^-8 relative), at a running instead of the final maximum.  The
    # forward's acc is an unnormalized sum of up to S_l terms p·v, so its
    # rounding error grows with l: it is held as acc / l, the output the
    # finish step forms (l == 0 -> 1), beside m and l themselves.
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

    def as_out(m, l, acc):
        l_safe = torch.where(l == 0.0, 1.0, l)
        return m, l, acc / l_safe.transpose(1, 2)[..., None]

    errs = {name: 0.0 for name in RING}
    for i, (s_l, layout, my, src, w, carry) in enumerate(cases):
        for dt in (torch.bfloat16, torch.float32):
            (q, k, v, do), (m, l, acc, lse, delta) = ring_case(
                dt, s_l, seed + i, carry)
            offs = (rf.offsets(my, n, s_l, layout),
                    rf.offsets(src, n, s_l, layout), True, w)
            lse_other = lse
            lse = forward_lse(lse_other, q, [(k, offs[1])], offs[0], w)
            bwd = (q, k, v, do, lse, delta)
            want = {"ring_fwd": as_out(*rf.carry_fwd_plain(q, k, v, m, l,
                                                           acc, *offs)),
                    "ring_dq": (rf.ring_dq_plain(*bwd, *offs),),
                    "ring_dkv": rf.ring_dkv_plain(*bwd, *offs)}
            runs = []
            before = dict(rf.launches)
            for _ in range(2):
                st = [t.clone() for t in (m, l, acc)]
                rf.ring_fwd(q, k, v, *st, *offs)
                dq = torch.zeros(q.shape, device="cuda")
                dk = torch.zeros(k.shape, device="cuda")
                dv = torch.zeros(k.shape, device="cuda")
                rf.ring_dq(*bwd, dq, *offs)
                rf.ring_dkv(*bwd, dk, dv, *offs)
                runs.append({"ring_fwd": st, "ring_dq": (dq,),
                             "ring_dkv": (dk, dv)})
            torch.cuda.synchronize()
            counts = {n: rf.launches[n] - before[n] for n in rf.launches}
            mma = {f"{n}_mma": counts[f"{n}_mma"] for n in RING}
            if any(counts[n] != 2 for n in RING) or mma != {
                    f"{n}_mma": counts[n] if dt == torch.bfloat16 else 0
                    for n in RING}:
                raise AssertionError(f"[{tag}] {dt} launches {counts}: 2 "
                                     f"of each, all on the tensor cores in "
                                     f"bf16, none in f32")
            dead = src > my and layout == "contiguous"
            line = []
            for name in RING:
                same = all(torch.equal(a, b)
                           for a, b in zip(runs[0][name], runs[1][name]))
                err, ok = 0.0, same
                got_all = runs[0][name]
                if name == "ring_fwd":
                    got_all = as_out(*got_all)
                for got, ref in zip(got_all, want[name]):
                    diff = (got - ref).abs()
                    err = max(err, float(diff.max()))
                    ok &= bool(torch.isfinite(got).all())
                    ok &= bool((diff <= tol[dt] * (1 + ref.abs())).all())
                if dead:
                    # a dead step leaves the carry and the sums as they were
                    was = (m, l, acc) if name == "ring_fwd" else [
                        torch.zeros_like(t) for t in runs[0][name]]
                    ok &= all(torch.equal(a, b)
                              for a, b in zip(runs[0][name], was))
                if dt == torch.bfloat16:
                    errs[name] = max(errs[name], err)
                line.append(f"{name} err={err:.3e} repeat={same}")
                if not ok:
                    raise AssertionError(
                        f"[{tag}] {name} disagrees with its plain version "
                        f"or does not repeat: dtype={dt} S_l={s_l} "
                        f"layout={layout} member={my} resident={src} "
                        f"window={w} carry={carry} err={err} "
                        f"bit_identical={same}")
            log(f"[{tag}] {str(dt)[6:]:8s} S_l={s_l} {layout} member={my} "
                f"resident={src} window={w} carry={carry} "
                f"(atol=rtol={tol[dt]}): " + ", ".join(line)
                + f"; tensor-core launches {json.dumps(mma)}")
            if dt == torch.bfloat16 and not dead:
                # reported, not held: with the other steps' lse alone p
                # reaches e^7 and |dS| thousands, where a bf16 rounding of
                # dS that two summation orders of S or dP place on either
                # side of a tie moves dq or dk by ulp(dS) |k or q| scale
                odd = (q, k, v, do, lse_other, delta)
                dq = torch.zeros(q.shape, device="cuda")
                dk = torch.zeros(k.shape, device="cuda")
                dv = torch.zeros(k.shape, device="cuda")
                rf.ring_dq(*odd, dq, *offs)
                rf.ring_dkv(*odd, dk, dv, *offs)
                pairs = zip((dq, dk, dv), (rf.ring_dq_plain(*odd, *offs),
                                           *rf.ring_dkv_plain(*odd, *offs)))
                dev = [((got - ref).abs(), ref) for got, ref in pairs]
                log(f"[{tag}]   the same step at lse of the other steps "
                    f"only (p > 1): max |kernel - plain| dq/dk/dv "
                    + "/".join(f"{float(d.max()):.3e}" for d, _ in dev)
                    + ", elements past 2e-2 + 2e-2 |ref|: "
                    + "/".join(str(int((d > 2e-2 * (1 + r.abs())).sum()))
                               for d, r in dev))
            del runs, want, bwd
    return errs


def kernel3_timing(n: int, s_l: int, seed: int, tag: str = "kernel3"
                   ) -> dict:
    """The last member's ring of n members of S_l rows: its q shard
    against kv shards n-1 (diagonal) down to 0 (past), as K3f meets them
    in the causal contiguous ring, timed (kernel3_phase's docstring)."""
    from tf_operator_tpu_torch.ops import ring_flash as rf

    dt, my = torch.bfloat16, n - 1
    (q, _, _, do), (m, l, acc, lse, delta) = ring_case(dt, s_l, seed,
                                                       "fresh")
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    kv_all = torch.randn((TB, n * s_l, 2, TKV, TD), generator=g).to(
        "cuda", dt)
    shard = lambda i, j: kv_all[:, i * s_l:(i + 1) * s_l, j]
    q_off = rf.offsets(my, n, s_l, "contiguous")
    steps = [(shard(src, 0), shard(src, 1),
              rf.offsets(src, n, s_l, "contiguous"))
             for src in range(my, -1, -1)]
    lse = forward_lse(lse, q, [(k, k_off) for k, _, k_off in steps], q_off)
    dq = torch.zeros(q.shape, device="cuda")
    dk = torch.zeros(steps[0][0].shape, device="cuda")
    dv = torch.zeros_like(dk)

    def unit(which, plain: bool):
        def run():
            for k, v, k_off in steps:
                offs = (q_off, k_off, True, None)
                if which == "ring_fwd":
                    if plain:
                        rf.carry_fwd_plain(q, k, v, m, l, acc, *offs)
                    else:
                        rf.ring_fwd(q, k, v, m, l, acc, *offs)
                elif which == "ring_dq":
                    if plain:
                        rf.ring_dq_plain(q, k, v, do, lse, delta, *offs)
                    else:
                        rf.ring_dq(q, k, v, do, lse, delta, dq, *offs)
                elif plain:
                    rf.ring_dkv_plain(q, k, v, do, lse, delta, *offs)
                else:
                    rf.ring_dkv(q, k, v, do, lse, delta, dk, dv, *offs)
        return run

    # the yardstick: SDPA of q shard 3 over the whole sequence with the
    # global causal mask (forward, and backward through autograd yielding
    # dq, dk and dv together); the port never calls it
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2).detach()
    kt, vt = (kv_all[:, :, j].transpose(1, 2).detach() for j in (0, 1))
    q_ids = my * s_l + torch.arange(s_l, device="cuda")
    mask = torch.arange(n * s_l, device="cuda")[None, :] <= q_ids[:, None]
    sdpa_fwd = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    with torch.no_grad():
        lib_fwd = time_ms(sdpa_fwd)
        lib_fwd_q = time_ms(sdpa_fwd, queued=True)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    o_s = sdpa(qg, kg, vg, attn_mask=mask, enable_gqa=True)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(o_s, (qg, kg, vg), dot,
                                           retain_graph=True)
    lib_bwd = time_ms(sdpa_bwd)
    lib_bwd_q = time_ms(sdpa_bwd, queued=True)
    timings = {}
    for name in RING:
        p1 = time_ms(unit(name, True))
        k1 = time_ms(unit(name, False))
        k2 = time_ms(unit(name, False))
        p2 = time_ms(unit(name, True))
        # device time alone of the member's 4 launches, queued together
        kq = time_ms(unit(name, False), queued=True)
        bnd, by = bound_of([ring_launch_bound(
            name, dt, s_l, visible_pairs(q_off, k_off, s_l))
            for _, _, k_off in steps], dt)
        fwd = name == "ring_fwd"
        lib, lib_q = (lib_fwd, lib_fwd_q) if fwd else (lib_bwd, lib_bwd_q)
        timings[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             library_ms=lib, bound_ms=bnd, bound_by=by,
                             device_ms=kq, library_device_ms=lib_q)
        log(f"[{tag}] timing {name} bf16, member {my} of {n} over its "
            f"{len(steps)} live steps (B={TB} S_l={s_l} H={TH} KV={TKV} "
            f"D={TD}): kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} "
            f"ms, sdpa {'fwd' if fwd else 'bwd'} of the member's q over "
            f"S={n * s_l} {lib:.4f} ms, bound {bnd:.4f} ms ({by}); device "
            f"time alone: kernel {kq:.4f} ms, sdpa {lib_q:.4f} ms")
    pair = timings["ring_dq"]["device_ms"] + timings["ring_dkv"]["device_ms"]
    log(f"[{tag}] K3q + K3kv, device time alone: {pair:.4f} ms against "
        f"sdpa bwd {lib_bwd_q:.4f} ms ({pair / lib_bwd_q:.2f}x)")
    # one launch each at a past (full) step and at the diagonal
    for label, (k, v, k_off) in (("past step", steps[1]),
                                 ("diagonal", steps[0])):
        offs = (q_off, k_off, True, None)
        one = {"ring_fwd": lambda: rf.ring_fwd(q, k, v, m, l, acc, *offs),
               "ring_dq": lambda: rf.ring_dq(q, k, v, do, lse, delta, dq,
                                             *offs),
               "ring_dkv": lambda: rf.ring_dkv(q, k, v, do, lse, delta, dk,
                                               dv, *offs)}
        for name, fn in one.items():
            t = time_ms(fn)
            bnd, by = bound_of([ring_launch_bound(
                name, dt, s_l, visible_pairs(q_off, k_off, s_l))], dt)
            log(f"[{tag}] one {name} launch, {label}: {t:.4f} ms, bound "
                f"{bnd:.4f} ms ({by})")
    return timings


# --------------------------------------------------------- ring-train phase
def ring_live_pairs(n: int, s_l: int, layout: str, window=None) -> int:
    """(member, step) pairs of a causal ring with any visible pair: the
    launches of each K3 kernel per attention call."""
    from tf_operator_tpu_torch.ops import zigzag

    return sum(zigzag.pair_live(my, src, n, s_l, layout, window)
               for my in range(n) for src in range(n))


def ring_train_phase(first_loss: float) -> dict:
    """The train phase's run with attention through the ring: same seed
    weights, tokens and recipe."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models.llama import params_flops_per_token
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import ring_flash as rf
    from tf_operator_tpu_torch.parallel.ring import LocalRing
    from tf_operator_tpu_torch.runtime.loop import run_training
    from tf_operator_tpu_torch.runtime.profiler import Profiler

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ring = LocalRing(RING_N)
    cfg = llama3_train_cfg(attention_fn=rf.make_ring_flash_attention_fn(ring))
    model, state, step = train_model(cfg)
    torch.cuda.synchronize()
    log(f"[ring-train] llama3_8b tied, remat, ring flash attention over "
        f"{ring} (contiguous, S_l={TS // RING_N}), {cfg.n_layers} layers; "
        f"batch {TB} x {TS}")
    losses, times = [], []

    def timed_step(state, tokens):
        t = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return state, metrics

    batches = train_llama.lm_batches(TB, TS, cfg.vocab_size, SEED + 4,
                                     device="cuda")
    fa.reset_launches()
    rf.reset_launches()
    res = run_training(state, timed_step, batches, num_steps=TRAIN_STEPS,
                       profiler=Profiler(batch_size=TB), log_interval_steps=1,
                       metrics_sink=lambda line: log(f"[ring-train] metrics "
                                                     f"{line}"))
    torch.cuda.synchronize()
    launches, k2 = dict(rf.launches), dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    del model, state, step, res
    torch.cuda.empty_cache()

    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[ring-train] losses {losses}")
    # bf16 compute: attention's rounding points differ (p and dS rounded
    # per ring step instead of per flash tile), nothing else does
    if abs(losses[0] - first_loss) > 2e-2:
        raise AssertionError(f"[ring-train] first loss {losses[0]} differs "
                             f"from the train phase's {first_loss} by more "
                             f"than 2e-2")
    live = ring_live_pairs(RING_N, TS // RING_N, "contiguous")
    bwd = live * cfg.n_layers * TRAIN_STEPS
    # every bf16 K3f, K3q and K3kv launch on the tensor cores
    want = {"ring_fwd": 2 * bwd, "ring_fwd_mma": 2 * bwd, "ring_dq": bwd,
            "ring_dq_mma": bwd, "ring_dkv": bwd, "ring_dkv_mma": bwd}
    if launches != want or any(k2.values()):
        raise AssertionError(f"[ring-train] K3 launches {launches}, expected "
                             f"{want} ({live} live pairs per layer); K2 "
                             f"launches {k2}, expected none")
    steady = sorted(times[1:])
    step_s = steady[len(steady) // 2]
    tokens_per_s = TB * TS / step_s
    mfu = tokens_per_s * params_flops_per_token(cfg) / PEAK_OPS_PER_S[
        torch.bfloat16]
    log(f"[ring-train] losses {[round(x, 4) for x in losses]} (train "
        f"phase's first {first_loss:.4f}); step_s "
        f"{[round(x, 4) for x in times]}; steady step_s (median of steps "
        f"2-{TRAIN_STEPS}) {step_s:.4f}, tokens_per_s {tokens_per_s:.2f}, "
        f"mfu {mfu:.4f}, max_memory_allocated_gib {peak / 2**30:.3f}, "
        f"kernel_launches {json.dumps(launches)} ({live} live pairs per "
        f"layer), k2_launches {json.dumps(k2)}")
    return dict(launches=launches)


def ring_parity_phase() -> None:
    """2 layers at full width, f32: one step's loss and gradient norms
    through the zigzag ring on the card, the same ring on the CPU, and
    the one-device flash attention on the card."""
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import ring_flash as rf
    from tf_operator_tpu_torch.ops import zigzag
    from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss
    from tf_operator_tpu_torch.parallel.ring import LocalRing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq = 256
    ring_fn = rf.make_ring_flash_attention_fn(LocalRing(RING_N),
                                              layout="zigzag")
    perm = torch.from_numpy(zigzag.storage_perm(RING_N, seq))
    params = bridge.init_params(llama3_train_cfg(n_layers=2,
                                                 dtype=torch.float32),
                                SEED + 8, device="cuda", train=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    runs = {}
    fa.reset_launches()
    rf.reset_launches()
    for label, dev, attn in (("ring cuda", "cuda", ring_fn),
                             ("ring cpu", "cpu", ring_fn),
                             ("flash cuda", "cuda", fa.flash_attention)):
        cfg = llama3_train_cfg(n_layers=2, dtype=torch.float32,
                               attention_fn=attn)
        model = llama.Llama.from_params(
            cfg, {k: v.to(dev) for k, v in params.items()}, device=dev,
            train=True)
        if not runs:
            tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=g)
        loss = lm_blocked_loss(model, tokens.to(dev),
                               perm=perm if attn is ring_fn else None)
        loss.backward()
        runs[label] = (loss.item(), {
            k: torch.linalg.vector_norm(p.grad, dtype=torch.float64).item()
            for k, p in model.named_parameters()})
        del model
    k3, k2 = dict(rf.launches), dict(fa.launches)
    del params
    torch.cuda.empty_cache()
    l_ref, n_ref = runs["ring cuda"]
    worst_all = 0.0
    for label in ("ring cpu", "flash cuda"):
        l_o, n_o = runs[label]
        loss_rel = abs(l_ref - l_o) / abs(l_o)
        norm_rel = {k: abs(n_ref[k] - n_o[k]) / max(n_o[k], 1e-30)
                    for k in n_o}
        worst = max(norm_rel, key=norm_rel.get)
        worst_all = max(worst_all, norm_rel[worst])
        log(f"[ring-parity] 2 layers f32, batch 1 x {seq}, zigzag ring of "
            f"{RING_N}: loss ring cuda {l_ref:.7f} vs {label} {l_o:.7f} (rel "
            f"{loss_rel:.2e}, limit 1e-5); {len(norm_rel)} gradient norms, "
            f"worst rel {norm_rel[worst]:.2e} ({worst}, limit 1e-4)")
        if not (math.isfinite(l_ref) and loss_rel <= 1e-5
                and norm_rel[worst] <= 1e-4):
            raise AssertionError(f"[ring-parity] the ring on the card and "
                                 f"{label} disagree")
    live = ring_live_pairs(RING_N, seq // RING_N, "zigzag")
    # remat: the forward runs again in the backward pass
    want_k3 = {"ring_fwd": 2 * 2 * live, "ring_fwd_mma": 0,
               "ring_dq": 2 * live, "ring_dq_mma": 0, "ring_dkv": 2 * live,
               "ring_dkv_mma": 0}
    if k3 != want_k3 or k2 != F32_K2_LAUNCHES:
        raise AssertionError(f"[ring-parity] launches K3 {k3} (expected "
                             f"{want_k3}), K2 {k2}")
    log(f"[ring-parity] launches K3 {json.dumps(k3)}, K2 {json.dumps(k2)}")


def ring_entry_phase() -> None:
    """train_llama's --ring entry point on the card: a ring of one member
    (one process, --tp 1), every attention through K3."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import ring_flash as rf

    fa.reset_launches()
    rf.reset_launches()
    rc = train_llama.main(["--smoke", "--ring", "--steps", "2"])
    torch.cuda.synchronize()
    k3, k2 = dict(rf.launches), dict(fa.launches)
    # tiny: 2 layers, no remat, a ring of one member: one pair per layer;
    # bf16 compute (D = 16), so K3f, K3q and K3kv run on the tensor cores
    want = {"ring_fwd": 4, "ring_fwd_mma": 4, "ring_dq": 4, "ring_dq_mma": 4,
            "ring_dkv": 4, "ring_dkv_mma": 4}
    log(f"[entry] train_llama --smoke --ring --steps 2: exit {rc}, K3 "
        f"launches {json.dumps(k3)}, K2 {json.dumps(k2)}")
    if rc != 0 or k3 != want or any(k2.values()):
        raise AssertionError(f"[entry] exit {rc}, K3 {k3} (expected {want}), "
                             f"K2 {k2}")


ENTRY_PROMPTS = ["hello", "the quick brown fox", "hi"]


def _run_main(main, argv, tag: str = "entry-ckpt") -> str:
    """main(argv)'s standard output (it must exit 0); echoed to the log
    under `tag`."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[{tag}]   | {line}")
    if rc != 0:
        raise AssertionError(f"[{tag}] {argv}: exit {rc}")
    return out


def entry_ckpt_phase() -> None:
    """The CLIs on the card with records and checkpoints: two seeded .rec
    shards; train_llama --smoke --data-dir --ckpt-dir for 2 steps (a save
    a step), then for 4, which resumes from step 2; train_llama --smoke
    --model mistral (window 16 over 64 tokens through K2); serve_llama
    --smoke --ckpt-dir --paged, plain (K1) and with --int8-kv (K1q), and
    dense; generate_llama --smoke --ckpt-dir on each prompt: greedy tokens
    equal across dense, paged and generate (f32 smoke)."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from tf_operator_tpu_torch import generate_llama, serve_llama, train_llama
    from tf_operator_tpu_torch.data.loader import FieldSpec, write_records
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.ops import flash_attention as fa

    root = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    try:
        data, ckpt = f"{root}/data", f"{root}/ckpt"
        os.makedirs(data)
        rng = np.random.default_rng(SEED + 12)
        for i in range(2):  # the smoke model: 256 tokens, 64 a row
            write_records(f"{data}/part-{i}.rec",
                          [FieldSpec("tokens", (64,), "int32")],
                          {"tokens": rng.integers(0, 256, (16, 64))})
        argv = ["--smoke", "--data-dir", data, "--ckpt-dir", ckpt,
                "--save-interval", "1", "--steps"]
        out = _run_main(train_llama.main, argv + ["2"])
        if ("data: records x32 (shard 0/1)" not in out
                or "complete: steps=2 resumed_from=None" not in out):
            raise AssertionError("[entry-ckpt] first train run")
        out = _run_main(train_llama.main, argv + ["4"])
        if "complete: steps=2 resumed_from=2" not in out:
            raise AssertionError("[entry-ckpt] the second run did not "
                                 "resume from step 2")
        fa.reset_launches()
        out = _run_main(train_llama.main, ["--smoke", "--model", "mistral",
                                           "--steps", "2"])
        torch.cuda.synchronize()
        k2 = dict(fa.launches)
        # tiny: 2 layers, no remat, bf16 compute at D = 16: the tensor cores
        want = {n: 4 for n in fa.launches}
        if "model mistral (smoke)" not in out or k2 != want:
            raise AssertionError(f"[entry-ckpt] mistral smoke: K2 {k2}, "
                                 f"expected {want}")

        seen = []
        inner = serve_llama.serve_loop

        def recording(*a, **kw):
            res = inner(*a, **kw)
            seen.append([[int(t) for t in r.tokens] for r in res])
            return res

        serve_llama.serve_loop = recording
        try:
            serve = ["--smoke", "--ckpt-dir", ckpt, "--max-new", "16",
                     "--slots", "2"] + [a for p in ENTRY_PROMPTS
                                        for a in ("--prompt", p)]
            paged = ["--paged", "--block-size", "16"]
            launches = {}
            for label, extra in (("dense", []), ("paged", paged),
                                 ("paged int8-kv", paged + ["--int8-kv"])):
                pa.reset_launches()
                out = _run_main(serve_llama.main, serve + extra)
                torch.cuda.synchronize()
                launches[label] = (pa.launches, pa.launches_int8)
                if "restored step 4 from" not in out:
                    raise AssertionError(f"[entry-ckpt] serve {label}: no "
                                         f"restore line")
        finally:
            serve_llama.serve_loop = inner
        dense, paged_tokens, _ = seen
        gen = []
        for p in ENTRY_PROMPTS:
            out = _run_main(generate_llama.main, [
                "--smoke", "--ckpt-dir", ckpt, "--max-new", "16",
                "--prompt", p])
            line = [l for l in out.splitlines() if l.startswith("tokens: ")]
            gen.append(json.loads(line[-1][len("tokens: "):]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # generate keeps decoding past EOS; serve_loop stops at it
    same = all(g[:len(d)] == d for g, d in zip(gen, dense))
    if (dense != paged_tokens or not same
            or launches["dense"] != (0, 0) or launches["paged"][0] == 0
            or launches["paged"][1] != 0 or launches["paged int8-kv"][1] == 0
            or launches["paged int8-kv"][0] != 0):
        raise AssertionError(
            f"[entry-ckpt] dense {dense}, paged {paged_tokens}, generate "
            f"{gen}; K1/K1q launches {launches}")
    log(f"[entry-ckpt] train_llama resumed from step 2 over records; "
        f"mistral smoke K2 {json.dumps(k2)}; serve_llama dense = paged = "
        f"generate_llama tokens {dense}; (K1, K1q) launches "
        f"{json.dumps(launches)}; int8-KV tokens {seen[2]}")


# ---------------------------------------------------------- mixtral phases
# mixtral_8x7b on the card: the parity cut (2 layers, f32), serving at
# full depth with int8 weights, training at full width cut to 4 layers
MIX_PARITY_LAYERS, MIX_TRAIN_LAYERS, MIX_TRAIN_STEPS = 2, 4, 3
MIX_REQUESTS, MIX_NEW, MIX_CHUNK = 8, 32, 512


def _k1_line(launches: dict) -> str:
    return (f"K1 {launches['k1']} ({launches['k1_mma']} on the tensor "
            f"cores), K1q {launches['k1q']} ({launches['k1q_mma']})")


def _k1_counts() -> dict:
    from tf_operator_tpu_torch.models import paged_attention as pa

    torch.cuda.synchronize()
    return {"k1": pa.launches, "k1_mma": pa.launches_mma,
            "k1q": pa.launches_int8, "k1q_mma": pa.launches_int8_mma}


def mixtral_parity_phase() -> dict:
    """mixtral_8x7b at full width (8 experts of 14336, top-2), 2 layers,
    f32 (TF32 off), seeded weights on the card and their copy on the
    CPU: the sparse MoE forward (parallel/ep.grouped_moe) equals the
    dense dispatch (dense_switch_dispatch) on the card within 1e-4, at
    prefill and at a decode step; then paged serve_loop on the card (K1,
    K1q) gives the CPU's greedy tokens and schedule under the slot
    scheduler, the continuous one (prefill_chunk 16), with int8 KV, and
    speculatively with the first layer as the draft (accepted/proposed
    drafts too); continuous gives slot's tokens."""
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.parallel import ep

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.mixtral_8x7b(n_layers=MIX_PARITY_LAYERS, dtype=torch.float32)
    params = bridge.init_params(cfg, SEED + 51, device="cuda")
    m_gpu = llama.Llama.from_params(cfg, params, device="cuda")
    m_cpu = llama.Llama.from_params(
        cfg, {k: v.cpu() for k, v in params.items()}, device="cpu")
    del params
    d_gpu, d_cpu = early_exit_draft(m_gpu, 1), early_exit_draft(m_cpu, 1)

    # the sparse forward against the dense dispatch, same inputs, on the card
    moe = m_gpu.blocks[0].moe
    g = torch.Generator(device="cuda").manual_seed(SEED + 52)
    errs = {}
    with torch.inference_mode():
        for label, shape in (("prefill", (1, 64)), ("decode", (8, 1))):
            x = torch.randn(*shape, cfg.d_model, generator=g, device="cuda")
            logits = x @ moe.router
            want, aux_want = ep.dense_switch_dispatch(
                x, logits, moe.wi, moe.wo, activation="swiglu",
                dtype=cfg.dtype, top_k=cfg.moe_top_k)
            got, aux = ep.grouped_moe(x, logits, moe.wi, moe.wo,
                                      top_k=cfg.moe_top_k, dtype=cfg.dtype)
            errs[label] = (float((got - want).abs().max()),
                           float((aux - aux_want).abs()))
    log(f"[mixtral-parity] grouped (sparse) MoE vs dense_switch_dispatch on "
        f"cuda, f32, max abs err (out, aux): {json.dumps(errs)} (limit 1e-4)")
    if not all(o <= 1e-4 and a <= 1e-4 for o, a in errs.values()):
        raise AssertionError(f"[mixtral-parity] sparse != dense: {errs}")

    prompts = prompts_for(cfg, 3, 16, 48, SEED + 53)
    kw = dict(slots=2, max_new_tokens=[8, 12, 6], block_size=BS,
              steps_per_sync=4)
    sched = lambda rs: [(r.tokens, r.admitted_at_step, r.finished_at_step,
                         r.slot, r.accepted_drafts, r.proposed_drafts)
                        for r in rs]
    runs, launches = {}, {}
    for tag, extra in (("slot", {}),
                       ("continuous", dict(scheduler="continuous",
                                           prefill_chunk=16)),
                       ("int8-kv", dict(kv_quant=True)),
                       ("speculative", dict(spec_k=3))):
        spec = "spec_k" in extra
        pa.reset_launches()
        t0 = time.perf_counter()
        got = serve_loop(m_gpu, prompts, device="cuda",
                         draft=d_gpu if spec else None, **kw, **extra)
        launches[tag] = _k1_counts()
        t1 = time.perf_counter()
        want = serve_loop(m_cpu, prompts, device="cpu",
                          draft=d_cpu if spec else None, **kw, **extra)
        t2 = time.perf_counter()
        if sched(got) != sched(want):
            raise AssertionError(f"[mixtral-parity] ({tag}) cuda "
                                 f"{sched(got)} != cpu {sched(want)}")
        runs[tag] = got
        log(f"[mixtral-parity] ({tag}) tokens and schedule identical on "
            f"cuda and cpu: {[r.tokens for r in got]}; "
            f"{_k1_line(launches[tag])}; cuda {t1 - t0:.1f} s, cpu "
            f"{t2 - t1:.1f} s")
    if [r.tokens for r in runs["continuous"]] != \
            [r.tokens for r in runs["slot"]]:
        raise AssertionError("[mixtral-parity] continuous tokens differ from "
                             "slot tokens")
    if not (launches["slot"]["k1"] > 0 and launches["int8-kv"]["k1q"] > 0
            and launches["int8-kv"]["k1"] == 0):
        raise AssertionError(f"[mixtral-parity] launches {launches}")
    acc = [(r.accepted_drafts, r.proposed_drafts) for r in runs["speculative"]]
    log(f"[mixtral-parity] 2 layers f32 at full width: every run identical "
        f"on cuda and cpu, continuous == slot; speculative drafts "
        f"accepted/proposed {acc}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del m_gpu, m_cpu, d_gpu, d_cpu, moe
    torch.cuda.empty_cache()
    return dict(launches=sum(v["k1"] for v in launches.values()),
                launches_int8=launches["int8-kv"]["k1q"])


def mixtral_serve_model():
    """mixtral_8x7b at full depth and width, tied, int8 weights (the
    router in f32) drawn and quantized leaf by leaf on the card
    (bridge.init_int8_params: quantize_params of init_params(train=True)
    without the 186 GB f32 tree); returns (model, quantized_bytes, the
    build's seconds and memory peak)."""
    from tf_operator_tpu_torch.models import bridge, llama, quant

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama.mixtral_8x7b(tie_embeddings=True)
    t0 = time.perf_counter()
    params = bridge.init_int8_params(cfg, SEED, device="cuda")
    qbytes = quant.quantized_bytes(params)
    model = llama.Llama.from_params(cfg, params, device="cuda")
    del params
    torch.cuda.synchronize()
    return model, qbytes, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()


def mixtral_serve_phase() -> dict:
    """mixtral_8x7b at full depth (32 layers) and width, int8 weights,
    bf16 KV, tied: 8 prompts of 64-1024 tokens, 32 new each, greedy, 8
    slots, blocks of 16, under the slot scheduler and the continuous one
    (prefill_chunk 512).  K1 launches equal layers x model calls in each
    run, all on the tensor cores.  Prints tokens/s, TTFT p50/p99, TPOT,
    quantized_bytes, the memory peak, and the share of tokens on which
    the two schedulers agree (bf16 routing near ties may flip; equality
    is asserted in mixtral-parity)."""
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.models import paged_attention as pa

    model, qbytes, t_build, build_peak = mixtral_serve_model()
    cfg = model.cfg
    log(f"[mixtral-serve] mixtral_8x7b {cfg.n_layers} layers, "
        f"{cfg.n_experts} experts of {cfg.d_ff}, top-{cfg.moe_top_k}, int8 "
        f"weights drawn and quantized leaf by leaf in {t_build:.1f} s (peak "
        f"{build_peak / 2**30:.3f} GiB); quantized_bytes {qbytes} "
        f"({qbytes / 2**30:.3f} GiB), resident "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB; compute "
        f"{cfg.dtype}, KV bf16")
    prompts = prompts_for(cfg, MIX_REQUESTS, 64, MAX_CTX, SEED + 54)
    kw = dict(slots=8, block_size=BS, steps_per_sync=8, device="cuda",
              max_new_tokens=MIX_NEW)
    serve_loop(model, [p[:64] for p in prompts[:2]], **dict(
        kw, max_new_tokens=4))                       # warm-up
    calls = [0]
    hook = model.register_forward_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))
    out = {}
    try:
        for sched, extra in (("slot", {}),
                             ("continuous", dict(scheduler="continuous",
                                                 prefill_chunk=MIX_CHUNK))):
            calls[0] = 0
            torch.cuda.reset_peak_memory_stats()
            pa.reset_launches()
            results, stats = serve_loop(model, prompts, return_stats=True,
                                        **kw, **extra)
            k = _k1_counts()
            peak = torch.cuda.max_memory_allocated()
            if not (k["k1"] == cfg.n_layers * calls[0] > 0
                    and k["k1_mma"] == k["k1"] and k["k1q"] == 0):
                raise AssertionError(
                    f"[mixtral-serve] ({sched}) {_k1_line(k)} for "
                    f"{calls[0]} model calls x {cfg.n_layers} layers")
            for i, r in enumerate(results):
                if len(r.tokens) != MIX_NEW or not all(
                        0 <= t < cfg.vocab_size for t in r.tokens):
                    raise AssertionError(f"[mixtral-serve] ({sched}) request "
                                         f"{i}: tokens {r.tokens}")
            p50, p99 = ttft_pcts(stats)
            log(f"[mixtral-serve] ({sched}) tokens={stats.total_tokens} "
                f"wall_s={stats.wall_time_s:.4f} "
                f"tokens_per_s={stats.tokens_per_sec:.2f} "
                f"ttft_p50_s={p50:.4f} ttft_p99_s={p99:.4f} "
                f"prefill_s={stats.prefill_time_s:.4f} "
                f"decode_s={stats.decode_time_s:.4f} model_calls={calls[0]} "
                f"k1_launches={k['k1']} tensor_core_launches={k['k1_mma']} "
                f"quantized_bytes={qbytes} "
                f"max_memory_allocated_gib={peak / 2**30:.3f}")
            log(f"[mixtral-serve] ({sched}) telemetry: {tel_line(stats)}")
            out[sched] = (results, k["k1"])
    finally:
        hook.remove()
    a, b = ([r.tokens for r in out[s][0]] for s in ("slot", "continuous"))
    same = sum(x == y for ta, tb in zip(a, b) for x, y in zip(ta, tb))
    log(f"[mixtral-serve] slot and continuous agree on {same} of "
        f"{sum(map(len, a))} tokens ({same / sum(map(len, a)):.4f}); prompts "
        f"{[int(p.shape[0]) for p in prompts]}")
    del model
    torch.cuda.empty_cache()
    return dict(launches=out["slot"][1] + out["continuous"][1])


def route_probe(model, tokens, on_layer=None) -> list:
    """One no-grad forward of `model` over `tokens`, each MoE block's
    router logits [T, E] (f32, as the block computes them from its
    input) kept; `on_layer(i)` runs after block i's MoE forward."""
    logits, hooks = [], []
    for i, blk in enumerate(model.blocks):
        def hook(mod, args, out, i=i):
            logits.append((args[0].float() @ mod.router).reshape(
                -1, mod.router.shape[1]))
            if on_layer is not None:
                on_layer(i)
        hooks.append(blk.moe.register_forward_hook(hook))
    try:
        with torch.no_grad():
            model(tokens, return_hidden=True)
    finally:
        for h in hooks:
            h.remove()
    return logits


def ep_route_drops(logits: list, n_ep: int, factor: float,
                   top_k: int) -> list:
    """Per layer, [dropped, pairs, the top expert's share of the
    choices]: the layer's router logits [T, E] cut into n_ep contiguous
    blocks (T divides n_ep here), each routed by parallel/ep.topk_route
    at make_switch_moe's capacity, ceil(T / n_ep · k / E · factor)."""
    from tf_operator_tpu_torch.parallel.ep import topk_gates, topk_route

    out = []
    for lf in logits:
        t, n_e = lf.shape
        cap = max(1, math.ceil(t // n_ep * top_k / n_e * factor))
        dropped = 0
        for blk in lf.split(t // n_ep):
            dispatch, _, _ = topk_route(blk, cap, top_k)
            dropped += blk.shape[0] * top_k - int(dispatch.sum())
        _, top_i = topk_gates(torch.softmax(lf, dim=-1), top_k)
        load = torch.bincount(top_i.reshape(-1), minlength=n_e)
        out.append([dropped, t * top_k, int(load.max()) / (t * top_k)])
    return out


def mixtral_train_phase() -> dict:
    """mixtral_8x7b at full width cut to 4 layers as train_llama builds it
    (tied, remat, flash attention, blocked CE with the routers' aux
    loss), f32 masters, bf16 compute, adafactor, batch 1 x 2048, 3 steps
    through run_training: every loss finite, the first within 1.5 of
    ln(vocab); K2f launched 2 x 4 times a step, K2q and K2kv 4 times, all
    on the tensor cores.  Step seconds, tokens/s, MFU over the active
    FLOPs (router + top-2 experts: params_flops_per_token) and the
    memory peak."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.models.llama import params_flops_per_token
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops.flash_attention import flash_attention
    from tf_operator_tpu_torch.runtime.loop import run_training
    from tf_operator_tpu_torch.runtime.profiler import Profiler

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama.mixtral_8x7b(n_layers=MIX_TRAIN_LAYERS, tie_embeddings=True,
                             remat=True, attention_fn=flash_attention)
    t0 = time.perf_counter()
    model, state, step = train_model(cfg, SEED + 55)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[mixtral-train] mixtral_8x7b tied, remat, flash attention, "
        f"{cfg.n_layers} layers of {cfg.n_experts} experts (top-"
        f"{cfg.moe_top_k}), {n_params / 1e9:.4f} B f32 master params in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB); compute "
        f"{cfg.dtype}; batch {TB} x {TS}")
    losses, times = [], []

    def timed_step(state, tokens):
        t = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return state, metrics

    batches = train_llama.lm_batches(TB, TS, cfg.vocab_size, SEED + 56,
                                     device="cuda")
    # the ep job's first batch routed by this one-process model (no
    # dispatch function) at the ep job's per-block capacity
    (first,) = next(train_llama.lm_batches(TB, TS, cfg.vocab_size,
                                           SEED + 56, device="cuda"))
    ep_plain = ep_route_drops(route_probe(model, first), EP_MESH["ep"],
                              EP_FACTOR, cfg.moe_top_k)
    log(f"[mixtral-train] its router on the first batch, cut into "
        f"{EP_MESH['ep']} ep blocks at factor {EP_FACTOR} (topk_route), "
        f"[dropped, pairs, top expert's share of the choices] a layer: "
        f"{[[a, b, round(c, 4)] for a, b, c in ep_plain]}")
    fa.reset_launches()
    res = run_training(state, timed_step, batches,
                       num_steps=MIX_TRAIN_STEPS,
                       profiler=Profiler(batch_size=TB), log_interval_steps=1,
                       metrics_sink=lambda line: log(f"[mixtral-train] "
                                                     f"metrics {line}"))
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    aux = [float(b.moe.aux_loss.detach()) for b in model.blocks]
    del model, state, step, res
    torch.cuda.empty_cache()
    if len(losses) != MIX_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[mixtral-train] losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.5:
        raise AssertionError(f"[mixtral-train] first loss {losses[0]} is not "
                             f"within 1.5 of ln({cfg.vocab_size})")
    n = cfg.n_layers * MIX_TRAIN_STEPS
    want = {"flash_fwd": 2 * n, "flash_fwd_mma": 2 * n, "flash_dq": n,
            "flash_dq_mma": n, "flash_dkv": n, "flash_dkv_mma": n}
    if launches != want:
        raise AssertionError(f"[mixtral-train] kernel launches {launches}, "
                             f"expected {want}")
    steady = sorted(times[1:])
    step_s = steady[len(steady) // 2]
    tokens_per_s = TB * TS / step_s
    mfu = tokens_per_s * params_flops_per_token(cfg) / PEAK_OPS_PER_S[
        torch.bfloat16]
    log(f"[mixtral-train] losses {[round(x, 4) for x in losses]} "
        f"(ln V = {math.log(cfg.vocab_size):.4f}); last aux losses "
        f"{[round(x, 4) for x in aux]}; step_s "
        f"{[round(x, 4) for x in times]}; steady step_s (median of steps "
        f"2-{MIX_TRAIN_STEPS}) {step_s:.4f}, tokens_per_s "
        f"{tokens_per_s:.2f}, mfu {mfu:.4f} (active FLOPs), "
        f"max_memory_allocated_gib {peak / 2**30:.3f}, kernel_launches "
        f"{json.dumps(launches)}")
    return dict(launches=launches, losses=losses, ep_plain=ep_plain)


def entry_mixtral_phase() -> dict:
    """The CLIs with --model mixtral on the card: train_llama --smoke
    (4 experts, top-2, in every block) for 2 steps with a checkpoint;
    serve_llama --smoke --model mixtral --ckpt-dir --int8, dense and
    --paged (K1), and generate_llama --smoke --model mixtral --ckpt-dir
    --int8 on each prompt: greedy tokens equal across dense, paged and
    generate."""
    import shutil
    import tempfile

    from tf_operator_tpu_torch import generate_llama, serve_llama, train_llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.ops import flash_attention as fa

    root = tempfile.mkdtemp(prefix="chip_smoke_mixtral_")
    try:
        fa.reset_launches()
        out = _run_main(train_llama.main, [
            "--smoke", "--model", "mixtral", "--ckpt-dir", root,
            "--save-interval", "1", "--steps", "2", "--seq-len", "64"],
            "entry-mixtral")
        torch.cuda.synchronize()
        k2 = dict(fa.launches)
        want = {n: 4 for n in fa.launches}   # 2 layers x 2 steps, bf16
        if "model mixtral (smoke)" not in out or "complete: steps=2" \
                not in out or k2 != want:
            raise AssertionError(f"[entry-mixtral] train: K2 {k2}, "
                                 f"expected {want}")
        seen = []
        inner = serve_llama.serve_loop

        def recording(*a, **kw):
            res = inner(*a, **kw)
            seen.append([[int(t) for t in r.tokens] for r in res])
            return res

        serve_llama.serve_loop = recording
        base = ["--smoke", "--model", "mixtral", "--ckpt-dir", root,
                "--int8", "--max-new", "16"]
        launches = {}
        try:
            for label, extra in (("dense", []),
                                 ("paged", ["--paged", "--block-size",
                                            "16"])):
                pa.reset_launches()
                out = _run_main(serve_llama.main, base + [
                    "--slots", "2"] + extra + [
                        a for p in ENTRY_PROMPTS for a in ("--prompt", p)],
                    "entry-mixtral")
                launches[label] = _k1_counts()
                if "restored step 2 from" not in out or \
                        "weights: int8" not in out:
                    raise AssertionError(f"[entry-mixtral] serve {label}")
        finally:
            serve_llama.serve_loop = inner
        gen = []
        for p in ENTRY_PROMPTS:
            out = _run_main(generate_llama.main, base + ["--prompt", p],
                            "entry-mixtral")
            line = [l for l in out.splitlines() if l.startswith("tokens: ")]
            gen.append(json.loads(line[-1][len("tokens: "):]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    dense, paged = seen
    same = all(g[:len(d)] == d for g, d in zip(gen, dense))
    if (dense != paged or not same or launches["dense"]["k1"] != 0
            or launches["paged"]["k1"] == 0):
        raise AssertionError(f"[entry-mixtral] dense {dense}, paged {paged}, "
                             f"generate {gen}; launches {launches}")
    log(f"[entry-mixtral] train_llama --smoke --model mixtral K2 "
        f"{json.dumps(k2)}; serve_llama --int8 dense = paged = "
        f"generate_llama tokens {dense}; paged {_k1_line(launches['paged'])}")
    return dict(launches=launches["paged"]["k1"])


# ------------------------------------------ the BERT/T5 and vision model zoo
# kernel2-zoo's shapes, the attention of the two transformer configs as
# their training runs call it: bert_large (B=32, S=512, H=KV=16, D=64,
# non-causal) and t5_3b_decoder (B=8, S=512, H=KV=32, D=64, causal)
ZOO_FLASH = {"bert": dict(b=32, s=512, h=16, kv_heads=16, d=64, causal=False),
             "t5": dict(b=8, s=512, h=32, kv_heads=32, d=64, causal=True)}
ZOO_PARITY_STEPS = 3
BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 512, 4
T5_BATCH, T5_SEQ, T5_STEPS, T5_BLOCKED_STEPS = 8, 512, 3, 2
RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 256, 224, 4


def _zoo_parity_batches(cfg, kind: str, seed: int) -> list:
    """ZOO_PARITY_STEPS batches of 2 x 128 tokens on the CPU: (tokens,)
    for an LM, (inputs, labels) with train_bert's 15 % masking for MLM."""
    from tf_operator_tpu_torch import train_bert

    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for _ in range(ZOO_PARITY_STEPS):
        tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=g)
        if kind != "mlm":
            out.append((tokens,))
            continue
        mask = torch.rand((2, 128), generator=g) < 0.15
        out.append((torch.where(mask, train_bert.MASK_ID, tokens),
                    torch.where(mask, tokens, -100)))
    return out


def transformer_parity_phase() -> None:
    """The transformer family at full width, 2 layers, f32 (TF32 off),
    flash attention: a BERT-style model (masked-LM loss, adamw), the same
    with a mixture of experts in its second block, and the T5 decoder
    with remat (lm_train_loss, then the blocked CE; adafactor), each
    ZOO_PARITY_STEPS steps of 2 x 128 on the card (the scalar K2
    kernels) and on the CPU (their plain versions) from the same seeded
    weights: every step's loss within 1e-5 and every parameter's
    gradient norm within 1e-4, relative."""
    from tf_operator_tpu_torch import train_bert
    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.models.transformer_bridge import (
        init_transformer_params, transformer_from_params)
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss
    from tf_operator_tpu_torch.runtime.optim import Adafactor, AdamW
    from tf_operator_tpu_torch.runtime.train import TrainState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = dict(n_layers=2, dtype=torch.float32,
               attention_fn=fa.flash_attention)
    runs = [("bert", tfm.bert_large(**f32), "mlm"),
            ("bert-moe", tfm.bert_large(n_experts=4, **f32), "mlm"),
            ("t5", tfm.t5_3b_decoder(remat=True, **f32), "lm"),
            ("t5-blocked", tfm.t5_3b_decoder(remat=True, **f32), "blocked")]
    card = device_line()
    for i, (label, cfg, kind) in enumerate(runs):
        params = init_transformer_params(cfg, SEED + 71 + i, device="cpu")
        batches = _zoo_parity_batches(cfg, kind, SEED + 75 + i)
        fa.reset_launches()
        out = {}
        for dev in ("cuda", "cpu"):
            # a copy each: a CPU model would train `params` in place
            model = transformer_from_params(
                cfg, {k: v.clone() for k, v in params.items()}, device=dev)
            tx = AdamW(1e-4, weight_decay=0.01) if kind == "mlm" else \
                Adafactor(1e-3)
            state = TrainState.create(model, tx)
            losses, norms = [], []
            for batch in batches:
                batch = [t.to(dev) for t in batch]
                if kind == "mlm":
                    loss = train_bert.mlm_loss(model(batch[0]), batch[1])
                elif kind == "lm":
                    loss = tfm.lm_train_loss(model, batch[0])
                else:
                    loss = lm_blocked_loss(model, batch[0])
                loss.backward()
                losses.append(loss.item())
                # norms in f64 (train-parity: torch's f32 norm of a large
                # tensor on the CPU is off by more than the limit)
                norms.append({k: torch.linalg.vector_norm(
                    p.grad, dtype=torch.float64).item()
                    for k, p in model.named_parameters()})
                state.apply_gradients()
            out[dev] = (losses, norms)
            del model, state
        launches = dict(fa.launches)
        torch.cuda.empty_cache()
        (l_gpu, n_gpu), (l_cpu, n_cpu) = out["cuda"], out["cpu"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
        norm_rel, worst = 0.0, None
        for t, (ng, nc) in enumerate(zip(n_gpu, n_cpu)):
            for k in nc:
                r = abs(ng[k] - nc[k]) / max(nc[k], 1e-30)
                if r >= norm_rel:
                    norm_rel, worst = r, f"step {t + 1} {k}"
        n = cfg.n_layers * ZOO_PARITY_STEPS
        want = {"flash_fwd": (2 if cfg.remat else 1) * n, "flash_dq": n,
                "flash_dkv": n, "flash_fwd_mma": 0, "flash_dq_mma": 0,
                "flash_dkv_mma": 0}
        log(f"[transformer-parity] {label}: full width, {cfg.n_layers} "
            f"layers f32, batch 2 x 128, {ZOO_PARITY_STEPS} steps: losses "
            f"cuda {[round(x, 7) for x in l_gpu]} cpu "
            f"{[round(x, 7) for x in l_cpu]} (worst rel {loss_rel:.2e}, "
            f"limit 1e-5); {len(n_cpu[0])} gradient norms a step, worst "
            f"rel {norm_rel:.2e} ({worst}, limit 1e-4); launches "
            f"{json.dumps(launches)}; {card}")
        if not (all(map(math.isfinite, l_gpu)) and loss_rel <= 1e-5
                and norm_rel <= 1e-4):
            raise AssertionError(f"[transformer-parity] {label}: the card "
                                 f"and the CPU disagree")
        # f32: the scalar kernels, never the tensor cores (TF32)
        if launches != want:
            raise AssertionError(f"[transformer-parity] {label}: launches "
                                 f"{launches}, expected {want}")


def kernel2_zoo_phase(shapes=None, tag: str = "kernel2-zoo",
                      seed: int = SEED + 80) -> dict:
    """K2f, K2q and K2kv in bf16 at the shapes of `shapes` (default the
    two D=64 shapes of ZOO_FLASH; TP_FLASH's tp-local shapes as
    kernel2-tp) against their plain versions (the backward kernels on the plain
    forward's lse and delta): the elementwise band 2e-2 + 2e-2 |ref| and
    each output's relative error norm (WIN_NORM_TOL), two launches
    bit-equal; then each kernel's time beside its plain version, SDPA
    (forward, or its autograd backward for dQ and dK/dV together) and the
    bound (every visible pair: all S² non-causal), and the device time
    of the kernel and of SDPA alone."""
    from tf_operator_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    card = device_line()
    res = {}
    for i, (label, sh) in enumerate((shapes or ZOO_FLASH).items()):
        b, s, h, kvh, d, causal = (sh["b"], sh["s"], sh["h"],
                                   sh["kv_heads"], sh["d"], sh["causal"])
        q, k, v, do = flash_case(torch.bfloat16, s, seed + i, d, b, h,
                                 kvh)
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
        delta = flash_delta(out_p, do)
        bwd = (q, k, v, do, lse_p, delta, causal)
        want = {"flash_fwd": (out_p, lse_p),
                "flash_dq": (fa.flash_dq_plain(*bwd),),
                "flash_dkv": fa.flash_dkv_plain(*bwd)}
        runs = [{"flash_fwd": fa.flash_fwd(q, k, v, causal),
                 "flash_dq": (fa.flash_dq(*bwd),),
                 "flash_dkv": fa.flash_dkv(*bwd)} for _ in range(2)]
        torch.cuda.synchronize()
        errs, norms, line = {}, {}, []
        for name in FLASH:
            same = all(torch.equal(x, y)
                       for x, y in zip(runs[0][name], runs[1][name]))
            err, ok = 0.0, same
            for o, got, ref in zip(FLASH_OUTS[name], runs[0][name],
                                   want[name]):
                diff = (got.float() - ref.float()).abs()
                err = max(err, float(diff.max()))
                ok &= bool(torch.isfinite(got).all())
                ok &= bool((diff <= 2e-2 * (1 + ref.float().abs())).all())
                norms[o] = rel_l2(got, ref)
                ok &= norms[o] <= WIN_NORM_TOL[o]
            errs[name] = err
            line.append(f"{name} err={err:.3e} repeat={same}")
            if not ok:
                raise AssertionError(
                    f"[{tag}] {name} at {label}'s shape disagrees with "
                    f"its plain version or does not repeat: err={err} "
                    f"norms={norms} bit_identical={same}")
        log(f"[{tag}] {label}: bf16 B={b} S={s} H={h} KV={kvh} D={d} "
            f"causal={causal}: " + ", ".join(line) + "; rel_l2 "
            + json.dumps({o: float(f"{x:.3e}") for o, x in norms.items()})
            + f" (limits {json.dumps(WIN_NORM_TOL)})")
        del runs, want, bwd, out_p, lse_p

        out, lse = fa.flash_fwd(q, k, v, causal)
        delta = flash_delta(out, do)
        bwd = (q, k, v, do, lse, delta, causal)
        fns = {"flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                             lambda: fa.flash_fwd_plain(q, k, v, causal)),
               "flash_dq": (lambda: fa.flash_dq(*bwd),
                            lambda: fa.flash_dq_plain(*bwd)),
               "flash_dkv": (lambda: fa.flash_dkv(*bwd),
                             lambda: fa.flash_dkv_plain(*bwd))}
        qt, kt, vt = (x.transpose(1, 2).detach() for x in (q, k, v))
        gqa = h != kvh
        sdpa_fwd = lambda: sdpa(qt, kt, vt, is_causal=causal,
                                enable_gqa=gqa)
        with torch.no_grad():
            lib_fwd = time_ms(sdpa_fwd)
            lib_fwd_q = time_ms(sdpa_fwd, queued=True)
        qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
        o_s = sdpa(qg, kg, vg, is_causal=causal, enable_gqa=gqa)
        dot = do.transpose(1, 2)
        sdpa_bwd = lambda: torch.autograd.grad(o_s, (qg, kg, vg), dot,
                                               retain_graph=True)
        lib_bwd = time_ms(sdpa_bwd)
        lib_bwd_q = time_ms(sdpa_bwd, queued=True)
        timings = {}
        for name, (kern, plain) in fns.items():
            p1 = time_ms(plain, reps=5)
            k1 = time_ms(kern)
            k2 = time_ms(kern)
            p2 = time_ms(plain, reps=5)
            kq = time_ms(kern, queued=True)
            bnd, by = flash_bound_ms(name, torch.bfloat16, s, causal, None,
                                     b, h, kvh, d)
            fwd = name == "flash_fwd"
            lib, lib_q = (lib_fwd, lib_fwd_q) if fwd else (lib_bwd, lib_bwd_q)
            timings[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                                 library_ms=lib, bound_ms=bnd, bound_by=by,
                                 device_ms=kq, library_device_ms=lib_q)
            log(f"[{tag}] timing {name} {label} bf16 B={b} S={s} H={h} "
                f"KV={kvh} D={d} causal={causal}: kernel {k1:.4f}/{k2:.4f} "
                f"ms, plain {p1:.4f}/{p2:.4f} ms, sdpa "
                f"{'fwd' if fwd else 'bwd'} {lib:.4f} ms, bound {bnd:.4f} ms "
                f"({by}); device time alone: kernel {kq:.4f} ms, sdpa "
                f"{lib_q:.4f} ms; {card}")
        pair = timings["flash_dq"]["device_ms"] + \
            timings["flash_dkv"]["device_ms"]
        log(f"[{tag}] {label}: K2q + K2kv, device time alone: "
            f"{pair:.4f} ms against sdpa bwd {lib_bwd_q:.4f} ms "
            f"({pair / lib_bwd_q:.2f}x); K2f {timings['flash_fwd']['device_ms']:.4f}"
            f" ms against sdpa fwd {lib_fwd_q:.4f} ms "
            f"({timings['flash_fwd']['device_ms'] / lib_fwd_q:.2f}x)")
        res[label] = dict(errs=errs, norms=norms, timings=timings)
        del q, k, v, do, out, lse, bwd, fns, qg, kg, vg, o_s
        torch.cuda.empty_cache()
    return res


def _zoo_train(tag: str, step, state, batches, num_steps: int,
               batch_size: int, times: list, losses: list):
    """run_training over `step` to `num_steps` with every step timed and
    synchronized and its loss kept."""
    from tf_operator_tpu_torch.runtime.loop import run_training
    from tf_operator_tpu_torch.runtime.profiler import Profiler

    def timed_step(state, *batch):
        t = time.perf_counter()
        state, metrics = step(state, *batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return state, metrics

    return run_training(state, timed_step, batches, num_steps=num_steps,
                        profiler=Profiler(batch_size=batch_size),
                        log_interval_steps=1,
                        metrics_sink=lambda line: log(f"[{tag}] metrics "
                                                      f"{line}")).state


def _steady_s(times: list) -> float:
    """The median of the step times after the first."""
    steady = sorted(times[1:])
    return steady[len(steady) // 2]


def _k2_want(n_layers: int, steps: int) -> dict:
    """K2 launches of `steps` remat steps of bf16 blocks: the forward
    twice (forward and recompute), dQ and dK/dV once, all on the tensor
    cores."""
    n = n_layers * steps
    return {"flash_fwd": 2 * n, "flash_fwd_mma": 2 * n, "flash_dq": n,
            "flash_dq_mma": n, "flash_dkv": n, "flash_dkv_mma": n}


def _zoo_transformer(cfg, seed: int):
    from tf_operator_tpu_torch.models.transformer_bridge import (
        init_transformer_params, transformer_from_params)

    t0 = time.perf_counter()
    model = transformer_from_params(
        cfg, init_transformer_params(cfg, seed, device="cuda"),
        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    return model, n_params, time.perf_counter() - t0


def bert_train_phase() -> dict:
    """bert_large at full width and depth as train_bert builds it (remat,
    flash attention: K2 non-causal at D=64), f32 masters from a seed,
    bf16 compute, adamw, masked-LM batches of 32 x 512, BERT_STEPS steps
    through run_training: every loss finite, the first within 1.5 of
    ln(vocab); K2f launched 2 x 24 times a step, K2q and K2kv 24, all on
    the tensor cores; tokens/s, MFU (params_flops_per_token) and the
    memory peak."""
    from tf_operator_tpu_torch import train_bert
    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.runtime.optim import AdamW
    from tf_operator_tpu_torch.runtime.train import TrainState

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = tfm.bert_large(remat=True, attention_fn=fa.flash_attention)
    model, n_params, init_s = _zoo_transformer(cfg, SEED + 90)
    log(f"[bert-train] bert_large remat, flash attention, {cfg.n_layers} "
        f"layers, {n_params / 1e9:.4f} B f32 master params in {init_s:.1f} "
        f"s; compute {cfg.dtype}; batch {BERT_BATCH} x {BERT_SEQ}; adamw")
    state = TrainState.create(model, AdamW(1e-4, weight_decay=0.01))
    losses, times = [], []
    fa.reset_launches()
    step = train_bert.make_mlm_step(model)
    batches = train_bert.mlm_batches(BERT_BATCH, BERT_SEQ, cfg.vocab_size,
                                     SEED + 91, device="cuda")
    state = _zoo_train("bert-train", step, state, batches, BERT_STEPS,
                       BERT_BATCH, times, losses)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    # where a step's time goes (three more steps: warm, timed, profiled)
    _profile(lambda: step(state, *next(batches)), "bert-train step", 1)
    del model, state, step
    torch.cuda.empty_cache()
    if len(losses) != BERT_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[bert-train] losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.5:
        raise AssertionError(f"[bert-train] first loss {losses[0]} is not "
                             f"within 1.5 of ln({cfg.vocab_size})")
    want = _k2_want(cfg.n_layers, BERT_STEPS)
    if launches != want:
        raise AssertionError(f"[bert-train] kernel launches {launches}, "
                             f"expected {want}")
    step_s = _steady_s(times)
    tokens_per_s = BERT_BATCH * BERT_SEQ / step_s
    mfu = tokens_per_s * tfm.params_flops_per_token(cfg) / PEAK_OPS_PER_S[
        torch.bfloat16]
    log(f"[bert-train] losses {[round(x, 4) for x in losses]} (ln V = "
        f"{math.log(cfg.vocab_size):.4f}); step_s "
        f"{[round(x, 4) for x in times]}; steady step_s (median of steps "
        f"2-{BERT_STEPS}) {step_s:.4f}, tokens_per_s {tokens_per_s:.2f}, "
        f"mfu {mfu:.4f}, max_memory_allocated_gib {peak / 2**30:.3f}, "
        f"kernel_launches {json.dumps(launches)}; {device_line()}")
    return dict(launches=launches, losses=losses)


def t5_train_phase() -> dict:
    """t5_3b_decoder at full width and depth as train_t5 builds it (48
    layers, remat, flash attention: K2 causal at D=64), f32 masters from a
    seed (about 10 GB, and as much again of gradients), bf16 compute,
    adafactor, 8 x 512: T5_STEPS steps of lm_train_loss, then
    T5_BLOCKED_STEPS of the blocked CE on the same state, through
    run_training: losses finite, the first within 1.5 of ln(vocab); K2f
    launched 2 x 48 times a step, K2q and K2kv 48, all on the tensor
    cores; tokens/s and MFU of each loss, the memory peak."""
    from tf_operator_tpu_torch import train_t5
    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.runtime.optim import Adafactor
    from tf_operator_tpu_torch.runtime.train import TrainState

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = tfm.t5_3b_decoder(remat=True, attention_fn=fa.flash_attention)
    model, n_params, init_s = _zoo_transformer(cfg, SEED + 95)
    log(f"[t5-train] t5_3b_decoder remat, flash attention, {cfg.n_layers} "
        f"layers, {n_params / 1e9:.4f} B f32 master params in {init_s:.1f} "
        f"s ({torch.cuda.memory_allocated() / 2**30:.2f} GiB); compute "
        f"{cfg.dtype}; batch {T5_BATCH} x {T5_SEQ}; adafactor")
    state = TrainState.create(model, Adafactor(1e-3))
    batches = train_t5.lm_batches(T5_BATCH, T5_SEQ, cfg.vocab_size,
                                  SEED + 96, device="cuda")
    fa.reset_launches()
    runs = {}
    total = 0
    for label, blocked, steps in (("lm_train_loss", False, T5_STEPS),
                                  ("blocked_ce", True, T5_BLOCKED_STEPS)):
        losses, times = [], []
        total += steps
        state = _zoo_train("t5-train", train_t5.make_lm_step(
            model, blocked_ce=blocked), state, batches, total, T5_BATCH,
            times, losses)
        runs[label] = (losses, times)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    _profile(lambda: train_t5.make_lm_step(model)(state, *next(batches)),
             "t5-train step (lm_train_loss)", 1)
    del model, state
    torch.cuda.empty_cache()
    first = runs["lm_train_loss"][0][0]
    if not all(len(l) == n and all(map(math.isfinite, l)) for (l, _), n in
               zip(runs.values(), (T5_STEPS, T5_BLOCKED_STEPS))):
        raise AssertionError(f"[t5-train] losses {runs}")
    if abs(first - math.log(cfg.vocab_size)) > 1.5:
        raise AssertionError(f"[t5-train] first loss {first} is not within "
                             f"1.5 of ln({cfg.vocab_size})")
    want = _k2_want(cfg.n_layers, T5_STEPS + T5_BLOCKED_STEPS)
    if launches != want:
        raise AssertionError(f"[t5-train] kernel launches {launches}, "
                             f"expected {want}")
    card = device_line()
    for label, (losses, times) in runs.items():
        # the blocked steps' first is a steady step too: the model is warm
        step_s = (_steady_s(times) if label == "lm_train_loss"
                  else sorted(times)[len(times) // 2])
        tokens_per_s = T5_BATCH * T5_SEQ / step_s
        mfu = tokens_per_s * tfm.params_flops_per_token(cfg) / \
            PEAK_OPS_PER_S[torch.bfloat16]
        log(f"[t5-train] {label}: losses {[round(x, 4) for x in losses]} "
            f"(ln V = {math.log(cfg.vocab_size):.4f}); step_s "
            f"{[round(x, 4) for x in times]}; steady step_s {step_s:.4f}, "
            f"tokens_per_s {tokens_per_s:.2f}, mfu {mfu:.4f}; {card}")
    log(f"[t5-train] max_memory_allocated_gib {peak / 2**30:.3f}, "
        f"kernel_launches {json.dumps(launches)}")
    return dict(launches=launches, first_loss=first, peak_gib=peak / 2**30)


class _GradNorms:
    """An optimizer wrapper that keeps each step's gradient norms (f64)
    before the optimizer consumes the gradients."""

    def __init__(self, tx) -> None:
        self.tx, self.norms = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update_(self, params, state):
        self.norms.append({k: torch.linalg.vector_norm(
            p.grad, dtype=torch.float64).item() for k, p in params.items()})
        return self.tx.update_(params, state)


def vision_parity_phase() -> None:
    """A small f32 ResNet (4 stages of 1 block, width 16, 64² images,
    SGD with momentum) and MnistCNN (28², adam) on the card (cuDNN, TF32
    off) and on the CPU from the same seeded weights: the training-mode
    logits within 1e-4 (relative error norm) and the running stats
    within 1e-5; then 2 steps of make_train_step: losses within 1e-5,
    every gradient norm of each step within 1e-4 (as train-parity), the
    running stats after them within 1e-5, and, under SGD, whose update
    is linear in the gradient, each parameter's update within 1e-3
    (relative error norm).  Adam's first update is about lr·sign(g), so
    an element whose gradient is near zero flips between the two on
    rounding: its updates are not compared."""
    from tf_operator_tpu_torch.models import flax_layers
    from tf_operator_tpu_torch.models.mnist import MnistCNN
    from tf_operator_tpu_torch.models.resnet import ResNet
    from tf_operator_tpu_torch.runtime.optim import SGD, Adam
    from tf_operator_tpu_torch.runtime.train import (
        TrainState, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_line()
    cases = [("resnet", lambda: ResNet(stage_sizes=[1, 1, 1, 1], width=16,
                                       num_classes=10, dtype=torch.float32),
              lambda: SGD(0.1, momentum=0.9), (8, 64, 64, 3)),
             ("mnist-cnn", lambda: MnistCNN(dtype=torch.float32),
              lambda: Adam(1e-3), (8, 28, 28, 1))]

    def rel(a, b):
        return float((a.double() - b.double()).norm()
                     / b.double().norm().clamp_min(1e-30))

    for i, (label, build_model, opt, shape) in enumerate(cases):
        g = torch.Generator(device="cpu").manual_seed(SEED + 110 + i)
        batches = [(torch.randn(shape, generator=g),
                    torch.randint(0, 10, (shape[0],), generator=g))
                   for _ in range(3)]
        start = flax_layers.init_(build_model(), SEED + 115 + i,
                                  "cpu").state_dict()
        out = {}
        for dev in ("cuda", "cpu"):
            model = build_model()
            model.load_state_dict(start)
            model.to(dev).train()
            with torch.no_grad():
                logits = model(batches[0][0].to(dev)).cpu()
            stats = {k: b.cpu().clone() for k, b in model.named_buffers()}
            tx = _GradNorms(opt())
            state = TrainState.create(model, tx)
            step = make_train_step(model)
            losses = []
            for x, y in batches[1:]:
                state, m = step(state, x.to(dev), y.to(dev))
                losses.append(float(m["loss"]))
            out[dev] = (logits, stats, losses, tx.norms,
                        {k: v.detach().cpu() for k, v in
                         model.state_dict().items()})
            del model, state
        (lg, sg, lossg, ng, endg), (lc, sc, lossc, nc, endc) = \
            out["cuda"], out["cpu"]
        logit_rel = rel(lg, lc)
        stat_err = max([float((sg[k] - sc[k]).abs().max()) for k in sc]
                       + [float((endg[k] - endc[k]).abs().max()) for k in sc]
                       or [0.0])
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lossg, lossc))
        norm_rel = max(abs(a[k] - b[k]) / max(b[k], 1e-30)
                       for a, b in zip(ng, nc) for k in b)
        sgd = label == "resnet"
        upd_rel = max((rel(endg[k] - start[k], endc[k] - start[k])
                       for k in endc if k not in sc), default=0.0) \
            if sgd else None
        log(f"[vision-parity] {label} f32 {shape}: logits rel "
            f"{logit_rel:.2e} (limit 1e-4); batch stats max err "
            f"{stat_err:.2e} over {len(sc)} buffers (limit 1e-5); losses "
            f"cuda {lossg} cpu {lossc} (rel {loss_rel:.2e}, limit 1e-5); "
            f"{len(nc[0])} gradient norms a step, worst rel {norm_rel:.2e} "
            f"(limit 1e-4)"
            + (f"; parameter updates worst rel {upd_rel:.2e} (limit 1e-3)"
               if sgd else "") + f"; {card}")
        if not (logit_rel <= 1e-4 and stat_err <= 1e-5 and loss_rel <= 1e-5
                and norm_rel <= 1e-4 and (not sgd or upd_rel <= 1e-3)):
            raise AssertionError(f"[vision-parity] {label}: the card and "
                                 f"the CPU disagree")


def resnet_train_phase() -> dict:
    """ResNet50 at the JAX defaults as train_resnet builds it (bf16
    convolutions on cuDNN in channels_last, flax's BatchNorm), seeded,
    SGD(0.1, momentum 0.9), synthetic 256 x 224² bf16 batches,
    RESNET_STEPS steps through run_training: losses finite, the first
    within 1.5 of ln(1000), every running stat finite; images/s, MFU (3 x
    flops_per_image x images/s over the bf16 peak) and the memory peak.
    Then __graft_entry__.entry()'s flagship forward on the port: a seeded
    ResNet50 in eval mode over 8 x 224² bf16 images, timed."""
    from tf_operator_tpu_torch import train_resnet
    from tf_operator_tpu_torch.models.resnet import ResNet50, flops_per_image
    from tf_operator_tpu_torch.runtime.optim import SGD
    from tf_operator_tpu_torch.runtime.train import (
        create_train_state, make_train_step)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ResNet50(num_classes=1000)
    sample = torch.zeros((RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3),
                         dtype=torch.bfloat16)
    state = create_train_state(model, sample, SGD(0.1, momentum=0.9),
                               seed=SEED + 100, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[resnet-train] ResNet50, {n_params / 1e6:.3f} M f32 params, "
        f"{len(state.batch_stats)} running stats, in "
        f"{time.perf_counter() - t0:.1f} s; compute bf16 channels_last; "
        f"batch {RESNET_BATCH} x {RESNET_IMAGE}²; sgd momentum 0.9")
    losses, times = [], []
    step = make_train_step(model)
    batches = train_resnet.synthetic_imagenet(RESNET_BATCH, RESNET_IMAGE,
                                              SEED + 101, device="cuda")
    state = _zoo_train("resnet-train", step, state, batches, RESNET_STEPS,
                       RESNET_BATCH, times, losses)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    _profile(lambda: step(state, *next(batches)), "resnet-train step", 1)
    finite = all(bool(torch.isfinite(b).all())
                 for b in state.batch_stats.values())
    moved = sum(not torch.equal(b, torch.zeros_like(b))
                for k, b in state.batch_stats.items() if k.endswith(".mean"))
    del model, state
    torch.cuda.empty_cache()
    if len(losses) != RESNET_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[resnet-train] losses {losses}")
    if abs(losses[0] - math.log(1000)) > 1.5:
        raise AssertionError(f"[resnet-train] first loss {losses[0]} is not "
                             f"within 1.5 of ln(1000)")
    if not finite or moved == 0:
        raise AssertionError(f"[resnet-train] batch stats finite={finite}, "
                             f"{moved} means moved")
    step_s = _steady_s(times)
    images_per_s = RESNET_BATCH / step_s
    mfu = 3 * flops_per_image(RESNET_IMAGE) * images_per_s / \
        PEAK_OPS_PER_S[torch.bfloat16]
    card = device_line()
    log(f"[resnet-train] losses {[round(x, 4) for x in losses]} (ln 1000 = "
        f"{math.log(1000):.4f}); step_s {[round(x, 4) for x in times]}; "
        f"steady step_s (median of steps 2-{RESNET_STEPS}) {step_s:.4f}, "
        f"images_per_s {images_per_s:.2f}, mfu {mfu:.4f}, "
        f"max_memory_allocated_gib {peak / 2**30:.3f}; batch stats finite, "
        f"{moved} running means moved; {card}")

    # __graft_entry__.entry(): ResNet50 forward, eval mode, 8 x 224² bf16
    flagship = ResNet50(num_classes=1000)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    images = torch.randn((8, 224, 224, 3), generator=g, device="cuda",
                         dtype=torch.bfloat16)
    create_train_state(flagship, images, SGD(0.1), seed=SEED, device="cuda")
    flagship.eval()
    with torch.no_grad():
        logits = flagship(images)
        ms = time_ms(lambda: flagship(images))
        # its device time: under the profiler (its host enqueue, about
        # 160 launches, outlasts time_ms's checked hold)
        _profile(lambda: flagship(images), "flagship forward", 1)
    if logits.shape != (8, 1000) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[resnet-train] flagship forward {logits.shape}")
    log(f"[resnet-train] flagship forward (the entry point's ResNet50, eval, "
        f"8 x 224² bf16): {ms:.4f} ms ({8 / ms * 1e3:.1f} images/s); logits "
        f"finite; {card}")
    del flagship, images
    torch.cuda.empty_cache()
    return dict(images_per_s=images_per_s, mfu=mfu)


def entry_zoo_phase() -> None:
    """The five CLIs on the card: train_bert --smoke; train_t5 --smoke
    --blocked-ce --ckpt-dir (a save a step) for 2 steps, then to 3,
    resuming from 2; train_resnet at 64² x 8 for 2 steps, synthetic and
    from two seeded .rec shards of (uint8 image, label) records;
    train_mnist for 2 steps; train_dist_mnist as a worker and as a ps
    under TF_CONFIG."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from tf_operator_tpu_torch import (
        train_bert, train_dist_mnist, train_mnist, train_resnet, train_t5)
    from tf_operator_tpu_torch.data.loader import FieldSpec, write_records

    root = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    saved = os.environ.get("TF_CONFIG")
    try:
        out = _run_main(train_bert.main, ["--smoke", "--steps", "2"],
                        "entry-zoo")
        if "done: steps=2 loss=" not in out or "device cuda" not in out:
            raise AssertionError("[entry-zoo] train_bert")
        ckpt = os.path.join(root, "t5")
        t5 = ["--smoke", "--blocked-ce", "--ckpt-dir", ckpt,
              "--save-interval", "1"]
        out = _run_main(train_t5.main, t5 + ["--steps", "2"], "entry-zoo")
        if "complete: steps=2 resumed_from=None" not in out:
            raise AssertionError("[entry-zoo] train_t5")
        out = _run_main(train_t5.main, t5 + ["--steps", "3"], "entry-zoo")
        if "complete: steps=1 resumed_from=2" not in out:
            raise AssertionError("[entry-zoo] train_t5 resume")
        resnet = ["--image-size", "64", "--per-host-batch", "8", "--steps",
                  "2"]
        out = _run_main(train_resnet.main, resnet, "entry-zoo")
        if "data: synthetic" not in out or \
                "done: steps=2 preempted=False" not in out:
            raise AssertionError("[entry-zoo] train_resnet")
        data = os.path.join(root, "images")
        os.makedirs(data)
        rng = np.random.default_rng(SEED + 120)
        fields = [FieldSpec("image", (64, 64, 3), np.uint8),
                  FieldSpec("label", (), np.int32)]
        for i in range(2):
            write_records(os.path.join(data, f"shard-{i}.rec"), fields, {
                "image": rng.integers(0, 256, (16, 64, 64, 3)).astype(
                    np.uint8),
                "label": rng.integers(0, 1000, (16,)).astype(np.int32)})
        out = _run_main(train_resnet.main, resnet + ["--data-dir", data],
                        "entry-zoo")
        if "data: records x32 (shard 0/1)" not in out or \
                "done: steps=2 preempted=False" not in out:
            raise AssertionError("[entry-zoo] train_resnet --data-dir")
        out = _run_main(train_mnist.main, ["--steps", "2"], "entry-zoo")
        if "done: steps=2 loss=" not in out:
            raise AssertionError("[entry-zoo] train_mnist")
        cluster = {"ps": ["ps-0:2222"], "worker": ["worker-0:2222"]}
        for role, want in (("worker", "worker 0 done: steps=2"),
                           ("ps", "ps replica: parameter serving")):
            os.environ["TF_CONFIG"] = json.dumps(
                {"cluster": cluster, "task": {"type": role, "index": 0}})
            out = _run_main(train_dist_mnist.main, ["--steps", "2"],
                            "entry-zoo")
            if want not in out:
                raise AssertionError(f"[entry-zoo] train_dist_mnist {role}")
    finally:
        if saved is None:
            os.environ.pop("TF_CONFIG", None)
        else:
            os.environ["TF_CONFIG"] = saved
        shutil.rmtree(root, ignore_errors=True)
    log(f"[entry-zoo] train_bert, train_t5 (blocked CE, resumed from 2), "
        f"train_resnet (synthetic and records), train_mnist and "
        f"train_dist_mnist (worker, ps) ran on the card; {device_line()}")


# ------------------------------------------------------------------- LoRA
LORA_RANK, LORA_ALPHA, LORA_STEPS, LORA_LR = 16, 16.0, 4, 1e-4


def _checksum(t: torch.Tensor) -> tuple:
    """(sum, 2-norm) of a tensor in f64: equal bits give equal sums."""
    return (torch.sum(t, dtype=torch.float64).item(),
            torch.linalg.vector_norm(t, dtype=torch.float64).item())


def lora_expected(cfg, rank: int) -> tuple:
    """(adapters, adapter parameters) of DEFAULT_TARGETS on a dense
    llama config, from the kernels' shapes: per layer wq [E, H·D], wkv
    [E, 2·KV·D], out [H·D, E], wi [E, 2F], wo [F, E], each r·(in + out)."""
    e, hd = cfg.d_model, cfg.head_dim
    kernels = [(e, cfg.n_heads * hd), (e, 2 * cfg.n_kv_heads * hd),
               (cfg.n_heads * hd, e), (e, 2 * cfg.d_ff), (cfg.d_ff, e)]
    per_layer = sum(rank * (i + o) for i, o in kernels)
    return len(kernels) * cfg.n_layers, per_layer * cfg.n_layers


def lora_flops(cfg, rank: int) -> dict:
    """A LoRA step's FLOPs on the tied llama with the adapters on every
    projection, as (FLOPs a token, FLOPs a step besides).

    "model": the work of the finetune itself.  Each frozen matmul
    parameter (the adapted kernels and the tied head) costs 4 a token:
    the forward and the input gradient, with no weight gradient.  Each
    adapter parameter costs 6, as in full training.  Forming A@B once a
    step costs 2·r·in·out a kernel.  MFU is counted over these.

    "executed": what the parametrization runs besides.  The products run
    on W + s·A@B, and the adapters' gradients come from that weight's
    gradient, so each adapted kernel costs 6 a token; forming A@B and
    its two gradients costs 6·r·in·out a step.

    Remat's recompute is counted in neither."""
    from tf_operator_tpu_torch.models.llama import params_flops_per_token

    vocab = cfg.vocab_size * cfg.d_model
    matmul = params_flops_per_token(cfg) / 6.0
    adapted = matmul - vocab  # Σ in·out over the adapted kernels
    _, n_lora = lora_expected(cfg, rank)
    return dict(model=(4.0 * matmul + 6.0 * n_lora, 2.0 * rank * adapted),
                executed=(6.0 * adapted + 4.0 * vocab, 6.0 * rank * adapted))


def lora_train_phase() -> dict:
    """The slice's full-width path: llama3_8b at full width and depth as
    train_llama builds it (tied, remat, K2 flash attention), f32 masters
    from a seed, frozen; rank-16 adapters (alpha 16) on every projection
    attached (models/lora), Adam(1e-4) over the adapters alone, batch
    1 x 2048, LORA_STEPS steps through run_training.  Checks: the adapter
    count and size from the shapes, the optimizer's moments 2 x the
    adapters, the base kept once (same storage, no copy), the first
    step's loss = the base model's on that batch (B = 0), every loss
    finite, K2f 2 x 32 a step and K2q/K2kv 32, all on the tensor cores;
    one more step's device time by kernel class and idle share
    (torch.profiler); every base weight unchanged (f64 checksums, bit
    for bit); then the
    adapters merged in place (lora.merge_into) give the attached model's
    final hidden states within the bf16 tolerance (max abs diff <= 2e-2
    x max |h|) and its loss within 1e-3.  Prints step time, tokens/s,
    MFU (lora_flops) and the memory peak."""
    import itertools

    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import bridge, llama, lora
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss
    from tf_operator_tpu_torch.runtime.optim import Adam
    from tf_operator_tpu_torch.runtime.train import TrainState

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama3_train_cfg()
    t0 = time.perf_counter()
    model = llama.Llama.from_params(
        cfg, bridge.init_params(cfg, SEED + 160, device="cuda", train=True),
        device="cuda", train=True)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    init_s = time.perf_counter() - t0
    sums = {k: _checksum(v) for k, v in model.state_dict().items()}
    ptrs = {k: v.data_ptr() for k, v in model.state_dict().items()}
    batches = train_llama.lm_batches(TB, TS, cfg.vocab_size, SEED + 161,
                                     device="cuda")
    first = next(batches)
    with torch.no_grad():
        base_loss = float(lm_blocked_loss(model, *first))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 162)
    params = lora.attach(model, lora.init(gen, model.state_dict(),
                                          rank=LORA_RANK), alpha=LORA_ALPHA)
    state = TrainState.create(model, Adam(LORA_LR), params=params)
    torch.cuda.synchronize()
    n_adapters = len(params) // 2
    n_lora = sum(p.numel() for p in params.values())
    moments = sum(t.numel() for m in ("mu", "nu")
                  for t in state.opt_state[m].values())
    added = torch.cuda.memory_allocated() - base_mem
    want_n, want_p = lora_expected(cfg, LORA_RANK)
    log(f"[lora-train] llama3_8b tied, remat, flash attention, "
        f"{cfg.n_layers} layers, base {base_mem / 2**30:.2f} GiB f32 frozen "
        f"(drawn in {init_s:.1f} s); {n_adapters} adapters of rank "
        f"{LORA_RANK} (alpha {LORA_ALPHA}), {n_lora} adapter params, "
        f"adam moments {moments}; attach + optimizer state added "
        f"{added / 2**20:.1f} MiB; batch {TB} x {TS}")
    if (n_adapters, n_lora) != (want_n, want_p) or moments != 2 * n_lora:
        raise AssertionError(f"[lora-train] {n_adapters} adapters, {n_lora} "
                             f"params, {moments} moments; expected "
                             f"{want_n}, {want_p}, {2 * want_p}")
    # one copy of the base: the originals are the drawn tensors, and the
    # attach added the adapters and their moments alone (f32: 3 x 4 B)
    if any(v.data_ptr() != ptrs[k]
           for k, v in lora.base_params(model).items()) or \
            added > 3 * 4 * n_lora + (64 << 20):
        raise AssertionError(f"[lora-train] the base was copied "
                             f"({added} bytes added)")
    losses, times = [], []
    step = train_llama.make_lm_step(model)

    def timed_step(state, tokens):
        t = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return state, metrics

    fa.reset_launches()
    res = run_training_quiet(state, timed_step,
                             itertools.chain([first], batches), LORA_STEPS,
                             "lora-train")
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    # where a step's time goes (three more steps: warm, timed, profiled)
    _profile(lambda: step(state, *next(batches)), "lora-train step", 1)
    changed = [k for k, v in lora.base_params(model).items()
               if _checksum(v) != sums[k]]
    moved = sum(bool(p.any()) for k, p in params.items() if k.endswith(".b"))
    with torch.no_grad():
        h_att = model(first[0], return_hidden=True)
        loss_att = float(lm_blocked_loss(model, first[0]))
        lora.merge_into(model)
        h_mrg = model(first[0], return_hidden=True)
        loss_mrg = float(lm_blocked_loss(model, first[0]))
        h_err = float((h_att.float() - h_mrg.float()).abs().max())
        h_max = float(h_att.float().abs().max())
    del model, state, step, res, params, h_att, h_mrg
    torch.cuda.empty_cache()

    if len(losses) != LORA_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[lora-train] losses {losses}")
    if abs(losses[0] - base_loss) > 1e-6 * abs(base_loss):
        raise AssertionError(f"[lora-train] first loss {losses[0]} is not "
                             f"the base model's {base_loss} (B = 0)")
    want = _k2_want(cfg.n_layers, LORA_STEPS)
    if launches != want:
        raise AssertionError(f"[lora-train] kernel launches {launches}, "
                             f"expected {want}")
    if changed or moved != n_adapters:
        raise AssertionError(f"[lora-train] base leaves changed: "
                             f"{changed[:5]}; {moved} of {n_adapters} B moved")
    if h_err > 2e-2 * h_max or abs(loss_mrg - loss_att) > 1e-3 * loss_att:
        raise AssertionError(f"[lora-train] merged model: hidden max abs "
                             f"diff {h_err} (max |h| {h_max}), loss "
                             f"{loss_mrg} vs attached {loss_att}")
    step_s = _steady_s(times)
    tokens_per_s = TB * TS / step_s
    flops = {k: per_token * TB * TS + per_step
             for k, (per_token, per_step) in lora_flops(cfg,
                                                        LORA_RANK).items()}
    peak_ops = PEAK_OPS_PER_S[torch.bfloat16]
    mfu = flops["model"] / step_s / peak_ops
    executed = flops["executed"] / step_s / peak_ops
    log(f"[lora-train] losses {[round(x, 4) for x in losses]} (base loss on "
        f"the first batch {base_loss:.6f}); step_s "
        f"{[round(x, 4) for x in times]}; steady step_s (median of steps "
        f"2-{LORA_STEPS}) {step_s:.4f}, tokens_per_s {tokens_per_s:.2f}, "
        f"mfu {mfu:.4f} (model FLOPs {flops['model'] / 1e12:.3f} T a "
        f"step; executed {flops['executed'] / 1e12:.3f} T a step, "
        f"{executed:.4f} of peak), max_memory_allocated_gib "
        f"{peak / 2**30:.3f}, kernel_launches {json.dumps(launches)}; base "
        f"unchanged ({len(sums)} leaves, f64 checksums); merged in place: "
        f"hidden max abs diff {h_err:.3e} (max |h| {h_max:.3f}), loss "
        f"{loss_mrg:.6f} vs attached {loss_att:.6f}; {device_line()}")
    return dict(launches=launches, losses=losses, step_s=step_s,
                tokens_per_s=tokens_per_s, mfu=mfu, executed_share=executed)


def run_training_quiet(state, step, batches, num_steps: int, tag: str):
    from tf_operator_tpu_torch.runtime.loop import run_training
    from tf_operator_tpu_torch.runtime.profiler import Profiler

    return run_training(state, step, batches, num_steps=num_steps,
                        profiler=Profiler(batch_size=TB),
                        log_interval_steps=1,
                        metrics_sink=lambda line: log(f"[{tag}] metrics "
                                                      f"{line}"))


def lora_parity_phase() -> None:
    """llama3_8b at full width, 2 layers, f32 (TF32 off), tied, remat, K2
    (the scalar f32 kernels), rank-16 adapters with a random B (so A's
    gradient is not zero) attached on the card and on the CPU from the
    same draws, batch 2 x 128: the loss within 1e-5 and every adapter's
    gradient norm (f64) within 1e-4 relative, as the train-parity
    phase holds a full step's."""
    from tf_operator_tpu_torch.models import bridge, llama, lora
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_train_cfg(n_layers=2, dtype=torch.float32)
    params = bridge.init_params(cfg, SEED + 163, device="cpu", train=True)
    gen = torch.Generator().manual_seed(SEED + 164)
    adapters = lora.init(gen, params, rank=LORA_RANK)
    for ad in adapters.values():
        ad["b"].normal_(0.0, 0.02, generator=gen)
    g = torch.Generator(device="cpu").manual_seed(SEED + 165)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=g)
    fa.reset_launches()
    out = {}
    for dev in ("cuda", "cpu"):
        model = llama.Llama.from_params(cfg, params, device=dev, train=True)
        ps = lora.attach(model, adapters, alpha=LORA_ALPHA)
        loss = lm_blocked_loss(model, tokens.to(dev))
        loss.backward()
        out[dev] = (loss.item(), {
            k: torch.linalg.vector_norm(p.grad, dtype=torch.float64).item()
            for k, p in ps.items()})
        del model, ps, loss
    launches = dict(fa.launches)
    torch.cuda.empty_cache()
    (l_gpu, n_gpu), (l_cpu, n_cpu) = out["cuda"], out["cpu"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    norm_rel = {k: abs(n_gpu[k] - n_cpu[k]) / max(n_cpu[k], 1e-30)
                for k in n_cpu}
    worst = max(norm_rel, key=norm_rel.get)
    log(f"[lora-parity] 2 layers f32, {len(adapters)} adapters of rank "
        f"{LORA_RANK}, batch 2 x 128: loss cuda {l_gpu:.7f} cpu {l_cpu:.7f} "
        f"(rel {loss_rel:.2e}, limit 1e-5); {len(norm_rel)} adapter "
        f"gradient norms, worst rel {norm_rel[worst]:.2e} ({worst}, limit "
        f"1e-4); launches {json.dumps(launches)}")
    if not (math.isfinite(l_gpu) and loss_rel <= 1e-5
            and norm_rel[worst] <= 1e-4 and min(n_cpu.values()) > 0):
        raise AssertionError("[lora-parity] the card and the CPU disagree")
    if launches != F32_K2_LAUNCHES:
        raise AssertionError(f"[lora-parity] launches {launches}")


# ------------------------------------------------------- data parallelism
# dp-parity's f32 ResNet-50 (images a rank, image side) and f32 bert tiny
# (sequences of 64 a rank)
DP_RESNET_B, DP_RESNET_S, DP_BERT_B = 8, 64, 4
# the jobs a dp worker runs: (entry point, argv, f32 swap); {ckpt} is the
# worker's checkpoint directory; the swap names the entry point's model
# factory that the worker rebuilds in f32 (DP_F32)
DP_JOBS = {
    "resnet": ("train_resnet", ["--steps", "3", "--per-host-batch", "128",
                                "--image-size", "224"], None),
    "bert": ("train_bert", ["--steps", "3", "--per-host-batch", "16",
                            "--seq-len", "512"], None),
    "llama": ("train_llama", ["--smoke", "--steps", "2", "--per-host-batch",
                              "2", "--ckpt-dir", "{ckpt}",
                              "--save-interval", "1"], "llama"),
    "llama-resume": ("train_llama", ["--smoke", "--steps", "3",
                                     "--per-host-batch", "2", "--ckpt-dir",
                                     "{ckpt}", "--save-interval", "1"],
                     "llama"),
    "mixtral": ("train_llama", ["--smoke", "--model", "mixtral", "--steps",
                                "2", "--per-host-batch", "2"], "llama"),
    "resnet-f32": ("train_resnet", ["--steps", "2", "--per-host-batch",
                                    str(DP_RESNET_B), "--image-size",
                                    str(DP_RESNET_S)], "resnet"),
    "bert-f32": ("train_bert", ["--smoke", "--steps", "2",
                                "--per-host-batch", str(DP_BERT_B),
                                "--seq-len", "64"], "transformer"),
}
# (attribute of the entry point, module of the port, factory) a swap
# replaces with the factory at dtype f32
DP_F32 = {"llama": ("tiny", "models.llama", "tiny"),
          "transformer": ("tiny", "models.transformer", "tiny"),
          "resnet": ("ResNet50", "models.resnet", "ResNet50")}
# a job name ending in LOCAL runs that job with every batch statistic
# taken over the rank's own rows (dp.replicas(None)): the fault the
# global-batch statistics exist to avoid, which dp-parity must catch
LOCAL = "-local"


def dp_worker(out_dir: str, jobs: list) -> int:
    """One rank of a two-rank job on the card (`python3 chip_smoke.py
    --dp-worker DIR JOB...`, the PyTorchJob env set by _spawn_dp): each
    job is its entry point's main() over gloo, with parallel/dp's
    gradient mean, metrics mean and replicate_ wrapped to record every
    step's global gradient norm (f64, after the mean), the all-reduce's
    seconds, the global loss and the model; K2's launches are read
    around each job.  A job named <job>-local runs <job> with
    dp.replicas(None) (local batch statistics).  Writes
    DIR/rank<r>.pt."""
    import functools
    import importlib
    import os

    import torch.distributed as dist

    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel import dp

    rec = {}
    real = {n: getattr(dp, n) for n in
            ("mean_gradients_", "mean_metrics", "replicate_", "replicas")}

    def mean_gradients_(params, group):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real["mean_gradients_"](params, group)
        torch.cuda.synchronize()
        rec["reduce_s"].append(time.perf_counter() - t)
        rec["stamps"].append(time.perf_counter())
        rec["gnorm"].append(math.sqrt(sum(
            torch.linalg.vector_norm(p.grad, dtype=torch.float64).item() ** 2
            for p in params.values() if p.grad is not None)))

    def mean_metrics(metrics, group):
        out = real["mean_metrics"](metrics, group)
        rec["loss"].append(float(out["loss"]))
        return out

    def replicate_(module):
        rec["module"] = module
        return real["replicate_"](module)

    dp.mean_gradients_, dp.mean_metrics = mean_gradients_, mean_metrics
    dp.replicate_ = replicate_
    # no TF32, as the reference process runs after lora-parity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    results = {}
    for job in jobs:
        local = job.endswith(LOCAL)
        name, argv, f32 = DP_JOBS[job.removesuffix(LOCAL)]
        argv = [a.format(ckpt=os.path.join(out_dir, "ckpt")) for a in argv]
        mod = importlib.import_module(f"tf_operator_tpu_torch.{name}")
        if f32:
            attr, src, fn = DP_F32[f32]
            factory = getattr(importlib.import_module(
                f"tf_operator_tpu_torch.{src}"), fn)
            setattr(mod, attr, functools.partial(factory,
                                                 dtype=torch.float32))
        dp.replicas = ((lambda group: real["replicas"](None)) if local
                       else real["replicas"])
        rec.clear()
        rec.update(reduce_s=[], stamps=[], gnorm=[], loss=[])
        fa.reset_launches()
        t0 = time.perf_counter()
        rc = mod.main(argv + ["--backend", "gloo"])
        torch.cuda.synchronize()
        results[job] = dict(
            rc=rc, wall_s=time.perf_counter() - t0, loss=rec["loss"],
            gnorm=rec["gnorm"], reduce_s=rec["reduce_s"],
            stamps=rec["stamps"], launches=dict(fa.launches),
            state={k: v.detach().cpu()
                   for k, v in rec["module"].state_dict().items()})
        print(f"[dp-worker] rank {rank} {job}: exit {rc}", flush=True)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _spawn_dp(jobs: list, tag: str, timeout_s: float = 400.0):
    """Two ranks of dp_worker on the one card (_spawn_ranks)."""
    return _spawn_ranks("--dp-worker", jobs, tag, 2, timeout_s)


def _whole(gens: list):
    """Each step's batch of every rank's rows: rank 0's first."""
    while True:
        parts = [next(g) for g in gens]
        yield tuple(torch.cat(ts) for ts in zip(*parts))


def _dp_readings(tag: str, ranks: list, job: str, ref: dict) -> dict:
    """Rank 0's losses, gradient norms, buffers and parameters against
    one process on the whole batch: worst relative loss and gradient
    norm, worst buffer difference over 1 + |ref|, worst parameter
    difference (and its tensor), the parameter elements off by more than
    1e-5, the error of the steps' update over all parameters relative
    to the update (2-norms, f64); and the tensors on which the two ranks
    differ."""
    r0, r1 = (r[job] for r in ranks)
    if r0["rc"] != 0 or r1["rc"] != 0:
        raise AssertionError(f"[{tag}] {job}: exit {r0['rc']} / {r1['rc']}")
    if len(r0["loss"]) != len(ref["loss"]):
        raise AssertionError(f"[{tag}] {job}: {len(r0['loss'])} steps, "
                             f"expected {len(ref['loss'])}")
    unequal = [k for k in r0["state"]
               if not torch.equal(r0["state"][k], r1["state"][k])]
    loss = max(abs(a - b) / abs(b) for a, b in zip(r0["loss"], ref["loss"]))
    gnorm = max(abs(a - b) / b for a, b in zip(r0["gnorm"], ref["gnorm"]))
    stats = max([float(((r0["state"][k] - v).abs() / (1 + v.abs())).max())
                 for k, v in ref["stats"].items()] or [0.0])
    diffs = {k: (r0["state"][k] - v).double()
             for k, v in ref["params"].items()}
    worst = max(diffs, key=lambda k: float(diffs[k].abs().max()))
    off = sum(int((d.abs() > 1e-5).sum()) for d in diffs.values())
    moved = math.sqrt(sum(
        float(torch.sum((v.double() - ref["start"][k]) ** 2))
        for k, v in ref["params"].items()))
    update = math.sqrt(sum(float(torch.sum(d * d))
                           for d in diffs.values())) / moved
    return dict(loss=loss, gnorm=gnorm, stats=stats,
                params=float(diffs[worst].abs().max()), worst=worst, off=off,
                update=update, unequal=unequal)


def _compare_dp(tag: str, ranks: list, job: str, ref: dict,
                tol: dict) -> dict:
    """Both ranks' parameters and buffers bit-equal, and rank 0's losses,
    gradient norms and buffers against one process on the whole batch
    within `tol` ({"loss", "gnorm"} relative, "stats" max abs over
    1 + |ref|)."""
    r0 = ranks[0][job]
    out = _dp_readings(tag, ranks, job, ref)
    unequal, loss, gnorm, stats, params, worst = (
        out.pop("unequal"), out["loss"], out["gnorm"], out["stats"],
        out["params"], out.pop("worst"))
    log(f"[{tag}] {job}: ranks bit-equal: {not unequal} ({len(r0['state'])} "
        f"tensors); losses {[round(x, 6) for x in r0['loss']]} vs one "
        f"process {[round(x, 6) for x in ref['loss']]} (worst rel "
        f"{loss:.2e}, limit {tol['loss']}); gradient norms "
        f"{[round(x, 6) for x in r0['gnorm']]} vs "
        f"{[round(x, 6) for x in ref['gnorm']]} (worst rel {gnorm:.2e}, "
        f"limit {tol['gnorm']}); running stats worst {stats:.2e} (limit "
        f"{tol['stats']}); parameters max abs diff {params:.2e} ({worst}; "
        f"{out['off']} elements over 1e-5), update rel err "
        f"{out['update']:.2e}")
    if unequal or loss > tol["loss"] or gnorm > tol["gnorm"] or \
            stats > tol["stats"]:
        raise AssertionError(f"[{tag}] {job}: two ranks and one process "
                             f"disagree (unequal {unequal[:3]})")
    return out


class _Recorder:
    """An optimizer wrapper that keeps each step's global gradient norm
    (f64) before the optimizer consumes the gradients."""

    def __init__(self, tx) -> None:
        self.tx, self.norms = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update_(self, params, state):
        self.norms.append(math.sqrt(sum(
            torch.linalg.vector_norm(p.grad, dtype=torch.float64).item() ** 2
            for p in params.values() if p.grad is not None)))
        return self.tx.update_(params, state)


def _reference_run(model, state_tx, step, batches, steps: int) -> dict:
    losses = []
    state = state_tx
    start = {k: v.detach().cpu().clone()
             for k, v in model.named_parameters()}
    for _ in range(steps):
        state, m = step(state, *next(batches))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    buffers = {k for k, _ in model.named_buffers()}
    return dict(loss=losses, gnorm=state.tx.norms, start=start,
                params={k: v for k, v in sd.items() if k not in buffers},
                stats={k: v for k, v in sd.items() if k in buffers})


def _dp_rates(tag: str, res: dict, global_batch: int, unit: str) -> dict:
    """Steady step seconds (median of the intervals between the
    gradient means after the first), the global rate and the
    all-reduce's seconds a step (median over steps 2+)."""
    stamps = res["stamps"]
    steps = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    step_s = steps[len(steps) // 2]
    red = sorted(res["reduce_s"][1:])
    reduce_s = red[len(red) // 2]
    rate = global_batch / step_s
    log(f"[{tag}] two ranks on one card over gloo: step_s "
        f"{[round(x, 4) for x in steps]} (median {step_s:.4f}), {unit} "
        f"{rate:.2f} (global batch {global_batch}), all-reduce "
        f"{[round(x, 4) for x in res['reduce_s']]} s a step (median of "
        f"steps 2+ {reduce_s:.4f}), K2 launches a rank "
        f"{json.dumps(res['launches'])}")
    return dict(step_s=step_s, rate=rate, reduce_s=reduce_s)


def dp_train_phase() -> dict:
    """train_resnet (ResNet50, 128 x 224² a rank: the flagship's 256
    global) and train_bert (bert_large at full width and depth, 16 x 512
    a rank) as jobs of two ranks on the one card, spawned through the
    entry points with the PyTorchJob env and --backend gloo, 3 steps
    each; held against one process on the whole batch (rank 0's rows,
    then rank 1's; the same seeded weights and optimizer): every step's
    loss within 1e-3 and global gradient norm within 5e-3 (bf16 compute,
    whose products take other algorithms at another batch), ResNet's
    running stats within 5e-3 of 1 + |ref|; both ranks' parameters and
    buffers bit-equal.  At these sizes batch statistics taken locally
    would stay within such limits: dp-parity holds them in f32.  bert's
    K2 launches a rank: 2 x 24 a step forward, 24 dQ and 24 dK/dV, all
    on the tensor cores.  Prints images/s,
    tokens/s and the all-reduce's seconds a step: both ranks share one
    card, so these are the collective's cost, not scaling."""
    from tf_operator_tpu_torch import train_bert, train_resnet
    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.models.resnet import ResNet50
    from tf_operator_tpu_torch.models.transformer_bridge import (
        init_transformer_params, transformer_from_params)
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.runtime.optim import SGD, AdamW
    from tf_operator_tpu_torch.runtime.train import (
        TrainState, create_train_state, make_train_step)

    torch.cuda.empty_cache()
    ranks, _ = _spawn_dp(["resnet", "bert"], "dp-train")
    tol = dict(loss=1e-3, gnorm=5e-3, stats=5e-3)

    model = ResNet50(num_classes=1000)
    sample = torch.zeros((128, 224, 224, 3), dtype=torch.bfloat16)
    state = create_train_state(model, sample,
                               _Recorder(SGD(0.1 * 2, momentum=0.9)), seed=0,
                               device="cuda")
    batches = _whole([train_resnet.synthetic_imagenet(128, 224, r,
                                                      device="cuda")
                      for r in range(2)])
    ref = _reference_run(model, state, make_train_step(model),
                         batches, 3)
    del model, state, batches
    torch.cuda.empty_cache()
    resnet = _compare_dp("dp-train", ranks, "resnet", ref, tol)
    resnet.update(_dp_rates("dp-train", ranks[0]["resnet"], 256,
                            "images_per_s"))

    cfg = tfm.bert_large(remat=True, attention_fn=fa.flash_attention)
    model = transformer_from_params(
        cfg, init_transformer_params(cfg, 0, device="cuda"), device="cuda")
    state = TrainState.create(model, _Recorder(AdamW(1e-4,
                                                     weight_decay=0.01)))
    batches = _whole([train_bert.mlm_batches(16, 512, cfg.vocab_size, r,
                                             device="cuda")
                      for r in range(2)])
    ref = _reference_run(model, state,
                         train_bert.make_mlm_step(model),
                         batches, 3)
    del model, state, batches
    torch.cuda.empty_cache()
    bert = _compare_dp("dp-train", ranks, "bert", ref, tol)
    bert.update(_dp_rates("dp-train", ranks[0]["bert"], 32 * 512,
                          "tokens_per_s"))
    want = _k2_want(cfg.n_layers, 3)
    for r, res in enumerate(ranks):
        if res["bert"]["launches"] != want or \
                res["resnet"]["launches"].get("flash_fwd", 0):
            raise AssertionError(f"[dp-train] rank {r} K2 launches "
                                 f"{res['bert']['launches']}, expected "
                                 f"{want}")
    log(f"[dp-train] {device_line()}")
    return dict(resnet=resnet, bert=bert,
                launches=ranks[0]["bert"]["launches"])


def dp_parity_phase() -> dict:
    """Jobs of two ranks on the card over gloo, each held against one
    process on the whole batch in f32 (TF32 off): train_llama --smoke
    (the tiny tied model) and --smoke --model mixtral (4 experts, top-2:
    the aux loss over the global tokens), 2 steps; train_resnet with
    ResNet-50 in f32 at DP_RESNET_B x DP_RESNET_S² a rank (BatchNorm's
    statistics and running stats over the global batch) and train_bert
    --smoke in f32 at DP_BERT_B x 64 a rank (the masked-LM mean over the
    global masked count, which differs from rank to rank), 2 steps.
    Every loss and global gradient norm within 1e-5 relative, ResNet's
    running stats within 1e-5 of 1 + |ref| (other buffers equal), both
    ranks bit-equal; parameters within 1e-5, but ResNet's by the steps'
    update within 1e-3 relative (2-norm over all parameters): a ReLU or
    max-pool input within rounding of its edge goes either way with the
    convolutions' algorithm, and moves one element by lr x its gradient
    (1.41e-4 on two elements of 25.6 M with cuDNN's deterministic
    algorithms).  The ResNet and BERT jobs run again with local batch
    statistics (dp.replicas(None)), and each must then miss a limit by
    more than 10x: the fault these limits exist to catch.  The first
    llama job checkpoints every step (rank 0 writes) and a second
    resumes both ranks from step 2 to 3.  Returns the readings."""
    from tf_operator_tpu_torch import train_bert, train_llama, train_resnet
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.models.resnet import ResNet50
    from tf_operator_tpu_torch.models.transformer_bridge import (
        init_transformer_params, transformer_from_params)
    from tf_operator_tpu_torch.ops.flash_attention import flash_attention
    from tf_operator_tpu_torch.runtime.optim import SGD, Adafactor, AdamW
    from tf_operator_tpu_torch.runtime.train import (
        TrainState, create_train_state, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ranks, steps = _spawn_dp(["llama", "llama-resume", "mixtral",
                              "resnet-f32", "bert-f32", "resnet-f32" + LOCAL,
                              "bert-f32" + LOCAL], "dp-parity")
    tol = dict(loss=1e-5, gnorm=1e-5, stats=1e-5)
    refs = {}
    for job, extra in (("llama", {}), ("mixtral", train_llama.SMOKE_MOE)):
        cfg = llama.tiny(tie_embeddings=True, dtype=torch.float32,
                         attention_fn=flash_attention, **extra)
        model = llama.Llama.from_params(
            cfg, bridge.init_params(cfg, 0, device="cuda", train=True),
            device="cuda", train=True)
        state = TrainState.create(model, _Recorder(Adafactor(1e-3)))
        batches = _whole([train_llama.lm_batches(2, cfg.max_len,
                                                 cfg.vocab_size, r,
                                                 device="cuda")
                          for r in range(2)])
        refs[job] = _reference_run(model, state,
                                   train_llama.make_lm_step(model),
                                   batches, 2)
    model = ResNet50(num_classes=1000, dtype=torch.float32)
    sample = torch.zeros((DP_RESNET_B, DP_RESNET_S, DP_RESNET_S, 3),
                         dtype=torch.bfloat16)
    state = create_train_state(model, sample,
                               _Recorder(SGD(0.1 * 2, momentum=0.9)), seed=0,
                               device="cuda")
    batches = _whole([train_resnet.synthetic_imagenet(
        DP_RESNET_B, DP_RESNET_S, r, device="cuda") for r in range(2)])
    refs["resnet-f32"] = _reference_run(model, state, make_train_step(model),
                                        batches, 2)
    cfg = tfm.tiny(dtype=torch.float32)
    model = transformer_from_params(
        cfg, init_transformer_params(cfg, 0, device="cuda"), device="cuda")
    state = TrainState.create(model, _Recorder(AdamW(1e-4,
                                                     weight_decay=0.01)))
    batches = _whole([train_bert.mlm_batches(DP_BERT_B, 64, cfg.vocab_size,
                                             r, device="cuda")
                      for r in range(2)])
    refs["bert-f32"] = _reference_run(model, state,
                                      train_bert.make_mlm_step(model),
                                      batches, 2)
    del model, state, batches
    torch.cuda.empty_cache()

    out = {}
    for job, ref in refs.items():
        # only ResNet carries buffers a step changes: elsewhere they match
        got = _compare_dp("dp-parity", ranks, job, ref,
                          tol if job == "resnet-f32" else dict(tol, stats=0.0))
        if (got["update"] > 1e-3 if job == "resnet-f32"
                else got["params"] > 1e-5):
            raise AssertionError(f"[dp-parity] {job}: parameters "
                                 f"{got['params']} (update rel err "
                                 f"{got['update']})")
        out[job] = got
    for job in ("resnet-f32", "bert-f32"):
        bad = _dp_readings("dp-parity", ranks, job + LOCAL, refs[job])
        worst = max(bad[k] / tol[k] for k in tol)
        log(f"[dp-parity] {job} with local batch statistics (the fault): "
            f"worst rel loss {bad['loss']:.2e}, gradient norm "
            f"{bad['gnorm']:.2e}, running stats {bad['stats']:.2e}, "
            f"update rel err {bad['update']:.2e}; "
            f"{worst:.1f} x its limit; ranks differ on "
            f"{len(bad.pop('unequal'))} tensors")
        if worst <= 10:
            raise AssertionError(f"[dp-parity] {job}: local batch "
                                 f"statistics pass the limits {tol}")
        out[job + LOCAL] = bad
    resumed = [len(r["llama-resume"]["loss"]) for r in ranks]
    if steps != ["1", "2", "3"] or resumed != [1, 1]:
        raise AssertionError(f"[dp-parity] checkpoint steps {steps}, "
                             f"resumed steps a rank {resumed}")
    log(f"[dp-parity] rank 0 wrote steps {steps}; both ranks resumed from "
        f"step 2 and ran 1 step; {device_line()}")
    return out


# ----------------------------------------------------------- profile phase
# --------------------------------------------------------------- sharded
# the tp x fsdp x dp training mesh (parallel/mesh, parallel/tp,
# parallel/placement).  Two or more ranks share the one card over gloo.
# Two steps each: the first loss against one process's and one steady
# step; gloo through a shared host makes each step slow and its time
# variable, and the script's time limit is fixed.
SHARDED_STEPS = 2
T5_MESH = {"tp": 2, "fsdp": 2}
PROBE_BYTES = 16 << 20
# K2 at the tp-local shapes the sharded-train phase gives it: llama3_8b's
# 32 query / 8 kv heads and t5_3b_decoder's 32 heads over tp = 2
TP_FLASH = {"llama3_tp2": dict(b=TB, s=TS, h=16, kv_heads=4, d=128,
                               causal=True),
            "t5_tp2": dict(b=4, s=512, h=16, kv_heads=16, d=64,
                           causal=True)}
# the CPU tests' cases (tests/torch_sharded_util.py) in f32 on the card:
# tag -> (case, mesh axes, keyword arguments)
SHARDED_PARITY = {
    "llama": ("llama", {"tp": 2, "fsdp": 2, "dp": 2}, {}),
    "llama_adam": ("llama", {"tp": 2, "fsdp": 2, "dp": 2},
                   dict(tied=False, opt="adam", min_fsdp_size=2**14)),
    "blocked_ce": ("transformer", {"tp": 2, "fsdp": 2, "dp": 2},
                   dict(opt="adam", blocked_chunk=64,
                        cfg_kw=dict(vocab_size=192, max_len=16))),
    "lora": ("llama", {"tp": 2, "fsdp": 2, "dp": 2},
             dict(tied=False, opt="adam", min_fsdp_size=2**14,
                  lora_rank=2)),
    "t5_adamw": ("transformer", {"tp": 2, "fsdp": 2, "dp": 2},
                 dict(opt="adamw")),
    "t5_adafactor": ("transformer", {"tp": 2, "fsdp": 2, "dp": 2}, {}),
    "mixtral": ("llama", {"tp": 2, "fsdp": 2, "dp": 2}, dict(moe=True)),
    "tp4_wkv": ("llama", {"tp": 4, "fsdp": 2}, dict(d_ff=256)),
    "train_step": ("train_step", {"tp": 2, "fsdp": 2, "dp": 2}, {}),
    # the ring over tp (one process: flash attention), and the experts
    # over ep with a capacity that drops (one process: the oracle of
    # JAX's ep semantics, tests/torch_sharded_util.ep_oracle)
    "ring_tp": ("llama", {"tp": 2, "fsdp": 2, "dp": 2}, dict(ring=True)),
    "mixtral_ep": ("llama", {"tp": 2, "ep": 2, "dp": 2},
                   dict(moe=True, ep=(2, 1.0))),
}
ADAM_CASES = ("llama_adam", "blocked_ce", "lora", "t5_adamw", "train_step")
# the pipelines' cases (tests/torch_pipeline_util.pipeline_case):
# __graft_entry__.py's three pipeline meshes and the windowed pipelined
# llama, each against its sequential witness in one process
PIPE_CASE = "tests.torch_pipeline_util:pipeline_case"
PIPE_PARITY = {
    "pipe_pp_tp": ({"pp": 2, "tp": 2, "dp": 2}, dict(kind="lm")),
    "pipe_pp_fsdp": ({"pp": 2, "fsdp": 2, "dp": 2}, dict(kind="lm")),
    "pipe_pp_ep": ({"pp": 2, "ep": 2, "dp": 2},
                   dict(kind="lm", cfg_kw=dict(n_experts=4), factor=4.0)),
    "pipe_llama_window": ({"pp": 2, "tp": 2, "dp": 2},
                          dict(kind="llama",
                               cfg_kw=dict(sliding_window=5))),
}


def _spawn_ranks(flag: str, jobs: list, tag: str, n: int = 2,
                 timeout_s: float = 400.0, extra_env=None):
    """n ranks of `python3 chip_smoke.py <flag> DIR JOB...` on the one
    card, as a PyTorchJob's replicas see it (MASTER_ADDR 127.0.0.1, a
    free MASTER_PORT, WORLD_SIZE n, RANK); waits for all (killing them at
    the deadline) and returns (each rank's results, the step directories
    the jobs' checkpoints left); the work directory is removed."""
    import os
    import shutil
    import socket
    import tempfile

    work = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   **(extra_env or {}))
        logf = open(os.path.join(work, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, work, *jobs],
            env=env, stdout=logf, stderr=subprocess.STDOUT), logf))
    deadline = time.monotonic() + timeout_s
    try:
        try:
            for p, _ in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p, logf in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(30)
                logf.close()
        for r, (p, _) in enumerate(procs):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                lines = f.read().splitlines()
            for line in lines[-12:]:
                log(f"[{tag}]   rank {r} | {line}")
            if p.returncode != 0:
                raise AssertionError(f"[{tag}] rank {r} exit {p.returncode}")
        ckpt = os.path.join(work, "ckpt")
        steps = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)], steps
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _background(fn):
    """fn() on a thread (a spawn, which waits on its ranks); the
    returned join() gives its result or raises its error."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001  (re-raised by join)
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return join


def _probe_job() -> dict:
    """Each collective the sharded step could use, on 16 MB CUDA tensors
    over gloo: its seconds (the second call), or what gloo answers.  A
    probe reports; _check_probe fails on a collective the port
    calls that gloo refused."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.runtime import bootstrap

    n = bootstrap.initialize(device="cuda", backend="gloo").world
    x = torch.randn(PROBE_BYTES // 4, device="cuda")
    sub = dist.new_group(list(range(n)))
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MAX),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "barrier": lambda: dist.barrier(),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "subgroup_all_reduce": lambda: dist.all_reduce(x.clone(), group=sub),
        "subgroup_all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x, group=sub),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(n * x.numel(), device="cuda"), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(x.numel() // n, device="cuda"), x),
        # parallel/comm.all_to_all (equal chunks) and send_recv (one
        # non-empty chunk each way: a ring's rotation), world and subgroup
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "subgroup_all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x, group=sub),
        "all_to_all_single_uneven": lambda: dist.all_to_all_single(
            torch.empty_like(x), x,
            [x.numel() if j == (dist.get_rank() - 1) % n else 0
             for j in range(n)],
            [x.numel() if j == (dist.get_rank() + 1) % n else 0
             for j in range(n)]),
    }
    res = {}
    for name, fn in calls.items():
        try:
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            res[name] = {"ok": True, "s": time.perf_counter() - t}
        except Exception as e:  # noqa: BLE001  (the probe's reading)
            res[name] = {"ok": False, "error": f"{type(e).__name__}: "
                         f"{str(e).splitlines()[0][:200]}"}
    return res


def _timed_steps(rec: dict):
    """A wrapper of a step: each step timed with the card synchronized,
    its loss, and the collectives' calls, bytes and seconds
    (parallel/comm.STATS, timed around each collective)."""
    from tf_operator_tpu_torch.parallel import comm

    def wrap(step):
        def timed(state, *batch):
            torch.cuda.synchronize()
            comm.reset_stats(timing=True)
            t = time.perf_counter()
            state, m = step(state, *batch)
            rec["loss"].append(float(m["loss"]))
            torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t)
            rec["comm_s"].append(comm.STATS["seconds"])
            rec["comm_calls"].append(comm.STATS["calls"])
            rec["comm_bytes"].append(comm.STATS["bytes"])
            rec["comm_kinds"].append(json.loads(json.dumps(
                comm.STATS["kinds"])))
            return state, m
        return timed

    return wrap


def _new_rec() -> dict:
    return dict(step_s=[], loss=[], comm_s=[], comm_calls=[], comm_bytes=[],
                comm_kinds=[])


def _llama_tp_job(ring: bool = False) -> dict:
    """`train_llama --tp 2` (llama3_8b at full width and depth, 1 x 2048,
    SHARDED_STEPS steps) as this rank of the job, with the train phase's
    tokens (data member 0 reads the stream seeded SEED + 4) and weights
    (seed 0 = SEED); ring=True: `--ring`, attention through the ring
    over the tp ranks (K3f/K3q/K3kv at S_l = 1024 after the exchange)."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import ring_flash as rf

    rec = _new_rec()
    wrap, real_step = _timed_steps(rec), train_llama.make_lm_step
    real_batches = train_llama.lm_batches
    train_llama.make_lm_step = lambda model: wrap(real_step(model))
    train_llama.lm_batches = (
        lambda b, s, v, seed, device=None:
        real_batches(b, s, v, seed + SEED + 4, device))
    fa.reset_launches()
    rf.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = train_llama.main(["--tp", "2", "--steps", str(SHARDED_STEPS),
                               "--per-host-batch", str(TB), "--seq-len",
                               str(TS), "--backend", "gloo"]
                              + (["--ring"] if ring else []))
    finally:
        train_llama.make_lm_step, train_llama.lm_batches = (real_step,
                                                            real_batches)
    torch.cuda.synchronize()
    return dict(rc=rc, wall_s=time.perf_counter() - t0,
                launches=dict(fa.launches), ring_launches=dict(rf.launches),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, **rec)


def _entry_job(argv: list) -> dict:
    """train_llama with `argv` (a smoke run on the card over gloo) as this
    rank of the job: its exit code."""
    from tf_operator_tpu_torch import train_llama

    rc = train_llama.main(argv + ["--steps", "2", "--per-host-batch", "2",
                                  "--seq-len", "16", "--backend", "gloo"])
    return dict(rc=rc)


# the mixtral-ep job: mixtral-train's model (its depth, weights and
# tokens) with its experts over ep 2
EP_MESH = {"ep": 2}
EP_FACTOR = 1.25


def _mixtral_ep_job() -> dict:
    """mixtral_8x7b at full width cut to MIX_TRAIN_LAYERS layers on an
    {"ep": 2} mesh of two ranks through the library: make_mesh,
    make_switch_moe as the config's dispatch function (top-2 SwiGLU,
    capacity factor 1.25), parallel/placement.shard_model over the
    mixtral-train phase's weights drawn leaf by leaf (each rank keeps
    its 4 of the 8 experts a block), train_llama's step over the
    mixtral-train phase's 1 x 2048 tokens (both ranks: ep does not split
    the batch), adafactor, SHARDED_STEPS steps."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel import ep, placement
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.runtime import bootstrap
    from tf_operator_tpu_torch.runtime.optim import Adafactor
    from tf_operator_tpu_torch.runtime.train import TrainState

    bootstrap.initialize(device="cuda", backend="gloo")
    mesh = make_mesh(EP_MESH)
    cfg = llama.mixtral_8x7b(
        n_layers=MIX_TRAIN_LAYERS, tie_embeddings=True, remat=True,
        attention_fn=fa.flash_attention, moe_dispatch_fn=ep.make_switch_moe(
            mesh, 8, EP_FACTOR, activation="swiglu", top_k=2))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = llama.Llama(cfg, train=True)
    pl = placement.shard_model(model, mesh, bridge.iter_params(
        cfg, SEED + 55, device="cuda", train=True), device="cuda")
    state = TrainState.create(model, Adafactor(1e-3))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() / 2**30
    i, n = pl.data_index()
    batches = train_llama.lm_batches(TB, TS, cfg.vocab_size, SEED + 56,
                                     device="cuda")
    # before the first step, its batch through the dispatch: each
    # layer's (token, choice) pairs this rank's ep block dropped, and
    # the layer's router logits
    (first,) = next(train_llama.lm_batches(TB, TS, cfg.vocab_size,
                                           SEED + 56, device="cuda"))
    ep.reset_stats()
    seen = []
    probe_logits = route_probe(model, first, lambda layer: seen.append(
        ep.read_stats()))
    probe, prev = [], {"dropped": 0, "pairs": 0}
    for cur in seen:
        probe.append([cur["dropped"] - prev["dropped"],
                      cur["pairs"] - prev["pairs"]])
        prev = cur
    probe_plain = ep_route_drops(probe_logits, EP_MESH["ep"], EP_FACTOR,
                                 cfg.moe_top_k)
    del probe_logits
    rec = _new_rec()
    step = _timed_steps(rec)(train_llama.make_lm_step(model))
    fa.reset_launches()
    ep.reset_stats()
    for _ in range(SHARDED_STEPS):
        (tokens,) = next(batches)
        state, _ = step(state, tokens[i * TB // n:(i + 1) * TB // n])
    torch.cuda.synchronize()
    return dict(launches=dict(fa.launches), ep_stats=ep.read_stats(),
                probe=probe, probe_plain=probe_plain,
                init_s=init_s, held_gib=held, mesh=dict(mesh.shape),
                experts=tuple(model.blocks[0].moe.wi.shape),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, **rec)


# (b) runs t5_3b_decoder at full width cut to T5_TP_LAYERS of its 48
# layers: gloo's gathers and reduce-scatters through the host take most
# of its step, in proportion to the depth (39-76 s a step at full depth)
T5_TP_LAYERS = 12


def t5_tp_cfg():
    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.ops import flash_attention as fa

    return tfm.t5_3b_decoder(n_layers=T5_TP_LAYERS, remat=True,
                             attention_fn=fa.flash_attention)


def t5_tp_reference() -> float:
    """(b)'s first loss in one process on the card: its cut model from
    the t5-train phase's seed and train_t5's loss of the first global
    batch, no update."""
    from tf_operator_tpu_torch import train_t5
    from tf_operator_tpu_torch.models.transformer import lm_train_loss

    cfg = t5_tp_cfg()
    model, _, _ = _zoo_transformer(cfg, SEED + 95)
    (tokens,) = next(train_t5.lm_batches(T5_BATCH, T5_SEQ, cfg.vocab_size,
                                         SEED + 96, device="cuda"))
    with torch.no_grad():
        loss = float(lm_train_loss(model, tokens))
    del model
    torch.cuda.empty_cache()
    return loss


def _t5_tp_job() -> dict:
    """t5_3b_decoder at full width, T5_TP_LAYERS layers, on a tp 2 x
    fsdp 2 mesh of four ranks through the library: make_mesh,
    state_sharding of the train state, parallel/placement.place over the
    weights drawn leaf by leaf (the t5-train phase's seed), train_t5's
    step over this data member's rows of the t5-train phase's first 8 x
    512 batches, adafactor, SHARDED_STEPS steps."""
    from tf_operator_tpu_torch import train_t5
    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.models.transformer_bridge import (
        iter_transformer_params)
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel import placement, tp
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.runtime import bootstrap
    from tf_operator_tpu_torch.runtime.optim import Adafactor
    from tf_operator_tpu_torch.runtime.train import TrainState

    bootstrap.initialize(device="cuda", backend="gloo")
    mesh = make_mesh(T5_MESH)
    cfg = t5_tp_cfg()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = tfm.Transformer(cfg)
        specs = tp.state_sharding(TrainState.create(model, Adafactor(1e-3)),
                                  mesh)
    pl = placement.place(model, mesh, specs.params, iter_transformer_params(
        cfg, SEED + 95, device="cuda"), device="cuda")
    state = TrainState.create(model, Adafactor(1e-3))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() / 2**30
    i, n = pl.data_index()
    per = T5_BATCH // n
    batches = train_t5.lm_batches(T5_BATCH, T5_SEQ, cfg.vocab_size,
                                  SEED + 96, device="cuda")
    rec = _new_rec()
    step = _timed_steps(rec)(train_t5.make_lm_step(model))
    fa.reset_launches()
    for _ in range(SHARDED_STEPS):
        (tokens,) = next(batches)
        state, _ = step(state, tokens[i * per:(i + 1) * per])
    torch.cuda.synchronize()
    return dict(launches=dict(fa.launches), init_s=init_s, held_gib=held,
                mesh=dict(mesh.shape), data_member=(i, n),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, **rec)


def _parity_job() -> dict:
    """tests/torch_sharded_util.py's cases in f32 on the card, this rank
    of an eight-rank job (tp 2 x fsdp 2 x dp 2, and tp 4 x fsdp 2), then
    the smoke llama's first step saved under $SHARDED_CKPT."""
    import os

    from tests import torch_sharded_util as u
    from tf_operator_tpu_torch.runtime import bootstrap

    bootstrap.initialize(device="cuda", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {tag: u.CASES[case](axes, device="cuda", **kw)
           for tag, (case, axes, kw) in SHARDED_PARITY.items()}
    out.update({tag: u.case_fn(PIPE_CASE)(axes, device="cuda", **kw)
                for tag, (axes, kw) in PIPE_PARITY.items()})
    u.ckpt_case(SHARDED_PARITY["llama"][1],
                save_dir=os.environ["SHARDED_CKPT"], device="cuda")
    return out


# ------------------------------------------ Ulysses, pipelines, reshard
ULYSSES_SEED = SEED + 400


def _ulysses_job() -> dict:
    """(a)'s two ranks with Ulysses attention (ops/ulysses): first
    ulysses_attention itself over the tp ranks on this rank's sequence
    block of bf16 q [1, 2048, 32, 128] and k, v [1, 2048, 8, 128] (after
    the exchange K2 runs at (a)'s tp-local shape, 16 query and 4 kv
    heads), against one process's flash_attention over the whole
    sequence (this rank's block of its output), within 2e-2 + 2e-2·|ref|;
    then one train_llama step of (a)'s model, weights and first tokens
    with make_ulysses_attention_fn(mesh, "tp", use_flash=True) as its
    attention_fn (exact attention on the rank's heads: its first loss is
    (a)'s), K2 launches counted over that step alone."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops.ulysses import (
        make_ulysses_attention_fn, ulysses_attention)
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.runtime import bootstrap
    from tf_operator_tpu_torch.runtime.optim import Adafactor
    from tf_operator_tpu_torch.runtime.train import TrainState

    job = bootstrap.initialize(device="cuda", backend="gloo")
    mesh = make_mesh({"tp": 2})
    t = mesh.coords()["tp"]
    gen = torch.Generator(device="cuda").manual_seed(ULYSSES_SEED)
    q, k, v = (torch.randn((TB, TS, n, TD), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for n in (TH, TKV, TKV))
    blk = slice(t * TS // 2, (t + 1) * TS // 2)
    fa.reset_launches()
    out = ulysses_attention(q[:, blk].contiguous(), k[:, blk].contiguous(),
                            v[:, blk].contiguous(), True,
                            group=mesh.group("tp"), use_flash=True)
    torch.cuda.synchronize()
    attn_launches = dict(fa.launches)
    ref = fa.flash_attention(q, k, v, True)[:, blk].float()
    err = (out.float() - ref).abs()
    attn = dict(launches=attn_launches, max_abs_err=float(err.max()),
                ok=bool((err <= 2e-2 + 2e-2 * ref.abs()).all()))
    del q, k, v, out, ref, err
    cfg = llama3_train_cfg(attention_fn=make_ulysses_attention_fn(
        mesh, "tp", use_flash=True))
    torch.cuda.reset_peak_memory_stats()
    model, member = train_llama.build_model(cfg, mesh, job, "cuda")
    state = TrainState.create(model, Adafactor(1e-3))
    (tokens,) = next(train_llama.lm_batches(
        TB, TS, cfg.vocab_size, member[0] + SEED + 4, device="cuda"))
    rec = _new_rec()
    step = _timed_steps(rec)(train_llama.make_lm_step(model))
    fa.reset_launches()
    step(state, tokens)
    torch.cuda.synchronize()
    return dict(attn=attn, launches=dict(fa.launches),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, **rec)


# pipeline-train: the pipelined llama at llama3_8b's width, 4 layers
# over pp 2 (two ranks, one stage each), 4 x 1024 global in 4
# microbatches, adam as __graft_entry__.py's witness steps it
PIPE_MESH = {"pp": 2}
PIPE_LAYERS, PIPE_BATCH, PIPE_SEQ, PIPE_MICRO = 4, 4, 1024, 4
PIPE_PEAK_GIB = 30.0
PIPE_SEED = SEED + 410


def pipeline_cfg():
    from tf_operator_tpu_torch.models import llama

    return llama.llama3_8b(n_layers=PIPE_LAYERS, tie_embeddings=True)


def pipeline_inputs(cfg):
    """The pipelined llama's whole weights (models/pipeline_llama
    .init_params) and its global batch, from one seeded generator on the
    card."""
    from tf_operator_tpu_torch.models import pipeline_llama as pll

    gen = torch.Generator(device="cuda").manual_seed(PIPE_SEED)
    params = pll.init_params(gen, cfg, PIPE_MESH["pp"])
    toks = torch.randint(0, cfg.vocab_size, (PIPE_BATCH, PIPE_SEQ),
                         generator=gen, device="cuda")
    return params, toks


def _pipeline_job() -> dict:
    """One stage of the pipelined llama a rank (pipeline_cfg over
    PIPE_MESH: parallel/pp.place of param_shardings, the schedule's hops
    between the ranks), SHARDED_STEPS adam(1e-3) steps on the global
    batch: each step's loss, seconds and collectives (the hops are
    "send_recv", the stages' sums "all_reduce"), this rank's peak."""
    from tf_operator_tpu_torch.models import pipeline_llama as pll
    from tf_operator_tpu_torch.parallel import comm, pp
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.runtime import bootstrap
    from tf_operator_tpu_torch.runtime.optim import Adam

    bootstrap.initialize(device="cuda", backend="gloo")
    mesh = make_mesh(PIPE_MESH)
    cfg = pipeline_cfg()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    whole, toks = pipeline_inputs(cfg)
    tree = pp.place(whole, pll.param_shardings(whole, mesh), mesh)
    del whole
    torch.cuda.empty_cache()
    tree = pp.tree_map(lambda t: t.requires_grad_(), tree)
    flat = pp.named_leaves(tree)
    tx = Adam(1e-3)
    opt = tx.init(flat)
    apply = pll.make_pipelined_apply(cfg, mesh, PIPE_MICRO)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() / 2**30
    rec = _new_rec()
    for _ in range(SHARDED_STEPS):
        torch.cuda.synchronize()
        comm.reset_stats(timing=True)
        t = time.perf_counter()
        loss = pll.pipeline_lm_loss(apply, tree, toks)
        loss.backward()
        opt = tx.update_(flat, opt)
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t)
        rec["loss"].append(float(loss.detach()))
        rec["comm_s"].append(comm.STATS["seconds"])
        rec["comm_calls"].append(comm.STATS["calls"])
        rec["comm_bytes"].append(comm.STATS["bytes"])
        rec["comm_kinds"].append(json.loads(json.dumps(
            comm.STATS["kinds"])))
    return dict(stage=mesh.coords()["pp"], mesh=dict(mesh.shape),
                init_s=init_s, held_gib=held,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, **rec)


def pipeline_reference() -> float:
    """The pipelined llama's first loss in one process on the card: its
    sequential_apply (the witness) on the whole weights and batch."""
    from tf_operator_tpu_torch.models import pipeline_llama as pll
    from tf_operator_tpu_torch.models.transformer import lm_loss

    cfg = pipeline_cfg()
    whole, toks = pipeline_inputs(cfg)
    with torch.no_grad():
        loss = float(lm_loss(pll.sequential_apply(cfg, whole, toks), toks))
    del whole
    torch.cuda.empty_cache()
    return loss


# reshard: mistral_7b's width (llama3_8b's but a 32000-token vocab: a
# quarter of the embedding, whose fsdp gathers and reduce-scatters
# through gloo take most of a step) at 1 layer in f32 (the trajectory
# held at rtol 2e-4), placed by models/reshard.state_shardings on fsdp 2
# (the two ranks) and fsdp 4 (the four), 4 x 1024 global, adafactor
RESHARD_LAYERS, RESHARD_BATCH, RESHARD_SEQ = 1, 4, 1024
RESHARD_SEED = SEED + 420
RESHARD_RTOL = 2e-4


def _reshard_state(mesh):
    """The f32 1-layer mistral_7b-width model placed on `mesh` by the
    one rule, its weights drawn leaf by leaf, adafactor; its step; this
    rank's rows of the two global batches."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models.reshard import state_shardings
    from tf_operator_tpu_torch.ops.flash_attention import flash_attention
    from tf_operator_tpu_torch.parallel import placement
    from tf_operator_tpu_torch.runtime.optim import Adafactor
    from tf_operator_tpu_torch.runtime.train import TrainState

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.mistral_7b(n_layers=RESHARD_LAYERS, tie_embeddings=True,
                           dtype=torch.float32,
                           attention_fn=flash_attention)
    with torch.device("meta"):
        model = llama.Llama(cfg, train=True)
    specs = state_shardings(model.state_dict(), mesh)
    pl = placement.place(model, mesh, specs, bridge.iter_params(
        cfg, RESHARD_SEED, device="cuda", train=True), device="cuda")
    state = TrainState.create(model, Adafactor(1e-3))
    i, n = pl.data_index()
    per = RESHARD_BATCH // n
    gen = torch.Generator(device="cuda").manual_seed(RESHARD_SEED + 1)
    rows = [torch.randint(0, cfg.vocab_size, (RESHARD_BATCH, RESHARD_SEQ),
                          generator=gen, device="cuda")[i * per:(i + 1) * per]
            for _ in range(2)]
    return state, train_llama.make_lm_step(model), rows


def _reshard_job(leg: str) -> dict:
    """One leg of the resize under $RESHARD_DIR: "src" on fsdp 2, one
    step, saved as step 1 to src/; "golden" on fsdp 4, two steps from
    the start, never resized; "dst" on fsdp 4, step 1 restored from the
    resharded dst/, then the second step.  Each: its losses, seconds."""
    import os

    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.runtime import bootstrap
    from tf_operator_tpu_torch.runtime.train import Checkpointer

    bootstrap.initialize(device="cuda", backend="gloo")
    mesh = make_mesh({"fsdp": 2 if leg == "src" else 4})
    root = os.environ["RESHARD_DIR"]
    t0 = time.perf_counter()
    state, step, rows = _reshard_state(mesh)
    out = {"mesh": dict(mesh.shape), "init_s": time.perf_counter() - t0}
    if leg == "dst":
        t0 = time.perf_counter()
        state = Checkpointer(os.path.join(root, "dst")).restore(state)
        out.update(restored_step=state.step,
                   restore_s=time.perf_counter() - t0)
        rows = rows[state.step:]
    rec = _new_rec()
    step = _timed_steps(rec)(step)
    for toks in rows[:1 if leg == "src" else 2]:
        state, _ = step(state, toks)
    if leg == "src":
        t0 = time.perf_counter()
        Checkpointer(os.path.join(root, "src")).save(state.step, state)
        out["save_s"] = time.perf_counter() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return dict(out, **rec)


SMOKE_RING = ["--smoke", "--tp", "2", "--ring"]
SMOKE_EP = ["--smoke", "--model", "mixtral", "--tp", "2", "--ep", "2"]
SHARDED_JOBS = {"probe": _probe_job, "llama-tp": _llama_tp_job,
                "llama-tp-ring": lambda: _llama_tp_job(ring=True),
                "entry-ring": lambda: _entry_job(SMOKE_RING),
                "entry-ep": lambda: _entry_job(SMOKE_EP),
                "mixtral-ep": _mixtral_ep_job,
                "t5-tp": _t5_tp_job, "parity": _parity_job,
                "llama-tp-ulysses": _ulysses_job,
                "pipeline-train": _pipeline_job,
                "reshard-src": lambda: _reshard_job("src"),
                "reshard-golden": lambda: _reshard_job("golden"),
                "reshard-dst": lambda: _reshard_job("dst"),
                "tp-serve": lambda: _tp_serve_job(),
                "tp-parity": lambda: _tp_parity_job()}


def sharded_worker(out_dir: str, jobs: list) -> int:
    """One rank of a sharded job on the card (`python3 chip_smoke.py
    --sharded-worker DIR JOB...`, the PyTorchJob env set by
    _spawn_ranks): runs each job of SHARDED_JOBS, writes
    DIR/rank<r>.pt."""
    import os

    import torch.distributed as dist

    import gc

    rank = int(os.environ["RANK"])
    results = {}
    for job in jobs:
        t0 = time.perf_counter()
        results[job] = SHARDED_JOBS[job]()
        # the next job starts from an empty card
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[sharded-worker] rank {rank} {job}: done in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _check_probe(res: dict) -> dict:
    """The gloo probe, the first job of sharded-train's two ranks: each
    collective on CUDA tensors between two ranks on the one card.  Fails
    when gloo refuses one the port calls (parallel/comm: all_reduce,
    all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single
    with equal and with uneven chunks, over the world and a subgroup;
    broadcast and barrier in parallel/dp and the Checkpointer)."""
    for name, r in res.items():
        log(f"[sharded-probe] {name}: " + (
            f"ok, {r['s'] * 1e3:.3f} ms for {PROBE_BYTES >> 20} MB"
            if r["ok"] else f"REFUSED: {r['error']}"))
    # what parallel/comm calls (the other two are read for the record)
    used = ("all_reduce", "all_reduce_max", "broadcast", "barrier",
            "subgroup_all_reduce", "all_gather_into_tensor",
            "reduce_scatter_tensor", "all_to_all_single",
            "subgroup_all_to_all_single", "all_to_all_single_uneven")
    bad = [k for k in used if not res[k]["ok"]]
    if bad:
        raise AssertionError(f"[sharded-probe] gloo refuses {bad} on CUDA "
                             f"tensors")
    return res


def _sharded_line(tag: str, r: dict, tokens: int) -> str:
    step_s = _steady_s(r["step_s"])
    return (f"step_s {[round(x, 4) for x in r['step_s']]} (steady "
            f"{step_s:.4f}, tokens_per_s {tokens / step_s:.2f}); "
            f"collectives a step: {[round(x, 4) for x in r['comm_s']]} s, "
            f"{r['comm_calls'][-1]} calls, "
            f"{r['comm_bytes'][-1] / 2**30:.3f} GiB; peak "
            f"{r['peak_gib']:.3f} GiB")


def sharded_train_phase(llama_first: float, llama_peak: float,
                        t5_peak: float, mix_first: float,
                        mix_plain: list) -> dict:
    """(a) `train_llama --tp 2 --steps 3` as a job of two ranks on the one
    card (llama3_8b, 1 x 2048, adafactor, gloo), launched as dp-train
    launches its ranks; (b) t5_3b_decoder at T5_TP_LAYERS layers on a tp
    2 x fsdp 2 mesh of four ranks through the library, 8 x 512 global.
    Each: every loss finite,
    the first within 2e-2 of the one-process phase's on the same weights
    and tokens (bf16: the tp partial sums round before they add), the
    tp peers' losses equal; K2 launches a rank a step: forward 2 x layers
    (remat), dQ and dK/dV layers, all on the tensor cores, at the
    tp-local heads; each rank's peak beside the one-process phase's, the
    collectives' seconds a step.  The ranks of (a) then run (c), (d) and
    (e), those of (b) run (f):
      (c) `train_llama --tp 2 --ring --steps 3`, the ring over the tp
          ranks: (a)'s checks, no K2 launch, and K3f/K3q/K3kv launched by
          each member for its live steps (rank 0 one a layer, rank 1
          two), all on the tensor cores; the exchange's and the
          rotations' calls, MiB and seconds a step;
      (d) `train_llama --smoke --tp 2 --ring`, exit 0;
      (e) mixtral_8x7b at MIX_TRAIN_LAYERS layers with its experts over
          ep 2 (_mixtral_ep_job): every loss finite, the first within
          1.5 of ln V and printed beside mixtral-train's (the capacity
          drops tokens there: not the same function); the share of
          (token, choice) pairs dropped at capacity factor 1.25, and
          its first batch's drops a layer against topk_route's over the
          same router logits and, at layer 0, over mixtral-train's
          (_check_mixtral_ep); K2 a
          rank a step as mixtral-train; the all-to-all's calls, MiB and
          seconds a step;
      (f) `train_llama --smoke --model mixtral --tp 2 --ep 2` as four
          ranks (tp 2 x ep 2), exit 0;
      (g) (a)'s ranks with Ulysses attention (_ulysses_job,
          _check_ulysses);
      (h) the pipelined llama at llama3_8b's width, one stage a rank
          (_pipeline_job, _check_pipeline);
      (i) the elastic resize: (a)'s ranks train an f32 1-layer
          mistral_7b-width model one step on fsdp 2 and save it, this process reshards the
          checkpoint to fsdp 4 (_reshard_between), and (b)'s ranks run
          the never-resized fsdp 4 golden and the resumed leg
          (_reshard_job, _check_reshard)."""
    import shutil
    import tempfile

    card = device_line()
    out = {}
    torch.cuda.empty_cache()
    reshard_dir = tempfile.mkdtemp(prefix="chip_smoke_reshard_")
    try:
        ranks, _ = _spawn_ranks(
            "--sharded-worker", ["probe", "llama-tp", "llama-tp-ring",
                                 "entry-ring", "mixtral-ep",
                                 "llama-tp-ulysses", "pipeline-train",
                                 "reshard-src"],
            "sharded-train", n=2, timeout_s=900.0,
            extra_env={"RESHARD_DIR": reshard_dir})
        out["probe"] = _check_probe(ranks[0]["probe"])
        out.update(_two_rank_checks(ranks, llama_first, llama_peak,
                                    mix_first, mix_plain, card))
        out["reshard"] = _reshard_between(reshard_dir, ranks, card)
        torch.cuda.empty_cache()
        ranks, _ = _spawn_ranks(
            "--sharded-worker", ["t5-tp", "entry-ep", "reshard-golden",
                                 "reshard-dst"], "sharded-train", n=4,
            timeout_s=600.0, extra_env={"RESHARD_DIR": reshard_dir})
    finally:
        shutil.rmtree(reshard_dir, ignore_errors=True)
    rs = [r["t5-tp"] for r in ranks]
    t5_first = t5_tp_reference()
    for r, res in enumerate(rs):
        log(f"[sharded-train] (b) t5_3b_decoder x {T5_TP_LAYERS} layers, "
            f"mesh {res['mesh']}, rank {r} (data member "
            f"{res['data_member']}): losses "
            f"{[round(x, 4) for x in res['loss']]} (one process, the same "
            f"layers: first {t5_first:.4f}); "
            + _sharded_line("b", res, T5_BATCH * T5_SEQ)
            + f" (t5-train, 48 layers in one process {t5_peak:.3f}); init "
            f"{res['init_s']:.1f} s, {res['held_gib']:.3f} GiB held; K2 "
            + json.dumps(res["launches"]) + f"; {card}")
    out["t5"] = _check_sharded("(b)", rs, t5_first, T5_TP_LAYERS)
    for r, res in enumerate(ranks):
        if res["entry-ep"]["rc"] != 0:
            raise AssertionError(f"[sharded-train] (f) rank {r}: "
                                 f"{res['entry-ep']}")
    log(f"[sharded-train] (f) train_llama {' '.join(SMOKE_EP)}: the four "
        f"ranks exit 0")
    _check_reshard(out["reshard"], ranks, card)
    return out


def _two_rank_checks(ranks: list, llama_first: float, llama_peak: float,
                     mix_first: float, mix_plain: list, card: str) -> dict:
    """The two-rank jobs' checks: (a), (c), (d), (e), (g) Ulysses and (h)
    the pipeline (sharded_train_phase)."""
    out = {}
    rs = [r["llama-tp"] for r in ranks]
    for r, res in enumerate(rs):
        log(f"[sharded-train] (a) llama3_8b tp 2, rank {r}: exit "
            f"{res['rc']}, losses {[round(x, 4) for x in res['loss']]} "
            f"(one process: first {llama_first:.4f}); "
            + _sharded_line("a", res, TB * TS)
            + f" (one process {llama_peak:.3f}); K2 "
            + json.dumps(res["launches"]) + f"; wall {res['wall_s']:.1f} s;"
            f" {card}")
    out["llama"] = _check_sharded("(a)", rs, llama_first, 32)
    out["ring"] = _check_ring_tp([r["llama-tp-ring"] for r in ranks],
                                 llama_first, card)
    for r, res in enumerate(ranks):
        if res["entry-ring"]["rc"] != 0:
            raise AssertionError(f"[sharded-train] (d) rank {r}: "
                                 f"{res['entry-ring']}")
    log(f"[sharded-train] (d) train_llama {' '.join(SMOKE_RING)}: both "
        f"ranks exit 0")
    out["ep"] = _check_mixtral_ep([r["mixtral-ep"] for r in ranks],
                                  mix_first, mix_plain, card)
    out["ulysses"] = _check_ulysses([r["llama-tp-ulysses"] for r in ranks],
                                    rs, card)
    out["pipeline"] = _check_pipeline([r["pipeline-train"] for r in ranks],
                                      card)
    return out


def _check_ulysses(rs: list, tp_rs: list, card: str) -> dict:
    """(g)'s checks: ulysses_attention over the two ranks within 2e-2 +
    2e-2·|ref| of one process's flash attention, its K2 forward on the
    tensor cores; the step's first loss (a)'s bit for bit, K2 launches
    a rank of one remat step, all on the tensor cores.  Returns the
    step's K2 launches of both ranks, summed."""
    for r, res in enumerate(rs):
        a = res["attn"]
        log(f"[sharded-train] (g) ulysses_attention over tp 2, rank {r}: "
            f"bf16 q [1, 1024 of 2048, 32, 128], k/v 8 heads -> K2 at 16 / "
            f"4 heads: max abs err {a['max_abs_err']:.3e} against one "
            f"process's flash attention (within 2e-2 + 2e-2|ref|: "
            f"{a['ok']}); K2 {json.dumps(a['launches'])}")
        log(f"[sharded-train] (g) llama3_8b tp 2 with "
            f"make_ulysses_attention_fn(mesh, 'tp', use_flash=True), rank "
            f"{r}: loss {res['loss'][0]:.6f} ((a)'s first "
            f"{tp_rs[r]['loss'][0]:.6f}); step {res['step_s'][0]:.4f} s "
            f"((a)'s first {tp_rs[r]['step_s'][0]:.4f}); peak "
            f"{res['peak_gib']:.3f} GiB; K2 {json.dumps(res['launches'])}; "
            f"{card}")
        want_attn = {"flash_fwd": 1, "flash_fwd_mma": 1}
        if not a["ok"] or {k: v for k, v in a["launches"].items() if v} \
                != want_attn:
            raise AssertionError(f"[sharded-train] (g) rank {r}: "
                                 f"ulysses_attention {a}")
        if res["loss"][0] != tp_rs[r]["loss"][0]:
            raise AssertionError(
                f"[sharded-train] (g) rank {r}: first loss "
                f"{res['loss'][0]!r} is not (a)'s {tp_rs[r]['loss'][0]!r}")
        if res["launches"] != _k2_want(32, 1):
            raise AssertionError(f"[sharded-train] (g) rank {r}: K2 "
                                 f"launches {res['launches']}")
    return {name: sum(res["launches"][name] for res in rs)
            for name in rs[0]["launches"]}


def _check_pipeline(rs: list, card: str) -> dict:
    """(h)'s checks: both stages' losses finite and equal, the first
    within 2e-2 of the sequential witness in one process on the card;
    each rank's peak at most PIPE_PEAK_GIB."""
    t0 = time.perf_counter()
    ref = pipeline_reference()
    ref_s = time.perf_counter() - t0
    for r, res in enumerate(rs):
        step_s = _steady_s(res["step_s"])
        log(f"[sharded-train] (h) pipelined llama3_8b width x "
            f"{PIPE_LAYERS} layers on {res['mesh']}, stage {res['stage']}: "
            f"losses {[round(x, 4) for x in res['loss']]} (sequential "
            f"witness in one process {ref:.4f}, {ref_s:.1f} s); step_s "
            f"{[round(x, 4) for x in res['step_s']]} (steady {step_s:.4f}, "
            f"tokens_per_s {PIPE_BATCH * PIPE_SEQ / step_s:.2f}); "
            + _kind_line(res, "send_recv") + " (the hops); "
            + _kind_line(res, "all_reduce") + " (the stages' sums); init "
            f"{res['init_s']:.1f} s, {res['held_gib']:.3f} GiB held, peak "
            f"{res['peak_gib']:.3f} GiB; {card}")
        if res["peak_gib"] > PIPE_PEAK_GIB:
            raise AssertionError(f"[sharded-train] (h) stage {r}: peak "
                                 f"{res['peak_gib']:.3f} GiB")
        if abs(res["loss"][0] - ref) > 2e-2:
            raise AssertionError(f"[sharded-train] (h) stage {r}: first "
                                 f"loss {res['loss'][0]} against the "
                                 f"witness's {ref}")
    _check_losses("(h)", rs, None, None)
    return {"reference": ref, "losses": rs[0]["loss"]}


def _reshard_between(root: str, ranks: list, card: str) -> dict:
    """The two-rank src leg's checkpoint resharded to fsdp 4
    (models/reshard.reshard_checkpoint, in this process): its seconds and
    rate."""
    import os

    from tf_operator_tpu_torch.models.reshard import reshard_checkpoint
    from tf_operator_tpu_torch.parallel.mesh import make_mesh

    src = [r["reshard-src"] for r in ranks]
    t0 = time.perf_counter()
    step = reshard_checkpoint(os.path.join(root, "src"),
                              os.path.join(root, "dst"),
                              make_mesh({"fsdp": 4}, world=4))
    sec = time.perf_counter() - t0
    nbytes = _dir_bytes(os.path.join(root, "dst", str(step)))
    log(f"[sharded-train] (i) reshard: fsdp 2 leg, losses "
        f"{[r['loss'] for r in src]}, save {src[0]['save_s']:.1f} s, peak "
        f"{max(r['peak_gib'] for r in src):.3f} GiB; reshard_checkpoint "
        f"to fsdp 4: step {step}, {nbytes / 1e9:.3f} GB in {sec:.2f} s "
        f"({nbytes / 1e9 / sec:.3f} GB/s read and written, fsynced); "
        f"{card}")
    if step != 1:
        raise AssertionError(f"[sharded-train] (i) resharded step {step}")
    return {"src": src[0]["loss"], "step": step, "s": sec, "bytes": nbytes}


def _check_reshard(res: dict, ranks: list, card: str) -> None:
    """(i)'s checks: the never-resized fsdp 4 run's losses, the fsdp 2
    leg's first within RESHARD_RTOL of its first, the resumed fsdp 4
    leg (restored at step 1) within RESHARD_RTOL of its second."""
    golden = [r["reshard-golden"] for r in ranks]
    dst = [r["reshard-dst"] for r in ranks]
    log(f"[sharded-train] (i) golden fsdp 4 losses {golden[0]['loss']}, "
        f"step_s {[round(x, 3) for x in golden[0]['step_s']]}; resumed "
        f"fsdp 4 (restored step {dst[0]['restored_step']} in "
        f"{dst[0]['restore_s']:.1f} s) losses {dst[0]['loss']}; fsdp 2 "
        f"leg {res['src']}; peak {max(r['peak_gib'] for r in golden):.3f} "
        f"GiB a rank; {card}")
    for r in golden + dst:
        if not all(map(math.isfinite, r["loss"])):
            raise AssertionError(f"[sharded-train] (i) {r}")
    g = golden[0]["loss"]
    pairs = [(res["src"][0], g[0]), (dst[0]["loss"][0], g[1])]
    if dst[0]["restored_step"] != 1 or any(
            abs(a - b) > RESHARD_RTOL * abs(b) for a, b in pairs):
        raise AssertionError(f"[sharded-train] (i) the resized trajectory "
                             f"{pairs} is not the golden's")
    for rs in (golden, dst):
        if any(r["loss"] != rs[0]["loss"] for r in rs):
            raise AssertionError(f"[sharded-train] (i) ranks differ: "
                                 f"{[r['loss'] for r in rs]}")


def _kind_line(res: dict, kind: str) -> str:
    """A collective kind's calls, MiB and seconds a step (_timed_steps)."""
    per = [k.get(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
           for k in res["comm_kinds"]]
    return (f"{kind} {per[-1]['calls']} calls, "
            f"{per[-1]['bytes'] / 2**20:.1f} MiB a step, seconds "
            f"{[round(k['seconds'], 4) for k in per]}")


def _check_ring_tp(rs: list, first: float, card: str) -> dict:
    """(c)'s checks (sharded_train_phase); the K3 launches of both ranks,
    summed."""
    from tf_operator_tpu_torch.ops import zigzag

    live = [sum(zigzag.pair_live(my, src, TP_RING_N, TP_RING_SL,
                                 "contiguous", None)
                for src in range(TP_RING_N)) for my in range(TP_RING_N)]
    for r, res in enumerate(rs):
        n = 32 * live[r] * SHARDED_STEPS
        log(f"[sharded-train] (c) llama3_8b tp 2 --ring, rank {r}: exit "
            f"{res['rc']}, losses {[round(x, 4) for x in res['loss']]} "
            f"(one process: first {first:.4f}); "
            + _sharded_line("c", res, TB * TS)
            + "; " + _kind_line(res, "all_to_all") + " (the exchange); "
            + _kind_line(res, "send_recv") + " (the ring's rotations); K3 "
            + json.dumps(res["ring_launches"]) + f" ({live[r]} live steps "
            f"a layer on this member, {n // SHARDED_STEPS} K3q a step); "
            f"K2 {json.dumps(res['launches'])}; wall "
            f"{res['wall_s']:.1f} s; {card}")
        want = {"ring_fwd": 2 * n, "ring_fwd_mma": 2 * n, "ring_dq": n,
                "ring_dq_mma": n, "ring_dkv": n, "ring_dkv_mma": n}
        if res["ring_launches"] != want or any(res["launches"].values()):
            raise AssertionError(
                f"[sharded-train] (c) rank {r}: K3 launches "
                f"{res['ring_launches']}, expected {want}; K2 "
                f"{res['launches']}, expected none")
    _check_losses("(c)", rs, first, 2e-2)
    return {name: sum(res["ring_launches"][name] for res in rs)
            for name in rs[0]["ring_launches"]}


def _check_mixtral_ep(rs: list, mix_first: float, mix_plain: list,
                      card: str) -> dict:
    """(e)'s checks (sharded_train_phase); the K2 launches of both ranks,
    summed.  The drops' cause: before its first step the job routed its
    first batch through the dispatch once; each layer's drops (both
    ranks' blocks) must equal topk_route's over the same router logits
    cut into the ep blocks (a fault of the dispatch's gather, blocks,
    capacity or padding would part them), and layer 0's share, whose
    input the dispatch has not yet touched, must be within 0.01 of
    mixtral-train's one-process router's on the same batch
    (`mix_plain`): the share is then the router's, not the dispatch's."""
    pairs = sum(res["ep_stats"]["pairs"] for res in rs)
    dropped = sum(res["ep_stats"]["dropped"] for res in rs)
    for r, res in enumerate(rs):
        log(f"[sharded-train] (e) mixtral_8x7b x {MIX_TRAIN_LAYERS} layers "
            f"on {res['mesh']}, rank {r} (its experts {res['experts']}): "
            f"losses {[round(x, 4) for x in res['loss']]} (mixtral-train, "
            f"one process through grouped_moe: first {mix_first:.4f}); "
            + _sharded_line("e", res, TB * TS) + "; "
            + _kind_line(res, "all_to_all") + " (the dispatch); this "
            f"rank's ep block dropped {res['ep_stats']['dropped']} of "
            f"{res['ep_stats']['pairs']} (token, choice) pairs; init "
            f"{res['init_s']:.1f} s, {res['held_gib']:.3f} GiB held; K2 "
            + json.dumps(res["launches"]) + f"; {card}")
        want = _k2_want(MIX_TRAIN_LAYERS, SHARDED_STEPS)
        if res["launches"] != want:
            raise AssertionError(f"[sharded-train] (e) rank {r}: K2 "
                                 f"launches {res['launches']}, expected "
                                 f"{want}")
        if abs(res["loss"][0] - math.log(32000)) > 1.5:
            raise AssertionError(f"[sharded-train] (e) rank {r}: first "
                                 f"loss {res['loss'][0]}")
    _check_losses("(e)", rs, None, None)
    probe = [[sum(res["probe"][layer][j] for res in rs) for j in (0, 1)]
             for layer in range(MIX_TRAIN_LAYERS)]
    plain = rs[0]["probe_plain"]
    log(f"[sharded-train] (e) the first batch before the first step, "
        f"[dropped, pairs] a layer: the dispatch {probe}; topk_route over "
        f"its router logits in {EP_MESH['ep']} blocks "
        f"{[p[:2] for p in plain]} (top expert's share of the choices "
        f"{[round(p[2], 4) for p in plain]}); mixtral-train's one-process "
        f"router {[p[:2] for p in mix_plain]} (top expert's share "
        f"{[round(p[2], 4) for p in mix_plain]})")
    if len(probe) != MIX_TRAIN_LAYERS or any(
            p != q[:2] for p, q in zip(probe, plain)) or any(
            res["probe_plain"] != plain for res in rs):
        raise AssertionError(f"[sharded-train] (e) the dispatch's drops "
                             f"{probe} are not topk_route's {plain}")
    share = probe[0][0] / probe[0][1]
    one = mix_plain[0][0] / mix_plain[0][1]
    if abs(share - one) > 0.01:
        raise AssertionError(f"[sharded-train] (e) layer 0 dropped a share "
                             f"{share:.6f} of its pairs, the one-process "
                             f"router {one:.6f}")
    # the step's forward and remat's: 2 MoE calls a layer a step
    if pairs != SHARDED_STEPS * 2 * MIX_TRAIN_LAYERS * TB * TS * 2:
        raise AssertionError(f"[sharded-train] (e) {pairs} (token, choice) "
                             f"pairs routed")
    log(f"[sharded-train] (e) dropped at capacity factor {EP_FACTOR}: "
        f"{dropped} of {pairs} (token, choice) pairs, share "
        f"{dropped / pairs:.6f} (every forward: the step's and remat's)")
    return {name: sum(res["launches"][name] for res in rs)
            for name in rs[0]["launches"]}


def _check_losses(tag: str, rs: list, first, tol) -> None:
    """Every rank's losses finite, SHARDED_STEPS of them, the same on
    every rank; the first within `tol` of `first` (None: not held)."""
    for r, res in enumerate(rs):
        if res.get("rc", 0) != 0 or len(res["loss"]) != SHARDED_STEPS \
                or not all(map(math.isfinite, res["loss"])):
            raise AssertionError(f"[sharded-train] {tag} rank {r}: {res}")
        if tol is not None and abs(res["loss"][0] - first) > tol:
            raise AssertionError(
                f"[sharded-train] {tag} rank {r}: first loss "
                f"{res['loss'][0]} is not within {tol} of one process's "
                f"{first}")
    for res in rs[1:]:
        if any(abs(a - b) > 1e-6 * abs(b)
               for a, b in zip(res["loss"], rs[0]["loss"])):
            raise AssertionError(
                f"[sharded-train] {tag}: the ranks' global losses differ: "
                f"{[res['loss'] for res in rs]}")


def _check_sharded(tag: str, rs: list, first: float, n_layers: int) -> dict:
    _check_losses(tag, rs, first, 2e-2)
    for r, res in enumerate(rs):
        want = _k2_want(n_layers, SHARDED_STEPS)
        if res["launches"] != want:
            raise AssertionError(f"[sharded-train] {tag} rank {r}: K2 "
                                 f"launches {res['launches']}, expected "
                                 f"{want}")
    return {name: sum(res["launches"][name] for res in rs)
            for name in rs[0]["launches"]}


def sharded_parity_phase() -> None:
    """tests/test_torch_sharded.py's cases in f32 on the card: eight
    ranks on tp 2 x fsdp 2 x dp 2 (and tp 4 x fsdp 2) against one process
    on the card, after 2 steps: losses and gradient norms within 1e-5,
    parameters within rtol 1e-5 + atol 1e-5 (under Adam and AdamW each
    leaf's update within 1e-3 relative error norm; the test file says
    why).  The pipelines' cases (PIPE_PARITY) on the same eight ranks,
    one stage a rank, against their sequential witness in one process on
    the card, held the same way (Adam), and the MoE aux within 1e-5.
    Then the sharded job's checkpoint of its first step, resumed in one
    process: its second step equals one process's two."""
    import shutil
    import tempfile

    from tests import torch_sharded_util as u

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_sharded_ckpt_")
    try:
        job = _background(lambda: _spawn_ranks(
            "--sharded-worker", ["parity"], "sharded-parity", n=8,
            timeout_s=400.0, extra_env={"SHARDED_CKPT": ckpt}))
        # one process's runs while the ranks run
        try:
            wants = {tag: u.CASES[case](None, device="cuda", **kw)
                     for tag, (case, axes, kw) in SHARDED_PARITY.items()}
            wants.update({tag: u.case_fn(PIPE_CASE)(
                axes, form="sequential", device="cuda", **kw)
                for tag, (axes, kw) in PIPE_PARITY.items()})
            whole = u.llama_case(None, device="cuda")
        finally:
            ranks, _ = job()
        got = ranks[0]["parity"]
        for tag, (case, axes, kw) in SHARDED_PARITY.items():
            want = wants[tag]
            worst = u.check(got[tag], want, adam=tag in ADAM_CASES, tag=tag)
            if "ep" in axes and not got[tag]["ep_stats"]["dropped"]:
                raise AssertionError(f"[sharded-parity] {tag}: the capacity "
                                     f"dropped nothing")
            log(f"[sharded-parity] {tag} on {axes} = one process: worst "
                f"rel loss {worst['loss']:.2e}, gnorm {worst['gnorm']:.2e}, "
                f"params {worst['param']:.2e}"
                + (" (update rel err norm)" if tag in ADAM_CASES else ""))
        for tag, (axes, kw) in PIPE_PARITY.items():
            want = wants[tag]
            worst = u.check(got[tag], want, adam=True, tag=tag)
            aux = [(a, b) for a, b in zip(got[tag]["aux"], want["aux"])
                   if b is not None]
            if any(abs(a - b) > 1e-5 * abs(b) for a, b in aux):
                raise AssertionError(f"[sharded-parity] {tag}: aux {aux}")
            log(f"[sharded-parity] {tag} on {axes}, one stage a rank = the "
                f"sequential witness in one process: worst rel loss "
                f"{worst['loss']:.2e}, gnorm {worst['gnorm']:.2e}, params "
                f"{worst['param']:.2e} (update rel err norm)"
                + (f"; aux {[round(a, 6) for a, _ in aux]}" if aux else ""))
        res = u.ckpt_case(None, load_dir=ckpt, device="cuda")
        if res["restored_step"] != 1:
            raise AssertionError(f"[sharded-parity] restored {res}")
        err = abs(res["losses"][0] - whole["losses"][1]) / whole["losses"][1]
        perr = max(float((res["params"][k] - p).abs().max())
                   for k, p in whole["params"].items())
        if err >= 1e-5 or perr > 1e-5:
            raise AssertionError(f"[sharded-parity] resumed in one process: "
                                 f"loss err {err}, params {perr}")
        log(f"[sharded-parity] the sharded job's step-1 checkpoint resumed "
            f"in one process: second loss rel err {err:.2e}, parameters "
            f"max abs err {perr:.2e}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


# ------------------------------------------------- tensor-parallel serving
# llama3_8b's attention at tp 2 as each rank runs it: its 16 query heads
# over its 4 kv heads (parallel/tp.kv_cache_sharding)
TP_H, TP_KV = H // 2, KV // 2
TP_MESH = {"tp": 2}
# tp-serve serves the first 8 of the serve phase's 16 prompts: one wave
# of the 8 slots, since each decode step waits on gloo through the host
TP_SERVE_REQUESTS = 8
# and decodes TP_SERVE_NEW of the serve phase's MAX_NEW tokens a request
# (each decode step waits on gloo's 66 collectives: 0.39 s)
TP_SERVE_NEW = 32
# tp-serve's first prefill, last position: tp 2's logits against one
# process's on the same weights and prompt, relative error norm.  bf16:
# each of the 64 row-parallel products a forward rounds its two partial
# sums to bf16 before they add, where one process rounds once, and the
# residual stream carries the difference through 32 layers
TP_LOGITS_TOL = 5e-2


def kernel_tp_phase() -> dict:
    """K1 and K1q (the same draws quantized by int8_pools) against their
    plain versions at the tp 2 local shape (TP_H query heads over TP_KV kv
    heads, 8 lanes up to the serve phase's contexts, lane 7 frozen),
    decode L=1 and prefill L=512, bf16 and f32 queries; then timed at
    decode and prefill with bf16 queries as the kernel phase times
    them."""
    from tf_operator_tpu_torch.models import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for int8 in (False, True):
        tag = "[kernel-tp K1q]" if int8 else "[kernel-tp K1]"
        plain = (pa.paged_attention_int8_plain if int8
                 else pa.paged_attention_plain)

        def inputs(case, int8=int8):
            k, v = int8_pools(case) if int8 else (case["k"], case["v"])
            return (case["q"], k, v, case["table"], case["pos"])

        errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
        for i, (dt, l) in enumerate((dt, l)
                                    for dt in (torch.bfloat16, torch.float32)
                                    for l in (1, 512)):
            case = make_case(dt, l, None, False, SEED + 300 + i, h=TP_H,
                             kv=TP_KV)
            chunk = (pa.split_slots(l * TP_H // TP_KV, case["table"].shape[1],
                                    BS, TP_KV * B)
                     if dt == torch.bfloat16 else 0)
            err = check_paged(
                case, inputs(case), plain, dt, B - 1,
                f"{tag} {str(dt)[6:]:8s} L={l:<4d} H={TP_H} KV={TP_KV} "
                f"bs={BS} ctx={case['ctx']} split_slots={chunk}")
            errs[dt] = max(errs[dt], err)
        timings = {}
        for name, l in (("decode", 1), ("prefill", 512)):
            case = make_case(torch.bfloat16, l, None, False, SEED + 310,
                             h=TP_H, kv=TP_KV)
            timings[name] = paged_timing(
                case, inputs(case), plain,
                bound_ms(case, torch.bfloat16, int8),
                f"{tag} timing {name} bf16 q, {'int8' if int8 else 'bf16'} "
                f"KV, B={B} L={l} H={TP_H} KV={TP_KV} D={D} bs={BS} "
                f"ctx={case['ctx']}")
        out["k1q" if int8 else "k1"] = dict(errs=errs, timings=timings)
    return out


def first_prefill_logits(model, prompt, kv_quant: bool, sharding=None):
    """The last position's f32 logits [V] (on the host) of `prompt`
    prefilled in one segment into a fresh pool through K1 (K1q): what a
    serving run's first token of it is drawn from.  sharding: a tp
    rank's parallel/tp.kv_cache_sharding (its pool holds its kv
    heads)."""
    from tf_operator_tpu_torch.models import llama, paging
    from tf_operator_tpu_torch.models.serving import _pool_sharding

    n = paging.blocks_for(int(prompt.shape[0]), BS)
    pool = paging.init_block_pool(model.cfg, n, BS, device="cuda",
                                  kv_quant=kv_quant,
                                  sharding=_pool_sharding(sharding))
    table = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")[None]
    with torch.inference_mode():
        lg = llama.chunk_fill(model, pool, prompt[None].to("cuda"), 0, table)
    return lg[0].float().cpu()


def _tp_serve_job() -> dict:
    """This rank of tp-serve: llama3_8b at tp 2, (a) bf16 and (b) int8
    weights with int8 KV, each drawn leaf by leaf from the serve phase's
    seed (each rank keeps its block), serving the serve phase's prompts
    under the continuous scheduler; then one timed decode block of 4
    steps (8 lanes at 512 positions) for the collectives a step."""
    from tf_operator_tpu_torch.models import bridge, llama, paging
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import (
        _pool_sharding, decode_block, serve_loop)
    from tf_operator_tpu_torch.parallel import comm
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.placement import shard_model
    from tf_operator_tpu_torch.parallel.tp import kv_cache_sharding
    from tf_operator_tpu_torch.runtime import bootstrap

    bootstrap.initialize(device="cuda", backend="gloo")
    mesh = make_mesh(TP_MESH)
    cfg = llama.llama3_8b()
    prompts = prompts_for(cfg, 16, 64, MAX_CTX, SEED + 1)[:TP_SERVE_REQUESTS]
    sh = kv_cache_sharding(cfg, mesh, 8)
    out = {}
    for run, int8 in (("a", False), ("b", True)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.device("meta"):
            model = llama.Llama(cfg)
        draw = bridge.iter_int8_params if int8 else bridge.iter_params
        shard_model(model, mesh, draw(cfg, SEED, device="cuda"),
                    device="cuda", requires_grad=False)
        model.eval()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated() / 2**30
        kw = dict(slots=8, block_size=BS, steps_per_sync=8, device="cuda",
                  scheduler="continuous", kv_quant=int8, cache_sharding=sh)
        logits = first_prefill_logits(model, prompts[0], int8, sh)
        # warm-up (cuBLAS handles, allocator) on two short requests
        serve_loop(model, [p[:64] for p in prompts[:2]], max_new_tokens=8,
                   **kw)
        torch.cuda.synchronize()
        calls = [0]
        hook = model.register_forward_hook(
            lambda *_: calls.__setitem__(0, calls[0] + 1))
        pa.reset_launches()
        comm.reset_stats(timing=False)
        torch.cuda.reset_peak_memory_stats()
        res, stats = serve_loop(model, prompts, max_new_tokens=TP_SERVE_NEW,
                                return_stats=True, **kw)
        torch.cuda.synchronize()
        hook.remove()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(k1=pa.launches, k1_mma=pa.launches_mma,
                        k1q=pa.launches_int8, k1q_mma=pa.launches_int8_mma)
        run_comm = dict(calls=comm.STATS["calls"], bytes=comm.STATS["bytes"])
        n = paging.blocks_for(512 + 8, BS)
        pool = paging.init_block_pool(cfg, 8 * n, BS, device="cuda",
                                      kv_quant=int8,
                                      sharding=_pool_sharding(sh))
        table = torch.arange(1, 8 * n + 1, dtype=torch.int32,
                             device="cuda").view(8, n)
        comm.reset_stats(timing=True)
        t1 = time.perf_counter()
        with torch.inference_mode():
            decode_block(model, pool,
                         torch.zeros(8, dtype=torch.long, device="cuda"),
                         torch.full((8,), 512, dtype=torch.int32,
                                    device="cuda"),
                         torch.zeros(8, dtype=torch.bool, device="cuda"),
                         table, 4, lambda lg: torch.argmax(lg, dim=-1))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t1) / 4
        step_comm = dict(s=comm.STATS["seconds"] / 4,
                         calls=comm.STATS["calls"] / 4,
                         bytes=comm.STATS["bytes"] / 4, step_s=step_s)
        comm.reset_stats(timing=False)
        del pool
        p50, p99 = ttft_pcts(stats)
        out[run] = dict(
            tokens=[r.tokens for r in res], tokens_per_s=stats.tokens_per_sec,
            ttft=(p50, p99), tpot=stats.tpot_mean_s, wall_s=stats.wall_time_s,
            prefill_s=stats.prefill_time_s, decode_s=stats.decode_time_s,
            peak_gib=peak, init_s=init_s, held_gib=held, calls=calls[0],
            launches=launches, run_comm=run_comm, step_comm=step_comm,
            logits=logits)
        print(f"[tp-serve] ({run}) {stats.tokens_per_sec:.2f} tokens/s, "
              f"peak {peak:.3f} GiB", flush=True)
        del model
    return out


def _first_diff(got, want):
    return next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                None if len(got) == len(want) else min(len(got), len(want)))


def tp_serve_phase(serve: dict, serve_int8: dict) -> dict:
    """llama3_8b at full width and depth served at tp 2 by two ranks on
    the one card (module docstring, phase 40); returns each run's K1 /
    K1q launches summed over the ranks."""
    from tf_operator_tpu_torch.models import llama

    card = device_line()
    cfg = llama.llama3_8b()
    torch.cuda.empty_cache()
    ranks, _ = _spawn_ranks("--sharded-worker", ["tp-serve"], "tp-serve",
                            n=2, timeout_s=600.0)
    rs = [r["tp-serve"] for r in ranks]
    out = {}
    for run, ref, int8 in (("a", serve, False), ("b", serve_int8, True)):
        label = "int8 weights and KV" if int8 else "bf16 weights and KV"
        if rs[0][run]["tokens"] != rs[1][run]["tokens"]:
            raise AssertionError(f"[tp-serve] ({run}) the ranks' tokens "
                                 f"differ")
        kname = "k1q" if int8 else "k1"
        for r, res in enumerate(rs):
            res = res[run]
            for i, toks in enumerate(res["tokens"]):
                if len(toks) != TP_SERVE_NEW or not all(
                        0 <= t < cfg.vocab_size for t in toks):
                    raise AssertionError(
                        f"[tp-serve] ({run}) rank {r} request {i}: "
                        f"{len(toks)} tokens, budget {TP_SERVE_NEW}, or one "
                        f"out of the vocabulary")
            lc = res["launches"]
            want = cfg.n_layers * res["calls"]
            other = lc["k1"] if int8 else lc["k1q"]
            if lc[kname] != want or lc[kname + "_mma"] != want or other:
                raise AssertionError(
                    f"[tp-serve] ({run}) rank {r}: launches {lc} for "
                    f"{res['calls']} model calls x {cfg.n_layers} layers")
            err = rel_l2(res["logits"], ref["logits"])
            log(f"[tp-serve] ({run}) rank {r}: first prefill's logits, "
                f"relative error norm against one process {err:.3e} "
                f"(tolerance {TP_LOGITS_TOL})")
            if not err <= TP_LOGITS_TOL:
                raise AssertionError(f"[tp-serve] ({run}) rank {r}: logits "
                                     f"rel err {err}")
        res = rs[0][run]
        want = [w[:TP_SERVE_NEW] for w in ref["tokens"]]
        same = sum(g == w for g, w in zip(res["tokens"], want))
        diffs = [_first_diff(g, w) for g, w in zip(res["tokens"], want)]
        sc = res["step_comm"]
        log(f"[tp-serve] ({run}) llama3_8b tp 2, {label}, continuous, 8 "
            f"slots, {len(res['tokens'])} requests x {TP_SERVE_NEW}: "
            f"tokens_per_s={res['tokens_per_s']:.2f} ttft_p50_s="
            f"{res['ttft'][0]:.4f} ttft_p99_s={res['ttft'][1]:.4f} "
            f"tpot_mean_s={res['tpot']:.6f} wall_s={res['wall_s']:.4f} "
            f"prefill_s={res['prefill_s']:.4f} decode_s="
            f"{res['decode_s']:.4f}; peak GiB a rank "
            f"{[round(x[run]['peak_gib'], 3) for x in rs]} (one process "
            f"{ref['peak_gib']:.3f}), held after init "
            f"{[round(x[run]['held_gib'], 3) for x in rs]} in "
            f"{[round(x[run]['init_s'], 1) for x in rs]} s; {kname} "
            f"launches a rank {[x[run]['launches'][kname] for x in rs]} "
            f"(all on the tensor cores) for {res['calls']} model calls; "
            f"collectives in the run {res['run_comm']['calls']} calls, "
            f"{res['run_comm']['bytes'] / 2**30:.3f} GiB; a decode step "
            f"(8 lanes at 512, timed alone): {sc['step_s'] * 1e3:.2f} ms, "
            f"collectives {sc['s'] * 1e3:.2f} ms in {sc['calls']:.0f} calls "
            f"of {sc['bytes'] / 2**20:.3f} MiB; requests equal to the "
            f"one-process phase's {same}/{len(diffs)}, first differing "
            f"token {diffs}; {card}")
        out[run] = sum(x[run]["launches"][kname] for x in rs)
    return out


def _tp_parity_job() -> dict:
    """This rank of tp-serve-parity: tests/torch_tp_serving_util.py's
    job body in f32 on the card, its jobs from $TP_PARITY_DIR."""
    import os

    import torch.distributed as dist

    from tests import torch_tp_serving_util as u
    from tf_operator_tpu_torch.runtime import bootstrap

    bootstrap.initialize(device="cuda", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jobs = torch.load(os.path.join(os.environ["TP_PARITY_DIR"], "jobs.pt"),
                      weights_only=False)
    return u.job_body(dist.get_rank(), jobs, device="cuda")


def tp_serve_parity_phase() -> None:
    """tests/test_torch_tp_serving.py's spawned cases in f32 on the card:
    eight ranks against one process on the card, held by the test file's
    own checks (tests/torch_tp_serving_util.py); the one-process runs go
    while the ranks run."""
    import pathlib
    import shutil
    import tempfile
    import threading

    from tests import torch_tp_serving_util as u

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_tp_parity_"))
    box = {}

    def start_job(jobs, tmp):
        torch.save(jobs, tmp / "jobs.pt")
        th = threading.Thread(target=lambda: box.update(ranks=_spawn_ranks(
            "--sharded-worker", ["tp-parity"], "tp-serve-parity", n=8,
            timeout_s=400.0, extra_env={"TP_PARITY_DIR": str(tmp)})[0]))
        th.start()
        return th

    def join_job(th):
        th.join()
        if "ranks" not in box:
            raise AssertionError("[tp-serve-parity] the eight-rank job "
                                 "failed (its ranks' logs are above)")
        return [r["tp-parity"] for r in box["ranks"]]

    try:
        ranks, one = u.run(work, device="cuda", start_job=start_job,
                           join_job=join_job)
        for tag in u.JOBS:
            u.check_outputs(tag, ranks, one)
            u.check_caches(tag, ranks, one)
        for tag in u.HANDOFF:
            u.check_exports(tag, ranks, one)
            u.check_adoption(tag, ranks, one)
        u.check_reach(one)
        secs = {tag: round(ranks[0][tag]["seconds"], 2)
                for tag in ranks[0]}
        log(f"[tp-serve-parity] {len(u.JOBS)} cases and {len(u.HANDOFF)} "
            f"handoffs on {sorted(u.MESHES)}: every rank's tokens, "
            f"schedules and counts = one process's on the card, each "
            f"rank's cache its block (within 1e-5), the exports equal "
            f"between ranks and within 1e-5 of one process's, adoption "
            f"both ways = one process's; rank 0's seconds a case "
            f"{json.dumps(secs)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------- the parity process
# phases whose CPU halves run in a process of their own, started with
# the script, beside the card's phases: one process, so that only one
# of them holds card memory beside the card's largest phases (two
# overflowed the train phase's 60 GiB); mixtral-parity, the largest,
# first, beside the serving phases
PARITY_CHILD = ("mixtral-parity", "transformer-parity", "parity",
                "spec-parity", "dense-parity", "window-parity",
                "parity-int8")


def parity_child(out_path: str, names: list) -> int:
    """`python3 chip_smoke.py --parity-worker OUT PHASE...`: the named
    parity phases in order, each lapped; writes their results the rows
    need and the laps to OUT."""
    torch.set_num_threads(4)
    phases = {"mixtral-parity": mixtral_parity_phase,
              "transformer-parity": transformer_parity_phase,
              "parity": parity_phase, "spec-parity": spec_parity_phase,
              "dense-parity": dense_parity_phase,
              "window-parity": window_parity_phase,
              "parity-int8": parity_int8_phase}
    res, laps = {}, {}
    for name in names:
        t = time.perf_counter()
        r = phases[name]()
        laps[name] = time.perf_counter() - t
        log(f"[time] {name}: {laps[name]:.1f} s (parity process)")
        if name in ("spec-parity", "window-parity"):
            res[name] = {"launches_int8": r["launches_int8"]}
    torch.save({"results": res, "laps": laps}, out_path)
    return 0


def start_parity_child(names: tuple):
    """Start a parity process over the phases `names`; its output goes
    to a file that join_parity_child replays."""
    import os
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_parity_")
    logf = open(f"{work}/parity.log", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parity-worker",
         f"{work}/parity.pt", *names], stdout=logf, stderr=subprocess.STDOUT)
    return proc, logf, work, time.perf_counter()


def join_parity_child(child, timeout_s: float = 900.0) -> dict:
    """Wait for the parity process, replay its log, and fail if it did."""
    import shutil

    proc, logf, work, t0 = child
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
    finally:
        logf.close()
    try:
        with open(f"{work}/parity.log") as f:
            for line in f.read().splitlines():
                log(f"[parity-process] {line}")
        if proc.returncode != 0:
            raise AssertionError(f"[parity-process] exit {proc.returncode}")
        out = torch.load(f"{work}/parity.pt", weights_only=False)
        laps = {k: round(v, 1) for k, v in out["laps"].items()}
        log(f"[parity-process] done {time.perf_counter() - t0:.1f} s after "
            f"it started; laps {json.dumps(laps)}")
        return out["results"]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _kernel_class(name: str) -> str:
    if any(k in name for k in ("paged_attention", "paged_mma", "paged_merge")):
        # the merge of the decode split is K1's or K1q's second pass
        return ("paged_attention int8 (K1q)" if "signed char" in name
                else "paged_attention (K1)")
    for kernel, label in (("flash_fwd", "flash fwd (K2f)"),
                          ("flash_dq", "flash dq (K2q)"),
                          ("flash_dkv", "flash dkv (K2kv)"),
                          ("ring_fwd", "ring fwd (K3f)"),
                          ("ring_dq", "ring dq (K3q)"),
                          ("ring_dkv", "ring dkv (K3kv)")):
        if kernel in name:
            return label
    if any(k in name for k in ("cudnn", "fprop", "dgrad", "wgrad")):
        return "convolution (cuDNN)"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    return "other"


def _profile(fn, label: str, steps: int, ranges=()) -> None:
    """Device time of fn() by kernel under torch.profiler, per step, and
    the device's idle share of the host-clock window.  `ranges`: names of
    record_function ranges (see _annotated), which the profiler also
    marks on the device's timeline; a kernel the name table calls "other"
    goes to the innermost such range whose device interval holds it."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, by_class = {}, {}
    spans = {r: [] for r in ranges}
    others = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t = e.time_range
        if e.name in spans:   # a range's mark on the device, no kernel
            spans[e.name].append((t.start, t.end))
            continue
        us = t.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        cls = _kernel_class(e.name)
        if cls == "other" and ranges:
            others.append((t.start, t.end, us))
            continue
        by_class[cls] = by_class.get(cls, 0.0) + us
    for r in spans:
        spans[r].sort()
    for start, end, us in others:
        best, cls = None, "other"
        for r, iv in spans.items():   # one range's marks never overlap
            i = bisect.bisect_right(iv, (start, float("inf"))) - 1
            if i >= 0 and iv[i][1] >= end and (
                    best is None or iv[i][1] - iv[i][0] < best):
                best, cls = iv[i][1] - iv[i][0], r
        by_class[cls] = by_class.get(cls, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    # the profiler slows the host side, not the kernels: the idle share
    # of an unprofiled step is its host-clock time less the device time
    log(f"[profile] {label}: {wall_ms / steps:.4f} ms per step (host clock, "
        f"no profiler); device busy {busy_ms / steps:.4f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.4f} (under the profiler "
        f"{prof_wall_ms / steps:.4f} ms, idle {1 - busy_ms / prof_wall_ms:.4f})")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"[profile] {label}:   {cls:22s} {us / 1e3 / steps:9.4f} ms "
            f"per step, {us / 1e3 / busy_ms:.4f} of device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile] {label}:     {us / 1e3 / steps:9.4f} ms  {name[:90]}")


def profile_phase(int8: bool = False) -> None:
    """Where serving time goes at full width: one 8-step decode block of
    llama3_8b for 8 lanes at 512 positions each, and one 512-token
    prefill segment, each under torch.profiler; bf16 weights and KV, or
    (int8) int8 weights and KV."""
    from tf_operator_tpu_torch.models import bridge, llama, paging, serving

    cfg = llama.llama3_8b()
    params = (int8_params(cfg, SEED) if int8
              else bridge.init_params(cfg, SEED, device="cuda"))
    model = llama.Llama.from_params(cfg, params, device="cuda")
    del params
    tag = "int8 " if int8 else ""
    lanes, ctx, steps = 8, 512, 8
    per_lane = paging.blocks_for(ctx + steps, BS)
    cache = paging.init_block_pool(cfg, lanes * per_lane, BS, device="cuda",
                                   kv_quant=int8)
    table = (torch.arange(lanes * per_lane, dtype=torch.int32,
                          device="cuda").view(lanes, per_lane) + 1)
    tok = torch.randint(0, cfg.vocab_size, (lanes,), device="cuda")
    pos = torch.full((lanes,), ctx, dtype=torch.int32, device="cuda")
    frozen = torch.zeros(lanes, dtype=torch.bool, device="cuda")
    greedy = lambda logits: torch.argmax(logits, dim=-1)
    segment = torch.randint(0, cfg.vocab_size, (1, ctx), device="cuda")
    with torch.inference_mode():
        _profile(lambda: serving.decode_block(model, cache, tok, pos, frozen,
                                              table, steps, greedy),
                 f"{tag}decode {lanes} lanes x ctx {ctx}", steps)
        _profile(lambda: serving.chunk_fill(model, cache, segment, 0,
                                            table[:1]),
                 f"{tag}prefill 1 lane x {ctx} tokens", 1)


@contextlib.contextmanager
def _annotated(patches):
    """Wrap each (module, function name, label) in a record_function range
    of that label for the span of the block (the profile's attribution of
    elementwise kernels to the step's parts); the functions are put back
    after."""
    saved = []
    for mod, name, label in patches:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*a, **kw)

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield [label for _, _, label in patches]
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def profile_mixtral_phase() -> None:
    """Where an int8 Mixtral serving step's time goes: mixtral_8x7b at
    full depth and width with int8 weights (mixtral_serve_model), one
    8-step decode block for 8 lanes at 512 positions and one 512-token
    prefill segment under torch.profiler; elementwise kernels split into
    the weights' dequantization (dense projections and routed experts),
    the experts' SwiGLU and the MoE routing and grouping (softmax, top-k,
    sort, gathers, index_add_)."""
    from tf_operator_tpu_torch.models import llama, paging, serving
    from tf_operator_tpu_torch.parallel import ep

    model, qbytes, _, _ = mixtral_serve_model()
    cfg = model.cfg
    lanes, ctx, steps = 8, 512, 8
    per_lane = paging.blocks_for(ctx + steps, BS)
    cache = paging.init_block_pool(cfg, lanes * per_lane, BS, device="cuda")
    table = (torch.arange(lanes * per_lane, dtype=torch.int32,
                          device="cuda").view(lanes, per_lane) + 1)
    g = torch.Generator(device="cuda").manual_seed(SEED + 57)
    tok = torch.randint(0, cfg.vocab_size, (lanes,), device="cuda",
                        generator=g)
    pos = torch.full((lanes,), ctx, dtype=torch.int32, device="cuda")
    frozen = torch.zeros(lanes, dtype=torch.bool, device="cuda")
    greedy = lambda logits: torch.argmax(logits, dim=-1)
    segment = torch.randint(0, cfg.vocab_size, (1, ctx), device="cuda",
                            generator=g)
    patches = [(ep, "grouped_moe", "moe routing and grouping"),
               (ep, "_expert_ffn", "moe expert swiglu"),
               (ep, "_expert", "dequantize (experts)"),
               (llama, "_dense", "dequantize (dense weights)")]
    log(f"[profile] mixtral_8x7b int8: quantized_bytes {qbytes}")
    with torch.inference_mode(), _annotated(patches) as ranges:
        _profile(lambda: serving.decode_block(model, cache, tok, pos, frozen,
                                              table, steps, greedy),
                 f"mixtral int8 decode {lanes} lanes x ctx {ctx}", steps,
                 ranges)
        _profile(lambda: serving.chunk_fill(model, cache, segment, 0,
                                            table[:1]),
                 f"mixtral int8 prefill 1 lane x {ctx} tokens", 1, ranges)
    del model, cache
    torch.cuda.empty_cache()


def profile_train_phase(ring: bool = False, mistral: bool = False) -> None:
    """Where a training step's time goes at full width: one llama3_8b
    step (batch 1 x 2048) under torch.profiler, with the one-device flash
    attention or (ring) ring flash attention over LocalRing(4); or
    (mistral) one mistral_7b step at batch 1 x 8192, window 4096."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.ops import ring_flash as rf
    from tf_operator_tpu_torch.ops.flash_attention import flash_attention
    from tf_operator_tpu_torch.parallel.ring import LocalRing

    seq, label = TS, "train step"
    if mistral:
        cfg = llama.mistral_7b(tie_embeddings=True, remat=True,
                               attention_fn=flash_attention)
        seq, label = MS, f"mistral train step (window {MWIN})"
    elif ring:
        cfg = llama3_train_cfg(attention_fn=rf.make_ring_flash_attention_fn(
            LocalRing(RING_N)))
        label = f"ring train step (LocalRing({RING_N}))"
    else:
        cfg = llama3_train_cfg()
    model, state, step = train_model(cfg)
    tokens = next(train_llama.lm_batches(TB, seq, cfg.vocab_size, SEED + 4,
                                         device="cuda"))[0]
    _profile(lambda: step(state, tokens), f"{label} {TB} x {seq}", 1)
    del model, state, step
    torch.cuda.empty_cache()


# -------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import tf_operator_tpu_torch  # noqa: F401  (fails outside a checkout)

    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--sharded-worker"]:
        return sharded_worker(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--parity-worker"]:
        build()
        return parity_child(sys.argv[2], sys.argv[3:])
    t_start = time.perf_counter()
    card = device_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    build()
    if sys.argv[1:] == ["--profile"]:
        profile_phase()
        torch.cuda.empty_cache()
        profile_phase(int8=True)
        torch.cuda.empty_cache()
        profile_train_phase()
        profile_train_phase(ring=True)
        profile_train_phase(mistral=True)
        profile_mixtral_phase()
        return 0
    # the parity phases' CPU halves run beside the card's phases
    child = start_parity_child(PARITY_CHILD)
    try:
        return _phases(card, t_start, child)
    finally:
        if child[0].poll() is None:  # a phase failed: stop the process
            child[0].kill()
            child[0].wait(30)


def _phases(card: str, t_start: float, child) -> int:
    """Every phase in order (main, after the build), the parity process
    `child` running beside them; then the kernel table and the last
    line."""
    t_lap = [time.perf_counter()]

    def lap(name: str, result=None):
        """Log the seconds since the last lap under the phase's name, and
        pass the phase's result on."""
        now = time.perf_counter()
        log(f"[time] {name}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now
        return result

    kern = lap("kernel", kernel_phase())
    serve = lap("serve", serve_phase())
    spec = lap("spec", spec_phase(serve["model"], serve["prompts"],
                                  serve["tokens"]))
    lap("dense", dense_phase(serve["model"], serve["prompts"],
                             serve["tokens"]))
    lap("handoff", handoff_phase(serve.pop("model")))
    win = lap("window", window_phase())
    kern_win = lap("window kernel", window_kernel_phase())
    kern_win_q = lap("window kernel int8", window_kernel_phase(int8=True))
    kern2 = lap("kernel2", kernel2_phase())
    kern2_win = lap("kernel2-window", kernel2_window_phase(kern2))
    train = lap("train", train_phase())
    mistral = lap("mistral-train", mistral_train_phase())
    lap("train-parity", train_parity_phase())
    lap("checkpoint", checkpoint_phase())
    kern1q = lap("kernel1q", kernel_phase(int8=True))
    serve_int8 = lap("serve-int8", serve_int8_phase())
    kern3 = lap("kernel3", kernel3_phase())
    ring_train = lap("ring-train", ring_train_phase(train["losses"][0]))
    lap("ring-parity", ring_parity_phase())
    lap("entry", ring_entry_phase())
    lap("entry-ckpt", entry_ckpt_phase())
    # Mixtral: every llama model above is freed; the card starts empty
    torch.cuda.empty_cache()
    lap("mixtral-serve", mixtral_serve_phase())
    mixtral = lap("mixtral-train", mixtral_train_phase())
    lap("entry-mixtral", entry_mixtral_phase())
    # the BERT/T5 and vision model zoo
    torch.cuda.empty_cache()
    zoo = lap("kernel2-zoo", kernel2_zoo_phase())
    bert = lap("bert-train", bert_train_phase())
    t5 = lap("t5-train", t5_train_phase())
    lap("vision-parity", vision_parity_phase())
    lap("resnet-train", resnet_train_phase())
    lap("entry-zoo", entry_zoo_phase())
    # LoRA and data parallelism across processes
    torch.cuda.empty_cache()
    lora_run = lap("lora-train", lora_train_phase())
    lap("lora-parity", lora_parity_phase())
    lap("dp-train", dp_train_phase())
    lap("dp-parity", dp_parity_phase())
    # the tp x fsdp x dp training mesh: ranks share the card over gloo
    torch.cuda.empty_cache()
    k2tp = lap("kernel2-tp", kernel2_zoo_phase(TP_FLASH, "kernel2-tp",
                                               SEED + 85))
    k3tp = lap("kernel3-tp", kernel3_tp_phase())
    sharded = lap("sharded-train", sharded_train_phase(
        train["losses"][0], train["peak_gib"], t5["peak_gib"],
        mixtral["losses"][0], mixtral["ep_plain"]))
    lap("sharded-parity", sharded_parity_phase())
    parity = lap("parity process (wait)", join_parity_child(child))
    # tensor-parallel serving: ranks share the card over gloo
    torch.cuda.empty_cache()
    kern_tp = lap("kernel-tp", kernel_tp_phase())
    tp_serve = lap("tp-serve", tp_serve_phase(serve, serve_int8))
    lap("tp-serve-parity", tp_serve_parity_phase())
    spec_parity = parity["spec-parity"]
    win_parity = parity["window-parity"]

    def paged_row(name, line, kern, launches, verify=False):
        """K1's or K1q's row: decode times, prefill times beside them;
        verify=True: the spec phase's verify shape alone (L = 5)."""
        t = kern["timings"]["verify" if verify else "decode"]
        errs = kern["verify_errs" if verify else "errs"]
        row = {"name": name, "route": "cuda",
               "source": "tf_operator_tpu_torch/csrc/paged_attention.cu",
               "replaces": f"tf_operator_tpu/models/paged_attention.py:{line}",
               "launches": launches,
               "max_abs_err": errs[torch.bfloat16],
               "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": t["library_ms"], "device_ms": t["device_ms"],
               "library_device_ms": t["library_device_ms"]}
        if not verify:
            pre = kern["timings"]["prefill"]
            row.update({"prefill_ms": pre["ms"],
                        "prefill_plain_ms": pre["plain_ms"],
                        "prefill_bound_ms": pre["bound_ms"],
                        "prefill_library_ms": pre["library_ms"],
                        "prefill_device_ms": pre["device_ms"],
                        "prefill_library_device_ms": pre["library_device_ms"]})
        return row

    rows = [paged_row("paged_attention", 96, kern, serve["launches"]),
            paged_row("paged_attention_int8", 259, kern1q,
                      serve_int8["launches"]),
            # the same kernels at the window phase's shapes: wrapped
            # 288-slot rings, window 4096
            paged_row("paged_attention_window", 96, kern_win,
                      win["launches"]),
            paged_row("paged_attention_int8_window", 259, kern_win_q,
                      win_parity["launches_int8"]),
            # the same kernels at the spec phase's verify shape (8 lanes
            # at L = 5); launches: every K1 call of the spec phase's
            # runs, and the spec-parity phase's int8 run for K1q
            paged_row("paged_attention_verify", 96, kern, spec["launches"],
                      verify=True),
            paged_row("paged_attention_int8_verify", 259, kern1q,
                      spec_parity["launches_int8"], verify=True),
            # the same kernels at the tp 2 local shape (16 query, 4 kv
            # heads); launches: both ranks' in tp-serve (a) and (b)
            paged_row("paged_attention_tp2", 96, kern_tp["k1"],
                      tp_serve["a"]),
            paged_row("paged_attention_int8_tp2", 259, kern_tp["k1q"],
                      tp_serve["b"])]
    # each row replaces the Pallas kernel body (_fwd_kernel, _dq_kernel,
    # _dkv_kernel); the _window rows: the same kernels at mistral_7b's
    # training shape, launched by the mistral-train phase.  The
    # lora-train phase runs them at the train phase's shape: its launches
    # stand in the base rows as lora_launches
    for suffix, kern, run in (("", kern2, train),
                              ("_window", kern2_win, mistral)):
        for name, line in (("flash_fwd", 112), ("flash_dq", 217),
                           ("flash_dkv", 256)):
            t = kern["timings"][name]
            rows.append({
                "name": name + suffix, "route": "cuda",
                "source": "tf_operator_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"tf_operator_tpu/ops/flash_attention.py:{line}",
                "launches": run["launches"][name],
                "max_abs_err": kern["errs"][name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"]})
            if not suffix:
                # the same shape (32 query, 8 kv heads, 1 x 2048):
                # lora-train's launches, and both ranks' of the mixtral
                # model with its experts over ep 2 (sharded-train (e))
                rows[-1]["lora_launches"] = lora_run["launches"][name]
                rows[-1]["ep_launches"] = sharded["ep"][name]
            if suffix == "_window":  # flex_attention is library_ms
                rows[-1].update(
                    sdpa_band_ms=t["sdpa_band_ms"],
                    sdpa_band_device_ms=t["sdpa_band_device_ms"],
                    rel_l2={o: kern["norms"][o][0] for o in FLASH_OUTS[name]})
    # the same kernels at D = 64: bert_large's non-causal attention and the
    # t5_3b_decoder's causal one, launched by the bert-train and t5-train
    # phases
    for label, run in (("bert", bert), ("t5", t5)):
        for name, line in (("flash_fwd", 112), ("flash_dq", 217),
                           ("flash_dkv", 256)):
            t = zoo[label]["timings"][name]
            rows.append({
                "name": f"{name}_{label}", "route": "cuda",
                "source": "tf_operator_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"tf_operator_tpu/ops/flash_attention.py:{line}",
                "launches": run["launches"][name],
                "max_abs_err": zoo[label]["errs"][name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"],
                "rel_l2": {o: zoo[label]["norms"][o]
                           for o in FLASH_OUTS[name]}})
    # the same kernels at the tp-local shapes of the sharded-train phase:
    # llama3_8b at tp 2 (16 query, 4 kv heads) and t5_3b_decoder at tp 2
    # (16 heads); launches: every rank's in that phase's run, summed
    for label, run in (("llama3_tp2", sharded["llama"]),
                       ("t5_tp2", sharded["t5"])):
        for name, line in (("flash_fwd", 112), ("flash_dq", 217),
                           ("flash_dkv", 256)):
            t = k2tp[label]["timings"][name]
            rows.append({
                "name": f"{name}_{label}", "route": "cuda",
                "source": "tf_operator_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"tf_operator_tpu/ops/flash_attention.py:{line}",
                "launches": run[name],
                "max_abs_err": k2tp[label]["errs"][name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"],
                "rel_l2": {o: k2tp[label]["norms"][o]
                           for o in FLASH_OUTS[name]}})
            if label == "llama3_tp2":
                # the same shape: both ranks' one step with Ulysses
                # attention (sharded-train (g))
                rows[-1]["ulysses_launches"] = sharded["ulysses"][name]
    # each row replaces the Pallas kernel body (_carry_fwd_kernel,
    # _dq_ring_kernel, _dkv_ring_kernel); the _tp2 rows: the same kernels
    # at the ring over tp 2 (S_l = 1024), launched by sharded-train (c)'s
    # two ranks
    for suffix, kern, launches in (("", kern3, ring_train["launches"]),
                                   ("_tp2", k3tp, sharded["ring"])):
        for name, line in (("ring_fwd", 71), ("ring_dq", 156),
                           ("ring_dkv", 191)):
            t = kern["timings"][name]
            rows.append({
                "name": name + suffix, "route": "cuda",
                "source": "tf_operator_tpu_torch/csrc/ring_flash.cu",
                "replaces": f"tf_operator_tpu/ops/ring_flash.py:{line}",
                "launches": launches[name],
                "max_abs_err": kern["errs"][name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"]})
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
