"""LLaMA-class GQA decoder pretraining on CUDA cards (or the CPU).

The port of examples/llama/train_llama.py: the llama3_8b
(llama31_8b, mistral_7b with its 4096-token sliding window, or
mixtral_8x7b's top-2 sparse experts) recipe with tied embeddings, recompute of every block (remat), GQA-native flash
attention (ops/flash_attention: the CUDA kernels K2f/K2q/K2kv on the
card, windowed for mistral), the blocked large-vocab cross-entropy over
the tied embedding, adafactor(1e-3), and runtime/loop.run_training with a
SIGTERM guard.  Weights come from a seed (models/bridge.init_params);
tokens from a seeded torch.Generator, or with --data-dir from
pre-tokenized .rec shards ([seq-len] int32 rows, data/loader).

--ckpt-dir checkpoints every --save-interval steps and once more on
SIGTERM (runtime/train.Checkpointer, async), and a restarted run resumes
from the newest step there.

A job of several processes (the PyTorchJob env MASTER_ADDR /
MASTER_PORT / WORLD_SIZE / RANK, or the TPUJob's; runtime/bootstrap)
lays its ranks out as the JAX script lays its devices out:
make_mesh(local_mesh_axes(world, prefer_tp=--tp)), printed as JAX prints
it.  At --tp 1 it is data parallel: every rank starts from rank 0's
weights, draws its own tokens (seed = rank) or reads its own record
shard (rank of world), and the gradients are averaged over the ranks
before each update (parallel/dp).  At --tp N > 1 the state is sharded
as JAX's state_sharding places it (parallel/tp, parallel/placement):
every rank draws the weights leaf by leaf and keeps its block, the tp
ranks of a data member read the same rows (seed = its index over the
batch axes, or that index's record shard), --per-host-batch is one data
member's rows, and attention runs on each rank's heads.  Rank 0 writes
the checkpoints (whole tensors, so a run resumes under another --tp).
--backend picks the process group's backend (default nccl on the card,
gloo on the CPU).

`--ring` runs attention as sequence-parallel ring flash attention
(ops/ring_flash: the CUDA kernels K3f/K3q/K3kv on the card) over the tp
axis of the mesh, as the JAX script's make_ring_flash_attention_fn(mesh,
"tp") does: a ring of one member at --tp 1; at --tp N the tp ranks of a
data member are the ring's members, and each attention exchanges the
rank's heads for its block of the sequence (parallel/comm.exchange) and
back.  Mistral's window reaches the ring.

`--ep N` (--model mixtral only) carves an expert axis out of dp, as the
JAX script does: the experts are sharded over it (parallel/placement)
and every MoE forward dispatches its tokens to them by all-to-all
(parallel/ep.make_switch_moe, top-2 SwiGLU, capacity factor 1.25).

    python -m tf_operator_tpu_torch.train_llama --smoke --device cpu
    python -m tf_operator_tpu_torch.train_llama --steps 100 --per-host-batch 1 --seq-len 2048
    python -m tf_operator_tpu_torch.train_llama --smoke --ring --steps 2
    python -m tf_operator_tpu_torch.train_llama --smoke --data-dir D --ckpt-dir C --save-interval 1
    python -m tf_operator_tpu_torch.train_llama --smoke --device cpu --model mixtral --steps 3
    WORLD_SIZE=2 RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 python -m tf_operator_tpu_torch.train_llama --smoke --device cpu
    WORLD_SIZE=2 RANK=0 ... train_llama --smoke --device cpu --tp 2 --ring --seq-len 16
    WORLD_SIZE=4 RANK=0 ... train_llama --smoke --device cpu --model mixtral --tp 2 --ep 2
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Iterator, Tuple

import torch

from tf_operator_tpu_torch.data.loader import FieldSpec, host_record_batches
from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models.llama import (
    Llama, llama3_8b, llama31_8b, mistral_7b, mixtral_8x7b, tiny)
from tf_operator_tpu_torch.models.transformer import lm_loss
from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss
from tf_operator_tpu_torch.ops.flash_attention import flash_attention
from tf_operator_tpu_torch.ops.ring_flash import make_ring_flash_attention_fn
from tf_operator_tpu_torch.parallel import dp
from tf_operator_tpu_torch.parallel.ep import make_switch_moe
from tf_operator_tpu_torch.parallel.mesh import local_mesh_axes, make_mesh
from tf_operator_tpu_torch.parallel.placement import shard_model
from tf_operator_tpu_torch.runtime import bootstrap
from tf_operator_tpu_torch.runtime.loop import PreemptionGuard, run_training
from tf_operator_tpu_torch.runtime.optim import Adafactor
from tf_operator_tpu_torch.runtime.profiler import Profiler
from tf_operator_tpu_torch.runtime.train import (
    TRACER, Checkpointer, TrainState, loss_step)

# the JAX script's --smoke --model mixtral: 4 experts in every block, top-2
SMOKE_MOE = dict(n_experts=4, moe_every=1, moe_top_k=2)


def lm_batches(batch: int, seq_len: int, vocab: int, seed: int,
               device=None) -> Iterator[Tuple[torch.Tensor]]:
    """Synthetic [batch, seq_len] token batches, uniform over the vocab,
    from a generator seeded with `seed` on `device` (default the card)."""
    device = resolve_device(device)
    print("data: synthetic")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    while True:
        yield (torch.randint(0, vocab, (batch, seq_len), generator=gen,
                             device=device),)


def token_record_pipeline(data_dir: str, batch: int, seq_len: int,
                          shard: Tuple[int, int] = (0, 1), device=None):
    """This process's disjoint shard (shard_id, n_shards) of pre-tokenized
    on-disk records, each one [seq_len] int32 token row (written with
    data/loader.write_records), as (tokens,) batches on `device` (default
    the card).  On the card each batch is staged in pinned memory, so the
    upload is asynchronous and overlaps the step before it."""
    device = resolve_device(device)
    pin = device.type == "cuda"

    def to_device(rec):
        tokens = torch.from_numpy(rec["tokens"])
        if pin:
            tokens = tokens.pin_memory()
        return (tokens.to(device, non_blocking=pin),)

    return host_record_batches(
        data_dir, [FieldSpec("tokens", (seq_len,), "int32")], batch,
        to_device, shard_id=shard[0], n_shards=shard[1])


def make_lm_step(model: Llama):
    """(state, tokens) -> (state, {"loss"}): the causal-LM loss (the
    blocked CE over a tied embedding, so no [B, S, V] logits exist), its
    gradients, and one optimizer step in place.  In a job of several
    processes `tokens` are this rank's rows; the MoE aux loss spans
    every rank's tokens, and the gradients and the loss are averaged
    over the ranks (parallel/dp).  The head and the cross-entropy are
    the phase span `train_step.head`, forward and backward
    (runtime/train.loss_step has the others)."""
    loss_of = lm_blocked_loss if model.cfg.tie_embeddings else untied_loss
    group = dp.data_group(model)

    def step(state: TrainState, tokens: torch.Tensor):
        return loss_step(state, tokens, lambda: loss_of(model, tokens), group)

    return step


def untied_loss(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """lm_loss(model(tokens), tokens), with the head's logits and the
    cross-entropy inside the phase span `train_step.head`."""
    h = model(tokens, return_hidden=True)
    with TRACER.phase("train_step.head"):
        TRACER.backward_part(h, "train_step.head", "train_step.backward")
        return lm_loss(model.logits(h), tokens)


def build_model(cfg, mesh, job, dev):
    """(the model, (this rank's data member, the member count)): at tp 1
    and ep 1 the one-process model, every rank from rank 0's weights, a
    member a rank; under tp or ep the model sharded over `mesh`
    (parallel/placement), its weights drawn leaf by leaf and this rank's
    block kept."""
    if mesh.shape["tp"] == 1 and mesh.shape["ep"] == 1:
        model = Llama.from_params(
            cfg, bridge.init_params(cfg, 0, device=dev, train=True),
            device=dev, train=True)
        dp.replicate_(model)
        return model, (job.rank, job.world)
    with torch.device("meta"):
        model = Llama(cfg, train=True)
    pl = shard_model(model, mesh, bridge.iter_params(cfg, 0, device=dev,
                                                     train=True), device=dev)
    return model, pl.data_index()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200_000)
    ap.add_argument("--per-host-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=8192)
    ap.add_argument("--data-dir", default="",
                    help="dir of pre-tokenized .rec shards ([seq-len] "
                         "int32 rows, data/loader.write_records). "
                         "Default: synthetic tokens.")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-interval", type=int, default=500)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--model", default="llama3",
                    choices=["llama3", "llama31", "mistral", "mixtral"],
                    help="llama3 = 8B GQA; llama31 = +128k rope scaling; "
                         "mistral = +4k sliding window; mixtral = 8x "
                         "top-2 experts")
    ap.add_argument("--smoke", action="store_true", help="tiny model, CPU ok")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    bootstrap.add_backend_flag(ap)
    args = ap.parse_args(argv)

    job = bootstrap.initialize(device=args.device, backend=args.backend)
    dev = job.device
    if args.ep > 1 and args.model != "mixtral":
        raise SystemExit(
            f"--ep only applies to --model=mixtral (a dense {args.model} "
            f"has nothing to shard over an expert axis)")
    axes = local_mesh_axes(job.world, prefer_tp=args.tp)
    if args.ep > 1:
        if axes["dp"] % args.ep:
            raise SystemExit(f"--ep {args.ep} must divide dp {axes['dp']}")
        axes = {**axes, "ep": args.ep, "dp": axes["dp"] // args.ep}
    mesh = make_mesh(axes)
    print(f"mesh {mesh.shape}")

    attention_fn = flash_attention
    if args.ring:
        attention_fn = make_ring_flash_attention_fn(mesh, "tp")
        print(f"ring attention over {attention_fn.ring}")
    presets = {"llama3": llama3_8b, "llama31": llama31_8b,
               "mistral": mistral_7b, "mixtral": mixtral_8x7b}
    extra = {}
    if args.model == "mixtral":
        n_experts = 4 if args.smoke else 8  # one source for the dispatch fn
        if args.ep > 1:
            # the same dispatch fn runs expert-sharded prefill at inference
            extra["moe_dispatch_fn"] = make_switch_moe(
                mesh, n_experts=n_experts, activation="swiglu", top_k=2)
    if args.smoke:
        if args.model == "mixtral":
            extra.update(SMOKE_MOE, n_experts=n_experts)
        if args.model == "mistral":
            extra["sliding_window"] = 16
        cfg = tiny(tie_embeddings=True, attention_fn=attention_fn, **extra)
    else:
        cfg = presets[args.model](tie_embeddings=True, remat=True,
                                  attention_fn=attention_fn, **extra)
        if args.seq_len > cfg.max_len:
            # extend the RoPE table rather than clamp positions
            cfg = dataclasses.replace(cfg, max_len=args.seq_len)
    seq_len = min(args.seq_len, cfg.max_len)
    print(f"host {job.rank}/{job.world}, device {dev}, model {args.model}"
          f"{' (smoke)' if args.smoke else ''}, {cfg.n_layers} layers, "
          f"batch {args.per_host_batch} x {seq_len}")

    model, member = build_model(cfg, mesh, job, dev)
    state = TrainState.create(model, Adafactor(1e-3))
    if args.data_dir:
        batches = token_record_pipeline(args.data_dir, args.per_host_batch,
                                        seq_len, member, device=dev)
    else:
        batches = lm_batches(args.per_host_batch, seq_len, cfg.vocab_size,
                             seed=member[0], device=dev)
    guard = PreemptionGuard()
    try:
        res = run_training(
            state,
            make_lm_step(model),
            batches,
            num_steps=args.steps,
            checkpointer=(Checkpointer(args.ckpt_dir, async_save=True)
                          if args.ckpt_dir else None),
            save_interval_steps=args.save_interval,
            profiler=Profiler(batch_size=args.per_host_batch * member[1]),
            guard=guard,
            metrics_sink=print,
        )
    finally:
        guard.uninstall()
    status = "preempted (checkpointed)" if res.preempted else "complete"
    print(f"{status}: steps={res.steps_run} resumed_from={res.resumed_from} "
          f"loss={res.last_metrics.get('loss')}")
    return 0 if not res.preempted else 143  # 143 = retryable, gang restarts


if __name__ == "__main__":
    sys.exit(main())
