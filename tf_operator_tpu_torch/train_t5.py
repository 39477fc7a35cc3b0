"""Config #5: T5-3B-scale decoder LM on CUDA cards (or the CPU), with
checkpoints every save interval and on SIGTERM.

The port of examples/t5/train_t5.py: `t5_3b_decoder` with
recompute of every block (remat) and causal flash attention
(ops/flash_attention: the CUDA kernels K2f/K2q/K2kv on the card, head
dim 64), the causal-LM loss plus the weighted MoE aux loss
(models/transformer.lm_train_loss) or, with --blocked-ce, the blocked
large-vocab cross-entropy over the tied embedding (no [B, S, V] logits),
adafactor(1e-3), and runtime/loop.run_training.  --ckpt-dir checkpoints
every --save-interval steps and once more on SIGTERM (async), a
restarted run resumes from the newest step there, and a preempted run
exits 143 (retryable: the gang restarts).  Weights come from a seed;
tokens from a torch.Generator seeded with the process's data member.  A
job of several processes lays its ranks out on
make_mesh(local_mesh_axes(world, prefer_tp=--tp)) as the JAX script
does (runtime/bootstrap): at --tp 1 it is data parallel (parallel/dp),
at --tp N > 1 the state is sharded as JAX's state_sharding places it
(parallel/tp, parallel/placement; the tp ranks of a data member read
the same rows, --per-host-batch is a member's rows).  Rank 0 writes the
checkpoints, every rank resumes from them, and every rank stops at the
same step on SIGTERM.

    python -m tf_operator_tpu_torch.train_t5 --smoke --device cpu --steps 2 --blocked-ce
    python -m tf_operator_tpu_torch.train_t5 --steps 100 --ckpt-dir C
"""
from __future__ import annotations

import argparse
import sys
from typing import Iterator, Tuple

import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.transformer import (
    Transformer, lm_train_loss, t5_3b_decoder, tiny)
from tf_operator_tpu_torch.models.transformer_bridge import (
    init_transformer_params, iter_transformer_params,
    transformer_from_params)
from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss
from tf_operator_tpu_torch.ops.flash_attention import flash_attention
from tf_operator_tpu_torch.parallel import dp
from tf_operator_tpu_torch.parallel.mesh import local_mesh_axes, make_mesh
from tf_operator_tpu_torch.parallel.placement import shard_model
from tf_operator_tpu_torch.runtime import bootstrap
from tf_operator_tpu_torch.runtime.loop import PreemptionGuard, run_training
from tf_operator_tpu_torch.runtime.optim import Adafactor
from tf_operator_tpu_torch.runtime.profiler import Profiler
from tf_operator_tpu_torch.runtime.train import (
    Checkpointer, TrainState, loss_step)


def lm_batches(batch: int, seq_len: int, vocab: int, seed: int,
               device=None) -> Iterator[Tuple[torch.Tensor]]:
    """Synthetic [batch, seq_len] token batches, uniform over the vocab,
    from a generator seeded with `seed` on `device` (default the card)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    while True:
        yield (torch.randint(0, vocab, (batch, seq_len), generator=gen,
                             device=device),)


def make_lm_step(model: Transformer, blocked_ce: bool = False):
    """(state, tokens) -> (state, {"loss"}): the causal-LM loss (fused
    with the tied head by the blocked CE when `blocked_ce`), its
    gradients, and one optimizer step in place; in a job of several
    processes, the global batch's loss and mean gradients
    (parallel/dp)."""
    loss_of = lm_blocked_loss if blocked_ce else lm_train_loss
    group = dp.data_group(model)

    def step(state: TrainState, tokens: torch.Tensor):
        return loss_step(state, tokens, lambda: loss_of(model, tokens), group)

    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--per-host-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-interval", type=int, default=500)
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel degree")
    ap.add_argument("--blocked-ce", action="store_true",
                    help="fused large-vocab CE (no [B,S,V] logits)")
    ap.add_argument("--smoke", action="store_true", help="tiny model, CPU ok")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    bootstrap.add_backend_flag(ap)
    args = ap.parse_args(argv)

    job = bootstrap.initialize(device=args.device, backend=args.backend)
    dev = job.device
    mesh = make_mesh(local_mesh_axes(job.world, prefer_tp=args.tp))
    print(f"mesh {mesh.shape}")
    if args.smoke:
        cfg = tiny(causal=True)
    else:
        cfg = t5_3b_decoder(remat=True, attention_fn=flash_attention)
    seq_len = min(args.seq_len, cfg.max_len)
    print(f"host {job.rank}/{job.world} slice {job.slice.slice_id}/"
          f"{job.slice.num_slices}, device {dev}, {cfg.n_layers} layers, "
          f"batch {args.per_host_batch} x {seq_len}")

    if mesh.shape["tp"] == 1:
        model = transformer_from_params(
            cfg, init_transformer_params(cfg, 0, device=dev), device=dev)
        dp.replicate_(model)
        member = (job.rank, job.world)
    else:
        with torch.device("meta"):
            model = Transformer(cfg)
        member = shard_model(model, mesh, iter_transformer_params(
            cfg, 0, device=dev), device=dev).data_index()
    state = TrainState.create(model, Adafactor(1e-3))
    guard = PreemptionGuard()
    try:
        res = run_training(
            state,
            make_lm_step(model, blocked_ce=args.blocked_ce),
            lm_batches(args.per_host_batch, seq_len, cfg.vocab_size,
                       seed=member[0], device=dev),
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
    print(f"{status}: steps={res.steps_run} resumed_from={res.resumed_from}")
    return 0 if not res.preempted else 143  # 143 = retryable, gang restarts


if __name__ == "__main__":
    sys.exit(main())
