"""Config #4: BERT-large pretraining (masked-LM objective) on CUDA cards
(or the CPU).

The port of examples/bert/train_bert.py: `bert_large` with
recompute of every block (remat) and flash attention (ops/flash_attention:
the CUDA kernels K2f/K2q/K2kv on the card, non-causal at head dim 64),
the masked mean cross-entropy over f32 logits of the tied head,
adamw(1e-4, weight_decay=0.01), and runtime/loop.run_training with a
SIGTERM guard and, with --ckpt-dir, async checkpoints.  Weights come from
a seed (models/transformer_bridge.init_transformer_params); masked-LM
batches from a torch.Generator seeded with the process's rank.  A job
of several processes is data parallel (runtime/bootstrap, parallel/dp):
the masked mean spans every rank's masked positions, as the JAX step's
mean over the global batch does.

    python -m tf_operator_tpu_torch.train_bert --smoke --device cpu --steps 2
    python -m tf_operator_tpu_torch.train_bert --steps 100
    WORLD_SIZE=2 RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 python -m tf_operator_tpu_torch.train_bert --smoke --device cpu --steps 2
"""
from __future__ import annotations

import argparse
import sys
from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.transformer import (
    Transformer, bert_large, tiny)
from tf_operator_tpu_torch.models.transformer_bridge import (
    init_transformer_params, transformer_from_params)
from tf_operator_tpu_torch.ops.flash_attention import flash_attention
from tf_operator_tpu_torch.parallel import dp
from tf_operator_tpu_torch.runtime import bootstrap
from tf_operator_tpu_torch.runtime.loop import PreemptionGuard, run_training
from tf_operator_tpu_torch.runtime.optim import AdamW
from tf_operator_tpu_torch.runtime.profiler import Profiler
from tf_operator_tpu_torch.runtime.train import (
    Checkpointer, TrainState, loss_step)

MASK_ID = 103  # [MASK]


def mlm_batches(batch: int, seq_len: int, vocab: int, seed: int,
                device=None) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Synthetic masked-LM batches (tokens, labels) on `device` (default
    the card) from a generator seeded with `seed`: 15 % of the positions
    are masked (their input is [MASK], their label the token), the rest
    have label -100."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    while True:
        tokens = torch.randint(0, vocab, (batch, seq_len), generator=gen,
                               device=device)
        mask = torch.rand((batch, seq_len), generator=gen,
                          device=device) < 0.15
        labels = torch.where(mask, tokens, -100)
        yield torch.where(mask, MASK_ID, tokens), labels


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy of the f32 logits over the masked
    positions (label >= 0); 0 when none is masked.

    Under data parallelism (parallel/dp.active()) the mean is over every
    rank's masked positions, whose count differs from rank to rank:
    this rank's sum over world x the global count, so the mean of the
    ranks' losses (and of their gradients) is the global mean's."""
    valid = labels >= 0
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         torch.clamp(labels, min=0).reshape(-1).long(),
                         reduction="none").reshape(labels.shape)
    group = dp.active()
    count = valid.sum().to(torch.float32)
    if group is not None:
        dp.all_reduce_(count, group)
    return (ce * valid).sum() * dp.size(group) / torch.clamp(count, min=1)


def make_mlm_step(model: Transformer):
    """(state, tokens, labels) -> (state, {"loss"}): the masked-LM loss,
    its gradients, and one optimizer step in place; in a job of several
    processes, the global batch's loss and mean gradients
    (parallel/dp)."""
    group = dp.data_group(model)

    def step(state: TrainState, tokens: torch.Tensor, labels: torch.Tensor):
        return loss_step(state, tokens,
                         lambda: mlm_loss(model(tokens, train=True), labels),
                         group)

    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--per-host-batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--smoke", action="store_true", help="tiny model, CPU ok")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    bootstrap.add_backend_flag(ap)
    args = ap.parse_args(argv)

    job = bootstrap.initialize(device=args.device, backend=args.backend)
    dev = job.device
    if args.smoke:
        cfg = tiny()
    else:
        # the hand-written flash kernels on the card's hot path
        cfg = bert_large(remat=True, attention_fn=flash_attention)
    seq_len = min(args.seq_len, cfg.max_len)
    print(f"host {job.rank}/{job.world}, device {dev}, {cfg.n_layers} "
          f"layers, batch {args.per_host_batch} x {seq_len}")

    model = transformer_from_params(
        cfg, init_transformer_params(cfg, 0, device=dev), device=dev)
    dp.replicate_(model)
    state = TrainState.create(model, AdamW(1e-4, weight_decay=0.01))
    guard = PreemptionGuard()
    try:
        res = run_training(
            state,
            make_mlm_step(model),
            mlm_batches(args.per_host_batch, seq_len, cfg.vocab_size,
                        seed=job.rank, device=dev),
            num_steps=args.steps,
            checkpointer=(Checkpointer(args.ckpt_dir, async_save=True)
                          if args.ckpt_dir else None),
            profiler=Profiler(batch_size=args.per_host_batch * job.world),
            guard=guard,
            metrics_sink=print,
        )
    finally:
        guard.uninstall()
    print(f"done: steps={res.steps_run} loss={res.last_metrics.get('loss')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
