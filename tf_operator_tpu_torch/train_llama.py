"""LLaMA-class GQA decoder pretraining on one CUDA card (or the CPU).

The port of examples/llama/train_llama.py on one device: the llama3_8b
(llama31_8b, or mistral_7b with its 4096-token sliding window) recipe
with tied embeddings, recompute of every block (remat), GQA-native flash
attention (ops/flash_attention: the CUDA kernels K2f/K2q/K2kv on the
card, windowed for mistral), the blocked large-vocab cross-entropy over
the tied embedding, adafactor(1e-3), and runtime/loop.run_training with a
SIGTERM guard.  Weights come from a seed (models/bridge.init_params);
tokens from a seeded torch.Generator, or with --data-dir from
pre-tokenized .rec shards ([seq-len] int32 rows, data/loader).

--ckpt-dir checkpoints every --save-interval steps and once more on
SIGTERM (runtime/train.Checkpointer, async), and a restarted run resumes
from the newest step there.

`--ring` runs attention as sequence-parallel ring flash attention
(ops/ring_flash: the CUDA kernels K3f/K3q/K3kv on the card) over a ring
of local_mesh_axes(world size, prefer_tp=--tp)["tp"] members, as the JAX
script sizes its ring over tp: one member in one process.

    python -m tf_operator_tpu_torch.train_llama --smoke --device cpu
    python -m tf_operator_tpu_torch.train_llama --steps 100 --per-host-batch 1 --seq-len 2048
    python -m tf_operator_tpu_torch.train_llama --smoke --ring --steps 2
    python -m tf_operator_tpu_torch.train_llama --smoke --data-dir D --ckpt-dir C --save-interval 1

The JAX script's multi-device options and the mixtral preset are not
ported yet; each raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Iterator, Tuple

import torch
import torch.distributed as dist

from tf_operator_tpu_torch.data.loader import FieldSpec, host_record_batches
from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models.llama import (
    Llama, llama3_8b, llama31_8b, mistral_7b, tiny)
from tf_operator_tpu_torch.models.transformer import lm_loss
from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss
from tf_operator_tpu_torch.ops.flash_attention import flash_attention
from tf_operator_tpu_torch.ops.ring_flash import make_ring_flash_attention_fn
from tf_operator_tpu_torch.parallel.mesh import local_mesh_axes
from tf_operator_tpu_torch.parallel.ring import LocalRing
from tf_operator_tpu_torch.runtime.loop import PreemptionGuard, run_training
from tf_operator_tpu_torch.runtime.optim import Adafactor
from tf_operator_tpu_torch.runtime.profiler import Profiler
from tf_operator_tpu_torch.runtime.train import Checkpointer, TrainState

_NOT_PORTED = {
    "tp": "ROADMAP Queue 1 item 11 (tensor parallelism)",
    "ep": "ROADMAP Queue 1 item 11 (expert parallelism)",
    "world": "ROADMAP Queue 1 item 11 (a training step split across "
             "processes)",
    "mixtral": "ROADMAP Queue 1 item 10 (the mixtral preset)",
}


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
    gradients, and one optimizer step in place."""
    loss_of = lm_blocked_loss if model.cfg.tie_embeddings else (
        lambda m, t: lm_loss(m(t), t))

    def step(state: TrainState, tokens: torch.Tensor):
        loss = loss_of(model, tokens)
        loss.backward()
        return state.apply_gradients(), {"loss": loss.detach()}

    return step


def world_size() -> int:
    """Processes of this job: the default process group's size, else the
    launcher's WORLD_SIZE (1 when unset)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


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
                         "mistral = +4k sliding window")
    ap.add_argument("--smoke", action="store_true", help="tiny model, CPU ok")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    world = world_size()
    for flag, on in (("tp", args.tp > 1), ("ep", args.ep > 1),
                     ("world", world > 1),
                     (args.model, args.model in _NOT_PORTED)):
        if on:
            raise NotImplementedError(
                f"{flag}: not ported yet ({_NOT_PORTED[flag]})")
    dev = resolve_device(args.device)

    attention_fn = flash_attention
    if args.ring:
        ring = LocalRing(local_mesh_axes(world, prefer_tp=args.tp)["tp"])
        attention_fn = make_ring_flash_attention_fn(ring)
        print(f"ring attention over {ring}")
    presets = {"llama3": llama3_8b, "llama31": llama31_8b,
               "mistral": mistral_7b}
    if args.smoke:
        extra = {"sliding_window": 16} if args.model == "mistral" else {}
        cfg = tiny(tie_embeddings=True, attention_fn=attention_fn, **extra)
    else:
        cfg = presets[args.model](tie_embeddings=True, remat=True,
                                  attention_fn=attention_fn)
        if args.seq_len > cfg.max_len:
            # extend the RoPE table rather than clamp positions
            cfg = dataclasses.replace(cfg, max_len=args.seq_len)
    seq_len = min(args.seq_len, cfg.max_len)
    print(f"device {dev}, model {args.model}{' (smoke)' if args.smoke else ''}"
          f", {cfg.n_layers} layers, batch {args.per_host_batch} x {seq_len}")

    model = Llama.from_params(
        cfg, bridge.init_params(cfg, 0, device=dev, train=True),
        device=dev, train=True)
    state = TrainState.create(model, Adafactor(1e-3))
    if args.data_dir:
        # one process: shard 0 of 1 (a job of several is refused above)
        batches = token_record_pipeline(args.data_dir, args.per_host_batch,
                                        seq_len, (0, 1), device=dev)
    else:
        batches = lm_batches(args.per_host_batch, seq_len, cfg.vocab_size,
                             seed=0, device=dev)
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
            profiler=Profiler(batch_size=args.per_host_batch),
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
