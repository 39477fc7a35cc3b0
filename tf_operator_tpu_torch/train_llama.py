"""LLaMA-class GQA decoder pretraining on one CUDA card (or the CPU).

The port of examples/llama/train_llama.py on one device: the llama3_8b
(or llama31_8b) recipe with tied embeddings, recompute of every block
(remat), GQA-native flash attention (ops/flash_attention: the CUDA kernels
K2f/K2q/K2kv on the card), the blocked large-vocab cross-entropy over the
tied embedding, adafactor(1e-3), and runtime/loop.run_training with a
SIGTERM guard.  Weights come from a seed (models/bridge.init_params) and
tokens from a seeded torch.Generator.

`--ring` runs attention as sequence-parallel ring flash attention
(ops/ring_flash: the CUDA kernels K3f/K3q/K3kv on the card) over a ring
of local_mesh_axes(world size, prefer_tp=--tp)["tp"] members, as the JAX
script sizes its ring over tp: one member in one process.

    python -m tf_operator_tpu_torch.train_llama --smoke --device cpu
    python -m tf_operator_tpu_torch.train_llama --steps 100 --per-host-batch 1 --seq-len 2048
    python -m tf_operator_tpu_torch.train_llama --smoke --ring --steps 2

The JAX script's multi-device and data options are not ported yet; each
raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Iterator, Tuple

import torch
import torch.distributed as dist

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models.llama import Llama, llama3_8b, llama31_8b, tiny
from tf_operator_tpu_torch.models.transformer import lm_loss
from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss
from tf_operator_tpu_torch.ops.flash_attention import flash_attention
from tf_operator_tpu_torch.ops.ring_flash import make_ring_flash_attention_fn
from tf_operator_tpu_torch.parallel.mesh import local_mesh_axes
from tf_operator_tpu_torch.parallel.ring import LocalRing
from tf_operator_tpu_torch.runtime.loop import PreemptionGuard, run_training
from tf_operator_tpu_torch.runtime.optim import Adafactor
from tf_operator_tpu_torch.runtime.profiler import Profiler
from tf_operator_tpu_torch.runtime.train import TrainState

_NOT_PORTED = {
    "tp": "ROADMAP Queue 1 item 11 (tensor parallelism)",
    "ep": "ROADMAP Queue 1 item 11 (expert parallelism)",
    "world": "ROADMAP Queue 1 item 11 (a training step split across "
             "processes)",
    "ckpt_dir": "ROADMAP Queue 1 item 9 (Checkpointer)",
    "data_dir": "ROADMAP Queue 1 item 9 (pre-tokenized record shards)",
    "mistral": "ROADMAP Queue 1 item 10 (mistral/mixtral presets)",
    "mixtral": "ROADMAP Queue 1 item 10 (mistral/mixtral presets)",
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
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--model", default="llama3",
                    choices=["llama3", "llama31", "mistral", "mixtral"],
                    help="llama3 = 8B GQA; llama31 = +128k rope scaling")
    ap.add_argument("--smoke", action="store_true", help="tiny model, CPU ok")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    world = world_size()
    for flag, on in (("tp", args.tp > 1), ("ep", args.ep > 1),
                     ("world", world > 1), ("ckpt_dir", bool(args.ckpt_dir)),
                     ("data_dir", bool(args.data_dir)),
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
    presets = {"llama3": llama3_8b, "llama31": llama31_8b}
    if args.smoke:
        cfg = tiny(tie_embeddings=True, attention_fn=attention_fn)
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
    guard = PreemptionGuard()
    try:
        res = run_training(
            state,
            make_lm_step(model),
            lm_batches(args.per_host_batch, seq_len, cfg.vocab_size, seed=0,
                       device=dev),
            num_steps=args.steps,
            profiler=Profiler(batch_size=args.per_host_batch),
            guard=guard,
            metrics_sink=print,
        )
    finally:
        guard.uninstall()
    status = "preempted" if res.preempted else "complete"
    print(f"{status}: steps={res.steps_run} loss={res.last_metrics.get('loss')}")
    return 0 if not res.preempted else 143  # 143 = retryable, gang restarts


if __name__ == "__main__":
    sys.exit(main())
