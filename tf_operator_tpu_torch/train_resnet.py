"""Config #3: ResNet-50 training on CUDA cards (or the CPU).

The port of examples/resnet50/train_resnet.py: ResNet50
(models/resnet.py: NHWC input, bf16 convolutions on cuDNN in
channels_last memory, flax's BatchNorm with running stats) from a seed
(runtime/train.create_train_state), sgd(0.1 x world, momentum=0.9),
runtime/train.make_train_step and runtime/loop.run_training with a
SIGTERM guard.  Batches are synthetic (a seeded torch.Generator) or,
with --data-dir, .rec shards of (uint8 [S, S, 3] image, int32 label)
records (data/loader.write_records), scaled to [-1, 1] in bf16.
--trace-dir captures a torch.profiler trace of steps 10-30.

A job of several processes is data parallel over every process, as the
JAX script's mesh {"dp": -1} is (runtime/bootstrap, parallel/dp): each
rank draws its own images (seed = rank) or reads its own record shard,
BatchNorm's statistics span every rank's images (so the running stats
stay equal on every rank), and the gradients are averaged over the
ranks before each update.

    python -m tf_operator_tpu_torch.train_resnet --device cpu --image-size 32 --per-host-batch 2 --steps 2
    python -m tf_operator_tpu_torch.train_resnet --steps 100
    WORLD_SIZE=2 RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 python -m tf_operator_tpu_torch.train_resnet --device cpu --image-size 32 --per-host-batch 2 --steps 2
"""
from __future__ import annotations

import argparse
import sys
from typing import Iterator, Tuple

import numpy as np
import torch

from tf_operator_tpu_torch.data.loader import FieldSpec, host_record_batches
from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.resnet import ResNet50
from tf_operator_tpu_torch.parallel import dp
from tf_operator_tpu_torch.runtime import bootstrap
from tf_operator_tpu_torch.runtime.loop import PreemptionGuard, run_training
from tf_operator_tpu_torch.runtime.optim import SGD
from tf_operator_tpu_torch.runtime.profiler import Profiler
from tf_operator_tpu_torch.runtime.train import (
    Checkpointer, create_train_state, make_train_step)


def synthetic_imagenet(batch: int, image_size: int, seed: int, device=None
                       ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(bf16 normal images [B, S, S, 3], labels in [0, 1000)) on `device`
    (default the card) from a generator seeded with `seed`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    while True:
        x = torch.randn((batch, image_size, image_size, 3), generator=gen,
                        device=device, dtype=torch.bfloat16)
        y = torch.randint(0, 1000, (batch,), generator=gen, device=device)
        yield x, y


def record_pipeline(data_dir: str, batch: int, image_size: int,
                    shard: Tuple[int, int] = (0, 1), device=None):
    """This process's shard (shard_id, n_shards) of on-disk (image,
    label) records as (bf16 [B, S, S, 3] images / 127.5 - 1, labels) on
    `device` (default the card): the uint8 image cast to bf16, then
    divided and shifted in bf16, as the JAX script does."""
    device = resolve_device(device)

    def to_batch(rec):
        x = torch.from_numpy(rec["image"]).to(device).to(torch.bfloat16)
        return (x / 127.5 - 1.0,
                torch.from_numpy(rec["label"]).to(device).long())

    return host_record_batches(
        data_dir,
        [FieldSpec("image", (image_size, image_size, 3), np.uint8),
         FieldSpec("label", (), np.int32)],
        batch, to_batch, shard_id=shard[0], n_shards=shard[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--per-host-batch", type=int, default=256)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--data-dir", default="",
                    help=".rec shards (data/loader.py format). Default: "
                         "synthetic.")
    ap.add_argument("--trace-dir", default="",
                    help="capture a torch.profiler trace of steps 10-30 "
                         "(runtime/profiler.py bounded window)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    bootstrap.add_backend_flag(ap)
    args = ap.parse_args(argv)

    job = bootstrap.initialize(device=args.device, backend=args.backend)
    world, dev = job.world, job.device
    print(f"host {job.rank}/{world}: 1 device ({dev}), dp {world}")

    model = ResNet50(num_classes=1000)
    sample = torch.zeros((args.per_host_batch, args.image_size,
                          args.image_size, 3), dtype=torch.bfloat16)
    state = create_train_state(model, sample,
                               SGD(0.1 * world, momentum=0.9), seed=0,
                               device=dev)
    dp.replicate_(model)
    step_fn = make_train_step(model)
    if args.data_dir:
        data = record_pipeline(args.data_dir, args.per_host_batch,
                               args.image_size, (job.rank, world), device=dev)
    else:
        print("data: synthetic")
        data = synthetic_imagenet(args.per_host_batch, args.image_size,
                                  seed=job.rank, device=dev)
    guard = PreemptionGuard()
    try:
        res = run_training(
            state,
            step_fn,
            data,
            num_steps=args.steps,
            checkpointer=Checkpointer(args.ckpt_dir) if args.ckpt_dir
            else None,
            profiler=Profiler(trace_dir=args.trace_dir or None,
                              batch_size=args.per_host_batch * world),
            guard=guard,
            metrics_sink=print,
        )
    finally:
        guard.uninstall()
    print(f"done: steps={res.steps_run} preempted={res.preempted}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
