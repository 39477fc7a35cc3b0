"""Config #1: single-replica MNIST CNN on one CUDA card (or the CPU).

The port of examples/mnist/train_mnist.py: MnistCNN from a seed
(runtime/train.create_train_state), adam(1e-3), runtime/train's train
step, checkpoint/resume and metrics lines every --log-interval steps.
Synthetic MNIST-shaped data from a seeded torch.Generator keeps it
hermetic.  The job's env is read as the JAX script reads it
(runtime/bootstrap) and the process reports its rank, but each process
trains its own replica, as the JAX script's step without a mesh does.

    python -m tf_operator_tpu_torch.train_mnist --device cpu --steps 2
"""
from __future__ import annotations

import argparse
import sys
from typing import Iterator, Tuple

import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.mnist import MnistCNN
from tf_operator_tpu_torch.runtime import bootstrap
from tf_operator_tpu_torch.runtime.loop import PreemptionGuard, run_training
from tf_operator_tpu_torch.runtime.optim import Adam
from tf_operator_tpu_torch.runtime.profiler import Profiler
from tf_operator_tpu_torch.runtime.train import (
    Checkpointer, create_train_state, make_train_step)


def synthetic_mnist(batch_size: int, seed: int = 0, device=None
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(f32 normal images [B, 28, 28, 1], labels in [0, 10)) on `device`
    (default the card) from a generator seeded with `seed`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    while True:
        x = torch.randn((batch_size, 28, 28, 1), generator=gen,
                        device=device)
        y = torch.randint(0, 10, (batch_size,), generator=gen, device=device)
        yield x, y


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-interval", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    job = bootstrap.initialize(device=args.device)
    dev = job.device
    print(f"process {job.rank}/{job.world}, device={dev}")

    model = MnistCNN()
    sample = torch.zeros((args.batch_size, 28, 28, 1))
    state = create_train_state(model, sample, Adam(1e-3), seed=0, device=dev)
    guard = PreemptionGuard()
    try:
        res = run_training(
            state,
            make_train_step(model, data_parallel=False),
            synthetic_mnist(args.batch_size, device=dev),
            num_steps=args.steps,
            checkpointer=Checkpointer(args.ckpt_dir) if args.ckpt_dir
            else None,
            profiler=Profiler(batch_size=args.batch_size),
            guard=guard,
            log_interval_steps=args.log_interval,
            metrics_sink=print,
        )
    finally:
        guard.uninstall()
    print(f"done: steps={res.steps_run} loss={res.last_metrics.get('loss')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
