"""Config #2: distributed MNIST under the PS+Worker topology, one process
on one CUDA card (or the CPU).

The port of examples/dist-mnist/train_dist_mnist.py: reads the
operator-injected TF_CONFIG and reports its role.  A `ps` replica prints
that parameter serving is framework-internal and exits 0 (the job
succeeds under the worker-0 rule); a worker trains MnistMLP from seed
`index` with sgd(0.01) on its own synthetic data shard (generator seed
1000 + index).

    TF_CONFIG='{"task": {"type": "worker", "index": 0}}' python -m tf_operator_tpu_torch.train_dist_mnist --device cpu --steps 2
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.mnist import MnistMLP
from tf_operator_tpu_torch.runtime.loop import run_training
from tf_operator_tpu_torch.runtime.optim import SGD
from tf_operator_tpu_torch.runtime.train import (
    create_train_state, make_train_step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    tf_config = json.loads(os.environ.get("TF_CONFIG", "{}"))
    task = tf_config.get("task", {})
    role, index = task.get("type", "worker"), task.get("index", 0)
    cluster = tf_config.get("cluster", {})
    print(f"role={role} index={index} cluster_keys={sorted(cluster)}")

    if role == "ps":
        # a TF parameter server would block serving variables here; this
        # path has no PS — exit cleanly so the job can succeed under the
        # worker-0 success rule
        print("ps replica: parameter serving is framework-internal; idling")
        return 0

    dev = resolve_device(args.device)
    model = MnistMLP()
    sample = torch.zeros((args.batch_size, 28, 28, 1))
    state = create_train_state(model, sample, SGD(0.01), seed=index,
                               device=dev)

    def batches():
        gen = torch.Generator(device=dev)
        gen.manual_seed(1000 + index)  # per-worker data shard
        while True:
            yield (torch.randn((args.batch_size, 28, 28, 1), generator=gen,
                               device=dev),
                   torch.randint(0, 10, (args.batch_size,), generator=gen,
                                 device=dev))

    res = run_training(state, make_train_step(model), batches(),
                       num_steps=args.steps, metrics_sink=print)
    print(f"worker {index} done: steps={res.steps_run}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
