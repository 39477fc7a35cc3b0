"""The multi-process ring (tf_operator_tpu_torch.parallel.ring.ProcessRing)
under gloo on the CPU, 2 and 4 processes: each rank's output shard and the
gradients of its q, k and v shards equal LocalRing's for the same member,
bit for bit.  Both rings run the same arithmetic in the same order (the
ring code is written once, over the members a process holds), and both
sides run on one CPU thread, so the sums are taken in one order.

Cases: the kernel ring (ops.ring_flash, whose backward rotates k, v, dk
and dv together and closes the loop) causal with GQA, zigzag with a
window, non-causal; and the einsum ring (ops.ring_attention), whose
gradients flow through the rotation's autograd Function.

Processes start with torch.multiprocessing's spawn and meet through a
file under tmp_path, never a fixed TCP port; init_process_group has a
60 s timeout and the join its own deadline, so a hang fails the test.
This file imports nothing of JAX, so the spawned processes start quickly.
"""
import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tf_operator_tpu_torch.ops import ring_attention as tra
from tf_operator_tpu_torch.ops import ring_flash as trf
from tf_operator_tpu_torch.parallel.ring import LocalRing, ProcessRing

B, SL, H, D = 2, 32, 4, 16
DEADLINE_S = 150
# (ring, kv heads, causal, layout, window)
CASES = [("flash", 2, True, "contiguous", None),
         ("flash", 1, True, "zigzag", 20),
         ("flash", 4, False, "contiguous", None),
         ("einsum", 2, True, "zigzag", None)]


def _inputs(seed, n, kv):
    """Global [B, n*SL, heads, D] q, k, v, dO (zigzag cases are taken as
    already in storage order)."""
    rng = np.random.default_rng(seed)
    f = lambda h: torch.from_numpy(
        rng.standard_normal((B, n * SL, h, D)).astype(np.float32))
    return f(H), f(kv), f(kv), f(H)


def _run(ring, n):
    """Each held member's (out, dq, dk, dv) for every case."""
    results = []
    for i, (kind, kv, causal, layout, window) in enumerate(CASES):
        x = _inputs(i, n, kv)
        shards = [[t[:, my * SL:(my + 1) * SL] for my in ring.members]
                  for t in x]
        leaves = [[s.clone().requires_grad_() for s in ts]
                  for ts in shards[:3]]
        fn = (trf.ring_flash_attention if kind == "flash"
              else tra.ring_attention)
        outs = fn(*leaves, causal, ring=ring, layout=layout, window=window)
        torch.autograd.backward(outs, shards[3])
        results.append([(o.detach(), q.grad, k.grad, v.grad)
                        for o, q, k, v in zip(outs, *leaves)])
    return results


def _worker(rank, n, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=60))
    try:
        ring = ProcessRing()
        assert ring.size == n and ring.members == (rank,)
        torch.save(_run(ring, n), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [2, 4])
def test_process_ring_equals_local_ring(n, tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, n, str(tmp_path / "init"), str(tmp_path)))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not hung, f"ranks still running after {DEADLINE_S} s: {hung}"
    assert [p.exitcode for p in procs] == [0] * n

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _run(LocalRing(n), n)
    finally:
        torch.set_num_threads(threads)
    for r in range(n):
        got = torch.load(tmp_path / f"rank{r}.pt")
        for case, g, w in zip(CASES, got, want):
            for name, a, b in zip(("out", "dq", "dk", "dv"), g[0], w[r]):
                assert torch.equal(a, b), (r, case, name)


def test_rings_refuse_a_shard_count_that_is_not_their_members():
    ring = LocalRing(2)
    with pytest.raises(ValueError, match="2 members"):
        ring.rotate([(torch.zeros(1),)], 1)
    x = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="held ring members"):
        trf.ring_flash_attention([x], [x], [x], True, ring=ring)
