"""Data-parallel cases for tests/test_torch_dp.py and tests/test_torch_lora.py:
each case trains a small f32 model for two steps, either as one rank of
a gloo process group on its rows of the global batch, or as one process
on the whole batch, and returns what the tests compare (losses,
parameters, running stats).

Ranks start with torch.multiprocessing's spawn and meet through a file
under tmp_path, never a fixed TCP port; init_process_group has a 60 s
timeout and the join its own deadline, so a hang fails the test.  This
module imports nothing of JAX, so the spawned processes start quickly.
"""
import contextlib
import datetime
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tf_operator_tpu_torch.ops.flash_attention import flash_attention

DEADLINE_S = 150
STEPS = 2


def _rows(x: np.ndarray, shard):
    """The rows of a global batch this rank holds: all of them for one
    process (shard None), else the rank's equal slice."""
    if shard is None:
        return torch.from_numpy(x)
    r, n = shard
    per = x.shape[0] // n
    return torch.from_numpy(x[r * per:(r + 1) * per])


def _snapshot(state):
    return {"params": {k: p.detach().clone() for k, p in state.params.items()},
            "stats": {k: b.detach().clone()
                      for k, b in state.batch_stats.items()}}


def _train(state, step, batches):
    start = _snapshot(state)["params"]
    losses = []
    for batch in batches:
        state, m = step(state, *batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "start": start, **_snapshot(state)}


def _tokens(seed: int, b: int, s: int, vocab: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (b, s)).astype(np.int64)
            for _ in range(STEPS)]


def llama_case(shard, moe: bool = False):
    """train_llama's smoke recipe (tied tiny Llama, blocked CE, flash
    attention's plain version, adafactor), or its mixtral smoke model
    (4 experts a block, top-2: the aux loss spans the global batch)."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.runtime.optim import Adafactor
    from tf_operator_tpu_torch.runtime.train import TrainState

    extra = train_llama.SMOKE_MOE if moe else {}
    cfg = llama.tiny(tie_embeddings=True, dtype=torch.float32,
                     attention_fn=flash_attention, **extra)
    model = llama.Llama.from_params(
        cfg, bridge.init_params(cfg, 0, device="cpu", train=True),
        device="cpu", train=True)
    state = TrainState.create(model, Adafactor(1e-3))
    step = train_llama.make_lm_step(model)
    toks = _tokens(1, 4, 32, cfg.vocab_size)
    return _train(state, step, [(_rows(t, shard),) for t in toks])


def bert_case(shard):
    """train_bert's step (masked-LM loss, adamw) on the tiny
    Transformer, over masks that cover the ranks' rows unevenly."""
    from tf_operator_tpu_torch import train_bert
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.models.transformer_bridge import (
        init_transformer_params, transformer_from_params)
    from tf_operator_tpu_torch.runtime.optim import AdamW
    from tf_operator_tpu_torch.runtime.train import TrainState

    cfg = tt.tiny(dtype=torch.float32, attention_fn=flash_attention)
    model = transformer_from_params(
        cfg, init_transformer_params(cfg, 0, device="cpu"), device="cpu")
    state = TrainState.create(model, AdamW(1e-3, weight_decay=0.01))
    step = train_bert.make_mlm_step(model)
    rng = np.random.default_rng(2)
    batches, counts = [], []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int64)
        # rows 0-1 masked at 10 %, rows 2-3 at 30 %
        rate = np.array([0.1, 0.1, 0.3, 0.3])[:, None]
        mask = rng.random((4, 32)) < rate
        labels = np.where(mask, toks, -100)
        toks = np.where(mask, train_bert.MASK_ID, toks)
        counts.append(int((_rows(labels, shard) >= 0).sum()))
        batches.append((_rows(toks, shard), _rows(labels, shard)))
    return {**_train(state, step, batches), "masked": counts}


RESNET = dict(stage_sizes=[1, 1], width=8, num_classes=10)


def resnet_images(seed: int, b: int = 4, size: int = 32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, (b,)).astype(np.int64))


def resnet_case(shard, params=None, accum_steps: int = 1):
    """runtime/train.make_train_step on a small f32 ResNet (stages [1, 1],
    width 8, 32² images) with sgd(0.1, momentum=0.9): BatchNorm's
    statistics and running stats span every rank's images.  `params`
    (a state dict, default seeded draws) are the starting variables."""
    from tf_operator_tpu_torch.models.resnet import ResNet
    from tf_operator_tpu_torch.runtime.optim import SGD
    from tf_operator_tpu_torch.runtime.train import (
        TrainState, create_train_state, make_train_step)

    model = ResNet(dtype=torch.float32, **RESNET)
    x, _ = resnet_images(0)
    if params is None:
        state = create_train_state(model, torch.from_numpy(x),
                                   SGD(0.1, momentum=0.9), seed=3,
                                   device="cpu")
    else:
        model.load_state_dict(params)
        state = TrainState.create(model, SGD(0.1, momentum=0.9))
    step = make_train_step(model, accum_steps=accum_steps)
    batches = []
    for i in range(STEPS):
        xi, yi = resnet_images(10 + i)
        batches.append((_rows(xi, shard), _rows(yi, shard)))
    return _train(state, step, batches)


def lora_case(shard):
    """A LoRA finetune (models/lora) of the tiny f32 Llama: rank-4
    adapters attached, Adam(5e-3) over the adapters alone, train_llama's
    step on the untied model's lm_loss."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import bridge, llama, lora
    from tf_operator_tpu_torch.runtime.optim import Adam
    from tf_operator_tpu_torch.runtime.train import TrainState

    cfg = llama.tiny(dtype=torch.float32)
    model = llama.Llama.from_params(
        cfg, bridge.init_params(cfg, 0, device="cpu", train=True),
        device="cpu", train=True)
    gen = torch.Generator().manual_seed(1)
    adapters = lora.init(gen, model.state_dict(), rank=4)
    # a nonzero B, so the first step's gradient reaches A as well
    for ad in adapters.values():
        ad["b"].normal_(0.0, 0.05, generator=gen)
    state = TrainState.create(model, Adam(5e-3),
                              params=lora.attach(model, adapters))
    step = train_llama.make_lm_step(model)
    toks = _tokens(4, 4, cfg.max_len, cfg.vocab_size)
    return _train(state, step, [(_rows(t, shard),) for t in toks])


def _quiet(main, argv):
    """(exit code, stdout) of an entry point's main(argv)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def cli_case(shard, ckpt_dir: str):
    """The four training CLIs in a job of WORLD_SIZE ranks (the group is
    already up, so bootstrap uses it): train_llama --smoke with a
    checkpoint a step, then resumed; train_bert --smoke; train_t5 --smoke
    --blocked-ce with a checkpoint, then resumed with SIGTERM latched on
    the last rank alone after one step; train_resnet at 32².  Returns each run's (exit code, stdout)."""
    from tf_operator_tpu_torch import (train_bert, train_llama,
                                       train_resnet, train_t5)
    from tf_operator_tpu_torch.runtime.loop import PreemptionGuard

    r, n = shard
    os.environ.update(WORLD_SIZE=str(n), RANK=str(r))
    cpu = ["--device", "cpu", "--steps", "2", "--per-host-batch", "2"]
    llama_argv = ["--smoke", "--seq-len", "16", "--ckpt-dir",
                  f"{ckpt_dir}/llama", "--save-interval", "1"] + cpu
    t5_argv = ["--smoke", "--blocked-ce", "--seq-len", "16", "--ckpt-dir",
               f"{ckpt_dir}/t5", "--save-interval", "1"] + cpu
    runs = {"llama": _quiet(train_llama.main, llama_argv),
            "llama-resume": _quiet(train_llama.main,
                                   llama_argv + ["--steps", "3"]),
            "bert": _quiet(train_bert.main,
                           ["--smoke", "--seq-len", "16"] + cpu),
            "t5": _quiet(train_t5.main, t5_argv)}

    class LastRankPreempted(PreemptionGuard):
        """SIGTERM latched on the last rank alone, after its first step."""

        def __init__(self, install=True):
            super().__init__(install=False)
            self.calls = 0

        def should_stop(self):
            self.calls += 1
            if r == n - 1 and self.calls == 2:
                self.trigger()
            return super().should_stop()

    real = train_t5.PreemptionGuard
    train_t5.PreemptionGuard = LastRankPreempted
    try:
        runs["t5-preempted"] = _quiet(train_t5.main,
                                      t5_argv + ["--steps", "9"])
    finally:
        train_t5.PreemptionGuard = real
    runs["resnet"] = _quiet(train_resnet.main,
                            ["--image-size", "32"] + cpu)
    return runs


CASES = {"llama": llama_case,
         "mixtral": lambda shard: llama_case(shard, moe=True),
         "bert": bert_case, "resnet": resnet_case,
         # the same case from given variables (the JAX-drawn ones)
         "resnet_jax": resnet_case, "lora": lora_case, "cli": cli_case}


def _worker(rank, n, init_file, out_dir, cases, kw):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=60))
    try:
        out = {c: CASES[c]((rank, n), **kw.get(c, {})) for c in cases}
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(cases, tmp_path, n: int = 2, kw=None):
    """Run `cases` (names in CASES) in n spawned gloo ranks; returns each
    rank's {case: result}."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, n, str(tmp_path / "init"), str(tmp_path),
                               list(cases), kw or {}))
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
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


def one_process(case: str, **kw):
    """`case` as one process on the whole batch, on one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return CASES[case](None, **kw)
    finally:
        torch.set_num_threads(threads)
