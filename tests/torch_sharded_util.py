"""Sharded-training cases for tests/test_torch_sharded.py: each case trains
a small f32 model for two steps, either as one rank of a job of gloo
processes over a tp x fsdp x dp mesh (parallel/mesh, parallel/placement:
each rank holds its shard of JAX's state_sharding layout and reads its
data member's rows of the global batch), or as one process on the whole
batch, and returns what the tests compare: the losses, the global
gradient norms before each update, and the whole parameters after the
two steps (gathered leaf by leaf to rank 0).

The job starts with torch.multiprocessing's spawn and meets through a
file under tmp_path, never a fixed TCP port; init_process_group has a
60 s timeout and the join its own deadline, so a hang fails the test.
This module imports nothing of JAX, so the spawned processes start
quickly.
"""
import contextlib
import datetime
import io
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tf_operator_tpu_torch.ops.flash_attention import flash_attention

DEADLINE_S = 150
STEPS = 2
BATCH = 8
MESH = {"tp": 2, "fsdp": 2, "dp": 2}       # JAX's test mesh
MESH_TP4 = {"tp": 4, "fsdp": 2}            # replicates tiny's wkv (KV=2)


def tokens(seed: int, vocab: int, seq: int, steps: int = STEPS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (BATCH, seq)).astype(np.int64)
            for _ in range(steps)]


def _mesh(axes):
    from tf_operator_tpu_torch.parallel.mesh import make_mesh

    return None if axes is None else make_mesh(axes)


def _rows(x: np.ndarray, model):
    """This process's rows of the global batch, on the model's device:
    all of them for one process, else its data member's equal slice (its
    tp peers read the same rows)."""
    dev = next(model.parameters()).device
    pl = getattr(model, "placement", None)
    if pl is None:
        return torch.from_numpy(x).to(dev)
    i, n = pl.data_index()
    per = x.shape[0] // n
    return torch.from_numpy(x[i * per:(i + 1) * per]).to(dev)


def _build(make, cfg, full, mesh, min_fsdp_size, device):
    """The model of `cfg` around the whole parameters `full` on `device`:
    as it is in one process, or sharded over `mesh`."""
    from tf_operator_tpu_torch.parallel.placement import shard_model

    if mesh is None:
        return make(cfg, full, device)
    with torch.device("meta"):
        model = make.meta(cfg)
    shard_model(model, mesh, full, device=device,
                min_fsdp_size=min_fsdp_size)
    return model


class _Llama:
    @staticmethod
    def __call__(cfg, full, device):
        from tf_operator_tpu_torch.models.llama import Llama

        return Llama.from_params(cfg, {k: v.clone() for k, v in full.items()},
                                 device=device, train=True)

    @staticmethod
    def meta(cfg):
        from tf_operator_tpu_torch.models.llama import Llama

        return Llama(cfg, train=True)


class _Transformer:
    @staticmethod
    def __call__(cfg, full, device):
        from tf_operator_tpu_torch.models.transformer_bridge import (
            transformer_from_params)

        return transformer_from_params(
            cfg, {k: v.clone() for k, v in full.items()}, device=device)

    @staticmethod
    def meta(cfg):
        from tf_operator_tpu_torch.models.transformer import Transformer

        return Transformer(cfg)


LLAMA, TRANSFORMER = _Llama(), _Transformer()


def _grad_norm(state) -> float:
    if state.layout is not None:
        return state.layout.grad_norm(state.params)
    return math.sqrt(sum(float(p.grad.double().pow(2).sum())
                         for p in state.params.values()
                         if p.grad is not None))


def _whole(state):
    """Every parameter whole (every rank gathers; the readings are rank
    0's)."""
    lay = state.layout
    return {k: (p.detach().clone() if lay is None
                else lay.full(p.detach(), lay.spec(k)).clone())
            for k, p in state.params.items()}


def _train(model, state, step, batches):
    """Run the steps; the gradient norm is read as the update starts,
    after the step completed the gradients."""
    gnorms, losses = [], []
    start = _whole(state)
    apply = state.apply_gradients

    def reading():
        gnorms.append(_grad_norm(state))
        return apply()

    state.apply_gradients = reading
    for batch in batches:
        state, m = step(state, *(_rows(b, model) for b in batch))
        losses.append(float(m["loss"]))
    state.apply_gradients = apply
    return {"losses": losses, "gnorms": gnorms,
            "start": {k: v.cpu() for k, v in start.items()},
            "params": {k: v.cpu() for k, v in _whole(state).items()}}


def _lm_step(model, loss_of):
    """make_lm_step's step over any loss of (model, tokens)."""
    from tf_operator_tpu_torch.parallel import dp

    group = dp.data_group(model)

    def step(state, toks):
        with dp.replicas(group):
            loss = loss_of(model, toks)
            loss.backward()
        return dp.finish_step(state, {"loss": loss.detach()}, group)

    return step


def _tx(name: str):
    from tf_operator_tpu_torch.runtime.optim import Adafactor, Adam, AdamW

    return {"adam": lambda: Adam(1e-3), "adafactor": lambda: Adafactor(1e-3),
            "adamw": lambda: AdamW(1e-3, weight_decay=0.01)}[name]()


def llama_case(axes, full=None, toks=None, moe=False, d_ff=128,
               tied=True, opt="adafactor", min_fsdp_size=0, lora_rank=0,
               device="cpu"):
    """A tiny f32 Llama under train_llama's step (blocked CE over the
    tied embedding, or the untied lm_loss), from `full` (default the
    seeded draws) on `toks` (default seeded); `moe`: the mixtral smoke
    model; `lora_rank`: LoRA adapters of that rank train alone."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import bridge, llama, lora
    from tf_operator_tpu_torch.runtime.train import TrainState

    extra = train_llama.SMOKE_MOE if moe else {}
    cfg = llama.tiny(tie_embeddings=tied, dtype=torch.float32, d_ff=d_ff,
                     attention_fn=flash_attention if tied else None, **extra)
    if full is None:
        full = bridge.init_params(cfg, 0, device="cpu", train=True)
    model = _build(LLAMA, cfg, full, _mesh(axes), min_fsdp_size, device)
    params = None
    if lora_rank:
        gen = torch.Generator().manual_seed(3)
        ad = lora.init(gen, full, rank=lora_rank)
        # B = 0 at init: give it values so both adapters get gradients
        for a in ad.values():
            a["b"].normal_(0.0, 0.05, generator=gen)
        params = lora.attach(model, ad)
    state = TrainState.create(model, _tx(opt), params=params)
    if toks is None:
        toks = tokens(1, cfg.vocab_size, 32)
    return _train(model, state, train_llama.make_lm_step(model),
                  [(t,) for t in toks])


def transformer_case(axes, full=None, toks=None, opt="adafactor",
                     blocked_chunk=None, cfg_kw=None, min_fsdp_size=0,
                     device="cpu"):
    """The tiny causal f32 Transformer under train_t5's step (its LM loss
    plus the MoE aux, or the blocked CE with `blocked_chunk`)."""
    from tf_operator_tpu_torch import train_t5
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.models.transformer_bridge import (
        init_transformer_params)
    from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss
    from tf_operator_tpu_torch.runtime.train import TrainState

    cfg = tt.tiny(causal=True, dtype=torch.float32,
                  attention_fn=flash_attention, **(cfg_kw or {}))
    if full is None:
        full = init_transformer_params(cfg, 0, device="cpu")
    model = _build(TRANSFORMER, cfg, full, _mesh(axes), min_fsdp_size,
                   device)
    state = TrainState.create(model, _tx(opt))
    if blocked_chunk is None:
        step = train_t5.make_lm_step(model)
    else:
        step = _lm_step(model, lambda m, t: lm_blocked_loss(
            m, t, chunk=blocked_chunk))
    if toks is None:
        toks = tokens(2, cfg.vocab_size, min(32, cfg.max_len))
    return _train(model, state, step, [(t,) for t in toks])


def train_step_case(axes, device="cpu"):
    """tests/test_runtime.py:263: runtime/train.make_train_step over
    the untied tiny Llama (max_len 32) with lm_loss and adam, three
    steps; on a mesh with JAX's DEFAULT_RULES and the state's
    shardings pinned (each step checks every block stays put)."""
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models.transformer import lm_loss
    from tf_operator_tpu_torch.parallel.mesh import DEFAULT_RULES
    from tf_operator_tpu_torch.parallel.tp import state_sharding
    from tf_operator_tpu_torch.runtime.train import (TrainState,
                                                     make_train_step)

    cfg = llama.tiny(dtype=torch.float32, max_len=32)
    full = bridge.init_params(cfg, 0, device="cpu", train=True)
    mesh = _mesh(axes)
    model = _build(LLAMA, cfg, full, mesh, 2**14, device)
    state = TrainState.create(model, _tx("adam"))
    kw = {}
    if mesh is not None:
        with torch.device("meta"):
            whole = TrainState.create(LLAMA.meta(cfg), _tx("adam"))
        kw = dict(rules=DEFAULT_RULES, mesh=mesh,
                  state_shardings=state_sharding(whole, mesh))
    step = make_train_step(model, loss_fn=lm_loss, has_batch_stats=False,
                           **kw)
    toks = tokens(3, cfg.vocab_size, 32, steps=3)
    return _train(model, state, step, [(t, t) for t in toks])


def ckpt_case(axes, load_dir=None, save_dir=None, device="cpu"):
    """The smoke llama: one step, saved to `save_dir`; then a fresh
    state restored from `load_dir` (a checkpoint of one step, written by
    a job of another layout) takes the second step."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.runtime.train import Checkpointer, TrainState

    cfg = llama.tiny(tie_embeddings=True, dtype=torch.float32,
                     attention_fn=flash_attention)
    full = bridge.init_params(cfg, 0, device="cpu", train=True)
    toks = tokens(1, cfg.vocab_size, 32)
    out = {}
    if save_dir is not None:
        model = _build(LLAMA, cfg, full, _mesh(axes), 0, device)
        state = TrainState.create(model, _tx("adafactor"))
        step = train_llama.make_lm_step(model)
        state, _ = step(state, _rows(toks[0], model))
        Checkpointer(save_dir).save(1, state)
    if load_dir is not None:
        model = _build(LLAMA, cfg, full, _mesh(axes), 0, device)
        state = TrainState.create(model, _tx("adafactor"))
        state = Checkpointer(load_dir).restore(state)
        out["restored_step"] = state.step
        out.update(_train(model, state, train_llama.make_lm_step(model),
                          [(toks[1],)]))
    return out


def check(got: dict, want: dict, adam: bool, tag: str = "") -> dict:
    """Hold a sharded run's readings against one process's: losses and
    gradient norms within 1e-5 relative, the same start, and the
    parameters within rtol 1e-5 + atol 1e-5, or under an Adam-family
    optimizer (`adam`) each leaf's update within 1e-3 relative error
    norm (tests/test_torch_sharded.py says why).  Returns the worst
    errors."""
    worst = {"loss": 0.0, "gnorm": 0.0, "param": 0.0}
    for key, name in (("losses", "loss"), ("gnorms", "gnorm")):
        assert len(got[key]) == len(want[key]), (tag, key)
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            err = abs(a - b) / max(abs(b), 1e-30)
            worst[name] = max(worst[name], err)
            assert err < 1e-5, (tag, name, i, a, b)
    assert set(got["params"]) == set(want["params"]), tag
    for k, p in want["params"].items():
        assert torch.equal(got["start"][k], want["start"][k]), (tag, k)
        if adam:
            step = (p - want["start"][k]).double()
            err = float((got["params"][k] - p).double().norm()) / max(
                float(step.norm()), 1e-30)
            assert err <= 1e-3, (tag, k, err)
        else:
            err = float(((got["params"][k] - p).abs()
                         / (1 + p.abs())).max())
            torch.testing.assert_close(
                got["params"][k], p, rtol=1e-5, atol=1e-5,
                msg=lambda m: f"{tag} {k}: {m}")
        worst["param"] = max(worst["param"], err)
    return worst


def _quiet(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def cli_case(axes, ckpt_dir: str):
    """train_llama --smoke --tp 2 and train_t5 --smoke --tp 2 in a job of
    WORLD_SIZE ranks (the group is already up, so bootstrap uses it), the
    llama run checkpointing each step and then resumed."""
    from tf_operator_tpu_torch import train_llama, train_t5

    os.environ.update(WORLD_SIZE=str(dist.get_world_size()),
                      RANK=str(dist.get_rank()))
    cpu = ["--device", "cpu", "--steps", "2", "--per-host-batch", "2",
           "--seq-len", "16", "--tp", "2"]
    llama_argv = ["--smoke", "--ckpt-dir", f"{ckpt_dir}/llama",
                  "--save-interval", "1"] + cpu
    return {"llama": _quiet(train_llama.main, llama_argv),
            "llama-resume": _quiet(train_llama.main,
                                   llama_argv + ["--steps", "3"]),
            "t5": _quiet(train_t5.main, ["--smoke", "--blocked-ce"] + cpu)}


CASES = {"llama": llama_case, "transformer": transformer_case,
         "train_step": train_step_case, "ckpt": ckpt_case, "cli": cli_case}


def _worker(rank, n, init_file, out_path, jobs):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        for tag, (case, axes, kw) in jobs.items():
            if isinstance(kw, str):   # a file of keyword arguments
                kw = torch.load(kw, weights_only=False)
            out[tag] = CASES[case](axes, **kw)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def start(jobs, tmp_path, n: int = 8):
    """Start `jobs` ({tag: (case, mesh axes, kwargs or a file of them)})
    in one job of n spawned gloo ranks under tmp_path; join() waits."""
    ctx = mp.get_context("spawn")
    out_path = str(tmp_path / "rank0.pt")
    procs = [ctx.Process(target=_worker,
                         args=(r, n, str(tmp_path / "init"), out_path, jobs))
             for r in range(n)]
    for p in procs:
        p.start()
    return procs, out_path, time.monotonic() + DEADLINE_S


def join(started):
    """rank 0's {tag: readings} of a started job."""
    procs, out_path, deadline = started
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
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return torch.load(out_path, weights_only=False)


def one_process(case: str, **kw):
    """`case` as one process on the whole batch, on one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return CASES[case](None, **kw)
    finally:
        torch.set_num_threads(threads)
