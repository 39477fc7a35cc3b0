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


_MESHES = {}


def _mesh(axes):
    """The job's mesh of `axes`, made once a process (each make_mesh
    makes a process group per set of its axes)."""
    from tf_operator_tpu_torch.parallel.mesh import make_mesh

    if axes is None:
        return None
    key = tuple(sorted(axes.items()))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(axes)
    return _MESHES[key]


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


def _gather_ranks(mine):
    """Every rank's `mine`, in rank order (rank 0 keeps the list)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


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


def ep_oracle(n_ep: int, n_experts: int, factor: float, top_k: int = 2,
              activation: str = "swiglu"):
    """A one-process oracle of JAX's expert-parallel dispatch: the global
    token list split into n_ep contiguous blocks of the padded count's
    share (the last ones short, or empty, where it does not divide),
    each block's real rows through dense_reference_moe at
    make_switch_moe's capacity, the aux the blocks' mean weighted by
    their real tokens.  `run.stats` counts the (token, choice) pairs
    routed and dropped."""
    from tf_operator_tpu_torch.parallel.ep import (dense_reference_moe,
                                                   topk_route)

    def run(x, logits, wi, wo, tp=None):
        assert tp is None
        b, s, d = x.shape
        t = b * s
        local = -(-t // n_ep)
        cap = max(1, math.ceil(local * top_k / n_experts * factor))
        xf, lf = x.reshape(t, d), logits.reshape(t, -1)
        ys, aux_sum = [], 0.0
        for i in range(n_ep):
            rows = slice(i * local, min((i + 1) * local, t))
            n = max(0, rows.stop - rows.start)
            if n == 0:
                continue
            y, aux = dense_reference_moe(
                xf[rows][None], lf[rows][None], wi.to(x.dtype),
                wo.to(x.dtype), cap, activation, top_k)
            ys.append(y[0])
            aux_sum = aux_sum + aux * n
            with torch.no_grad():
                dispatch, _, _ = topk_route(lf[rows].float(), cap, top_k)
            run.stats["pairs"] += n * top_k
            run.stats["dropped"] += n * top_k - int(dispatch.sum())
        return torch.cat(ys).reshape(b, s, d), aux_sum / t

    run.top_k = top_k
    run.stats = {"pairs": 0, "dropped": 0}
    return run


def llama_case(axes, full=None, toks=None, moe=False, d_ff=128,
               tied=True, opt="adafactor", min_fsdp_size=0, lora_rank=0,
               ring=False, window=None, ep=None, remat=False,
               ulysses=False, device="cpu"):
    """A tiny f32 Llama under train_llama's step (blocked CE over the
    tied embedding, or the untied lm_loss), from `full` (default the
    seeded draws) on `toks` (default seeded); `moe`: the mixtral smoke
    model; `lora_rank`: LoRA adapters of that rank train alone; `ring`:
    attention through the ring over tp (one process: flash attention,
    the same function); `ulysses`: attention through
    make_ulysses_attention_fn(mesh, "tp", use_flash=True) (one process:
    flash attention, the same function); `window`: mistral's sliding
    window; `remat`: each block recomputed in the backward; `ep` = (ep
    size, capacity factor): the experts dispatched by make_switch_moe
    over the mesh (one process: ep_oracle)."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import bridge, llama, lora
    from tf_operator_tpu_torch.ops.ring_flash import (
        make_ring_flash_attention_fn)
    from tf_operator_tpu_torch.parallel.ep import make_switch_moe
    from tf_operator_tpu_torch.runtime.train import TrainState

    mesh = _mesh(axes)
    extra = dict(train_llama.SMOKE_MOE) if moe else {}
    if ep is not None:
        n_ep, factor = ep
        extra["moe_dispatch_fn"] = (
            ep_oracle(n_ep, extra["n_experts"], factor) if mesh is None
            else make_switch_moe(mesh, extra["n_experts"], factor,
                                 activation="swiglu", top_k=2))
        assert mesh is None or mesh.shape["ep"] == n_ep
    attn = flash_attention if tied else None
    if ring and mesh is not None:
        attn = make_ring_flash_attention_fn(mesh, "tp")
    if ulysses and mesh is not None:
        from tf_operator_tpu_torch.ops.ulysses import (
            make_ulysses_attention_fn)

        attn = make_ulysses_attention_fn(mesh, "tp", use_flash=True)
    cfg = llama.tiny(tie_embeddings=tied, dtype=torch.float32, d_ff=d_ff,
                     attention_fn=attn, sliding_window=window, remat=remat,
                     **extra)
    if full is None:
        full = bridge.init_params(cfg, 0, device="cpu", train=True)
    model = _build(LLAMA, cfg, full, mesh, min_fsdp_size, device)
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
    from tf_operator_tpu_torch.parallel import ep as ep_mod

    ep_mod.reset_stats()
    out = _train(model, state, train_llama.make_lm_step(model),
                 [(t,) for t in toks])
    if ep is not None:
        out["ep_stats"] = (extra["moe_dispatch_fn"].stats if mesh is None
                           else ep_mod.read_stats())
    return out


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


# ring over tp: (mesh axes, heads, kv heads, causal, window)
RING_B, RING_S, RING_D = 2, 64, 16
RING_CASES = {
    "tp2_gqa": ({"tp": 2, "dp": 4}, 4, 2, True, None),
    "tp4_kv2_window": ({"tp": 4, "dp": 2}, 8, 2, True, 20),
    "tp4_kv3_full": ({"tp": 4, "fsdp": 2}, 12, 3, False, None),
    "tp8_kv2_window": ({"tp": 8}, 8, 2, True, 24),
}


def ring_inputs(seed: int, h: int, kv: int):
    """Global q, k, v, dO ([B, S, heads, D] f32 numpy) of a ring case."""
    rng = np.random.default_rng(seed)
    f = lambda n: rng.standard_normal(  # noqa: E731
        (RING_B, RING_S, n, RING_D)).astype(np.float32)
    return f(h), f(kv), f(kv), f(h)


def ring_fn_case(axes, h, kv, causal, window, seed, device="cpu"):
    """make_ring_flash_attention_fn(mesh, "tp") on this rank's heads as a
    tp-placed model hands them over (its query heads, the kv heads they
    read: parallel/tp.kv_heads_of), forward and backward against dO;
    returns every rank's (tp coordinate, kv head ids, out, dq, dk, dv)."""
    from tf_operator_tpu_torch.ops.ring_flash import (
        make_ring_flash_attention_fn)
    from tf_operator_tpu_torch.parallel.tp import kv_heads_of

    mesh = _mesh(axes)
    n, t = mesh.shape["tp"], mesh.coords()["tp"]
    q, k, v, do = ring_inputs(seed, h, kv)
    hl = h // n
    ids = kv_heads_of(h, kv, t, n)
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).to(
        device).requires_grad_()
        for a in (q[:, :, t * hl:(t + 1) * hl], k[:, :, ids], v[:, :, ids])]
    fn = make_ring_flash_attention_fn(mesh, "tp")
    out = fn(*leaves, causal, window=window, n_kv_heads=kv)
    out.backward(torch.from_numpy(np.ascontiguousarray(
        do[:, :, t * hl:(t + 1) * hl])).to(device))
    mine = dict(tp=t, ids=ids, ring_rank=fn.ring.rank,
                peer=fn.ring.peer(1), out=out.detach().cpu(),
                grads=[x.grad.cpu() for x in leaves])
    return _gather_ranks(mine)


# expert dispatch: (mesh axes, batch, seq, experts, capacity factor,
# top_k, activation, replicated: every rank passes the global batch
# outside a step, else each data member its rows inside dp.replicas)
EP_D, EP_F = 16, 32
EP_CASES = {
    "ep2_ragged_top1_drops": ({"ep": 2, "tp": 4}, 3, 7, 8, 1.25, 1,
                              "gelu", False),
    "ep2_ragged_top2_swiglu": ({"ep": 2, "tp": 4}, 3, 7, 8, 8.0, 2,
                               "swiglu", False),
    "ep4_dp2_ragged_top2_drops": ({"ep": 4, "dp": 2}, 2, 7, 8, 1.25, 2,
                                  "swiglu", False),
    "ep4_dp2_top1_drops": ({"ep": 4, "dp": 2}, 4, 16, 8, 1.0, 1, "gelu",
                           False),
    "ep4_dp2_replicated_ragged_top2_drops": ({"ep": 4, "dp": 2}, 3, 7, 8,
                                             1.25, 2, "swiglu", True),
    "ep4_dp2_replicated_top1_drops": ({"ep": 4, "dp": 2}, 4, 16, 8, 1.0, 1,
                                      "gelu", True),
}


def ep_inputs(seed: int, b: int, s: int, n_e: int, act: str):
    """x [b, s, D], router logits [b, s, E], wi [E, D, F'] (2F packed
    for swiglu), wo [E, F, D] and the loss weights R [b, s, D] (f32
    numpy)."""
    rng = np.random.default_rng(seed)
    f_in = 2 * EP_F if act == "swiglu" else EP_F
    n = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa
    return (n(b, s, EP_D), n(b, s, n_e), n(n_e, EP_D, f_in) / EP_D ** 0.5,
            n(n_e, EP_F, EP_D) / EP_F ** 0.5, n(b, s, EP_D))


def ep_fn_case(axes, b, s, n_e, factor, top_k, act, replicated, seed,
               device="cpu"):
    """make_switch_moe over the mesh on this rank's block of experts and
    either the global batch (replicated: outside a step, the loss
    sum(y·R) + 0.01·aux) or its data member's rows inside dp.replicas
    over the data axes (the loss n_data·sum(y·R) + 0.01·aux, so that the
    data members' mean gradient is that of JAX's sum(y·R) + 0.01·aux).
    Returns every rank's (data member, ep coordinate, y, aux, the
    gradients of x and the logits divided by n_data, those of its expert
    blocks, and the dispatch's drop counts)."""
    from tf_operator_tpu_torch.parallel import dp
    from tf_operator_tpu_torch.parallel import ep as ep_mod
    from tf_operator_tpu_torch.parallel.mesh import BATCH_AXES

    mesh = _mesh(axes)
    m, n_data = mesh.axis_index(BATCH_AXES), mesh.axis_size(BATCH_AXES)
    if replicated:
        m, n_data = 0, 1
    e, n_ep = mesh.coords()["ep"], mesh.shape["ep"]
    x, lg, wi, wo, r = ep_inputs(seed, b, s, n_e, act)
    rows = slice(m * b // n_data, (m + 1) * b // n_data)
    blk = slice(e * n_e // n_ep, (e + 1) * n_e // n_ep)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa
        device).requires_grad_()
    leaves = [t(x[rows]), t(lg[rows]), t(wi[blk]), t(wo[blk])]
    fn = ep_mod.make_switch_moe(mesh, n_e, factor, activation=act,
                                top_k=top_k)
    ep_mod.reset_stats()
    with dp.replicas(None if replicated else mesh.group(BATCH_AXES)):
        y, aux = fn(*leaves)
        loss = n_data * (y * torch.from_numpy(r[rows]).to(device)).sum() \
            + 0.01 * aux
        loss.backward()
    g = [p.grad.cpu() for p in leaves]
    mine = dict(member=m, n_data=n_data, ep=e, y=y.detach().cpu(),
                aux=aux.item(), dx=g[0] / n_data, dlogits=g[1] / n_data,
                dwi=g[2], dwo=g[3], stats=ep_mod.read_stats())
    return _gather_ranks(mine)


def ep_aux_case(axes, seed, device="cpu"):
    """test_ep.py:167's inputs as the global batch: the aux loss of 64
    tokens and of the same tokens minus the last (63, padded to 64)."""
    from tf_operator_tpu_torch.parallel import ep as ep_mod

    fn = ep_mod.make_switch_moe(_mesh(axes), 8, 8.0)
    x, lg, wi, wo, _ = (torch.from_numpy(a).to(device)
                        for a in ep_inputs(seed, 4, 16, 8, "gelu"))
    _, even = fn(x, lg, wi, wo)
    _, ragged = fn(x.reshape(1, 64, -1)[:, :63],
                   lg.reshape(1, 64, -1)[:, :63], wi, wo)
    return dict(even=even.item(), ragged=ragged.item())


def ep_refusal_case(axes, device="cpu"):
    """make_switch_moe inside dp.replicas over the job's every rank,
    which is not the mesh's data axes: the refusal's message."""
    from tf_operator_tpu_torch.parallel import dp
    from tf_operator_tpu_torch.parallel import ep as ep_mod

    fn = ep_mod.make_switch_moe(_mesh(axes), 8, 1.25)
    x, lg, wi, wo, _ = (torch.from_numpy(a).to(device)
                        for a in ep_inputs(0, 2, 4, 8, "gelu"))
    try:
        with dp.replicas(dist.group.WORLD):
            fn(x, lg, wi, wo)
    except ValueError as err:
        return str(err)
    return None


def generate_case(axes, full, prompt, cfg_kw, factor, placed=False,
                  device="cpu"):
    """llama.generate of the tiny MoE model with make_switch_moe over the
    mesh as its dispatch function (JAX's test_ep.py:192): prefill through
    the all-to-all, decode steps through the gather path.  Whole
    parameters on every rank, the prompts the global batch; or
    (placed=True) the model sharded over the mesh (its experts over ep,
    gathered for each decode step) with the cache
    parallel/tp.kv_cache_sharding places: its kv heads over tp, and its
    rows over the data axes where they divide them, each data member
    then prefilling its own rows.  Returns the tokens, the prefill's
    hidden states (generate's first model call) and the dispatch's drop
    counts."""
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.parallel import ep as ep_mod
    from tf_operator_tpu_torch.parallel.placement import shard_model
    from tf_operator_tpu_torch.parallel.tp import kv_cache_sharding

    mesh = _mesh(axes)
    fn = ep_mod.make_switch_moe(mesh, cfg_kw["n_experts"], factor,
                                activation="swiglu",
                                top_k=cfg_kw.get("moe_top_k", 1))
    cfg = llama.tiny(dtype=torch.float32, moe_dispatch_fn=fn, **cfg_kw)
    kw = {}
    if placed:
        with torch.device("meta"):
            model = llama.Llama(cfg)
        shard_model(model, mesh, full, device=device, requires_grad=False)
        kw["cache_sharding"] = kv_cache_sharding(cfg, mesh, prompt.shape[0])
    else:
        model = llama.Llama.from_params(cfg, full, device=device)
    ep_mod.reset_stats()
    calls = []
    hook = model.register_forward_hook(
        lambda mod, args, out: calls.append(out.detach().cpu()))
    out = llama.generate(model, torch.from_numpy(prompt).to(device), 6,
                         device=device, **kw)
    hook.remove()
    return dict(tokens=out.cpu(), prefill_hidden=calls[0],
                stats=ep_mod.read_stats())


def transformer_ep_case(axes, full, toks, cfg_kw, factor, device="cpu"):
    """The tiny MoE Transformer's forward (test_ep.py:101) with
    make_switch_moe over the mesh as its dispatch function, every rank
    the whole batch (an eval forward).  Returns the logits and the
    dispatch's drop counts."""
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.models.transformer_bridge import (
        transformer_from_params)
    from tf_operator_tpu_torch.parallel import ep as ep_mod

    mesh = _mesh(axes)
    cfg = tt.tiny(dtype=torch.float32, moe_dispatch_fn=ep_mod.make_switch_moe(
        mesh, cfg_kw["n_experts"], factor), **cfg_kw)
    model = transformer_from_params(cfg, full, device=device)
    ep_mod.reset_stats()
    with torch.no_grad():
        logits = model(torch.from_numpy(toks).to(device), train=False)
    return dict(logits=logits.cpu(), stats=ep_mod.read_stats())


def cli_parallel_case(axes, argv, device="cpu"):
    """train_llama with `argv` as this rank of a job of WORLD_SIZE ranks
    (the group is already up, so bootstrap uses it)."""
    from tf_operator_tpu_torch import train_llama

    os.environ.update(WORLD_SIZE=str(dist.get_world_size()),
                      RANK=str(dist.get_rank()))
    return _quiet(train_llama.main, ["--device", "cpu"] + argv)


CASES = {"llama": llama_case, "transformer": transformer_case,
         "train_step": train_step_case, "ckpt": ckpt_case, "cli": cli_case,
         "ring_fn": ring_fn_case, "ep_fn": ep_fn_case, "ep_aux": ep_aux_case,
         "ep_refusal": ep_refusal_case, "generate": generate_case,
         "transformer_ep": transformer_ep_case,
         "cli_parallel": cli_parallel_case}


def case_fn(case: str):
    """CASES[case], or a case of another JAX-free module named
    "module:function" (tests/torch_pipeline_util.py's)."""
    if ":" in case:
        import importlib

        module, name = case.split(":")
        return getattr(importlib.import_module(module), name)
    return CASES[case]


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
            out[tag] = case_fn(case)(axes, **kw)
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
        return case_fn(case)(kw.pop("axes", None), **kw)
    finally:
        torch.set_num_threads(threads)
