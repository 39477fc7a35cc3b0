"""Cases of the pipelines (parallel/pp, models/pipeline,
models/pipeline_llama), Ulysses attention (ops/ulysses) and checkpoint
resharding (models/reshard) for the tests of the port: each runs either
as one rank of a job of JAX-free gloo processes
(tests/torch_sharded_util.start with the case named
"tests.torch_pipeline_util:<case>") or as one process, and returns what
the tests compare.  Inputs and weights are drawn with numpy from a seed,
so the JAX side of a test draws the same.
"""
import math

import numpy as np
import torch
import torch.distributed as dist

from tests.torch_sharded_util import _gather_ranks, _mesh

# ------------------------------------------------------------- gpipe
PP_D = 16           # tests/test_pp.py's width
PP_STAGES = 4


def pp_stage_fn(params, x):
    """tests/test_pp.py's stage: a tanh MLP block (shape-preserving; a
    bf16 batch promotes to the f32 params' dtype, as jnp does)."""
    return torch.tanh(x.to(params["w"].dtype) @ params["w"] + params["b"])


def pp_params(seed: int, n_stages: int = PP_STAGES):
    """[n_stages] stage trees (numpy f32): w [D, D] / sqrt(D), b [D] / 10."""
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((PP_D, PP_D))
                   / math.sqrt(PP_D)).astype(np.float32),
             "b": (rng.standard_normal(PP_D) * 0.1).astype(np.float32)}
            for _ in range(n_stages)]


def pp_batch(seed: int, batch: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch, PP_D)).astype(np.float32)


def gpipe_case(axes, seed: int, batch: int, n_micro: int,
               batch_axes=None, bf16: bool = False, world: int = 8,
               device="cpu"):
    """make_pipeline_fn(mesh, pp_stage_fn, n_micro) over `axes`: in a job
    each rank its stage (pp.place) and its data member's rows
    (pp.data_rows), in one process every stage on the global batch; the
    loss sum(out²) over the global batch backward.  Returns the outputs
    of the global batch and each stacked leaf's gradient (rank 0's
    readings in a job); `bf16`: the batch in bf16 (the carry promotes
    to the f32 params')."""
    from tf_operator_tpu_torch.parallel import pp
    from tf_operator_tpu_torch.parallel.mesh import make_mesh

    job = dist.is_initialized()
    mesh = _mesh(axes) if job else make_mesh(axes, world=world)
    whole = pp.stack_stage_params([
        {k: torch.from_numpy(v) for k, v in s.items()}
        for s in pp_params(seed, mesh.shape["pp"])])
    specs = {"w": ("pp",), "b": ("pp",)}
    params = pp.place(whole, specs, mesh) if job else whole
    params = {k: v.to(device).requires_grad_() for k, v in params.items()}
    x = torch.from_numpy(pp_batch(seed + 1, batch)).to(device)
    if bf16:
        x = x.bfloat16()
    run = pp.make_pipeline_fn(mesh, pp_stage_fn, n_micro,
                              batch_axes=batch_axes)
    if job and batch_axes is not None:
        x = pp.data_rows(x, mesh, n_micro, batch_axes)
    out = run(params, x)
    (out ** 2).sum().backward()
    if job:
        # the loss of the global batch: the members' sums add
        pp.reduce_gradients_(params, specs, mesh, batch_axes or ())
        n = mesh.axis_size(batch_axes or ())
        for p in params.values():
            p.grad.mul_(n)
    mine = dict(stage=mesh.coords()["pp"] if job else None,
                member=mesh.axis_index(batch_axes or ()) if job else 0,
                out=out.detach().cpu(),
                grads={k: p.grad.cpu() for k, p in params.items()})
    if not job:
        return {"out": mine["out"], "grads": mine["grads"]}
    ranks = _gather_ranks(mine)
    n_members = mesh.axis_size(batch_axes or ())
    outs = [None] * n_members
    grads = {k: [None] * mesh.shape["pp"] for k in specs}
    for r in ranks:
        outs[r["member"]] = r["out"]
        for k, g in r["grads"].items():
            grads[k][r["stage"]] = g[0]
    # the members' rows back in the global batch's order
    w = batch // n_micro // n_members
    out = torch.stack([o.reshape(n_micro, w, -1) for o in outs], 1)
    return {"out": out.reshape(batch, -1),
            "grads": {k: torch.stack(v) for k, v in grads.items()},
            "stages_seen": sorted({r["stage"] for r in ranks})}


# ---------------------------------------------------------- pipelines
PIPE_MESHES = {    # __graft_entry__.py's pipeline meshes at 8 devices
    "pp_tp": {"pp": 2, "tp": 2, "dp": 2},
    "pp_fsdp": {"pp": 2, "fsdp": 2, "dp": 2},
    "pp_ep": {"pp": 2, "ep": 2, "dp": 2},
}


def pipe_cfg(kind: str, pp_size: int, **kw):
    """__graft_entry__.py's pipelined configs (f32, vocab 256, width 64,
    4 heads, 2 layers a stage, max_len 32): "lm" the transformer (with
    `n_experts`: MoE in every block), "llama" the GQA llama (2 kv
    heads)."""
    if kind == "llama":
        from tf_operator_tpu_torch.models.llama import LlamaConfig

        base = dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2,
                    n_layers=2 * pp_size, d_ff=128, max_len=32,
                    dtype=torch.float32, tie_embeddings=True)
        base.update(kw)
        return LlamaConfig(**base)
    from tf_operator_tpu_torch.models.transformer import TransformerConfig

    n_experts = kw.pop("n_experts", 0)
    base = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2 * pp_size,
                d_ff=128, max_len=32, causal=True, dtype=torch.float32,
                tie_embeddings=True, n_experts=n_experts,
                moe_every=1 if n_experts else 2)
    base.update(kw)
    return TransformerConfig(**base)


def _module(kind: str):
    from tf_operator_tpu_torch.models import pipeline, pipeline_llama

    return pipeline_llama if kind == "llama" else pipeline


def _full(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block (every rank calls)."""
    from tf_operator_tpu_torch.parallel import comm
    from tf_operator_tpu_torch.parallel.mesh import AXIS_ORDER, spec_axes

    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            group = mesh.group(tuple(a for a in AXIS_ORDER if a in axes))
            t = comm.all_gather_cat(t.contiguous(), group, d)
    return t


def _grad_norm(params, specs, mesh, job: bool) -> float:
    """The global gradient norm (each element of each whole leaf once)."""
    from tf_operator_tpu_torch.parallel.mesh import spec_mesh_axes

    total = torch.zeros((), dtype=torch.float64)
    for k, p in params.items():
        s = p.grad.double().pow(2).sum().cpu()
        if job:
            held = mesh.axis_size(spec_mesh_axes(specs[k]))
            s = s * held / mesh.size
        total = total + s
    if job:
        dist.all_reduce(total)
    return math.sqrt(float(total))


def pipe_seq_loss(kind, cfg, params, toks, n_micro, n_shards, factor):
    """The sequential witness (models/pipeline.sequential_apply): the LM
    loss of the global batch; with MoE __graft_entry__'s grouping-faithful
    reference (each microbatch's data-member blocks apart, CE and aux the
    blocks' means) and the weighted aux added."""
    from tf_operator_tpu_torch.models.transformer import (MOE_AUX_WEIGHT,
                                                          lm_loss)

    mod = _module(kind)
    if kind == "llama" or not cfg.n_experts:
        return lm_loss(mod.sequential_apply(cfg, params, toks), toks), None
    ces, auxes = [], []
    for chunk in toks.chunk(n_micro):
        for sub in chunk.chunk(n_shards):
            logits, aux = mod.sequential_apply(cfg, params, sub,
                                               capacity_factor=factor)
            ces.append(lm_loss(logits, sub))
            auxes.append(aux)
    ce, aux = sum(ces) / len(ces), sum(auxes) / len(auxes)
    return ce + MOE_AUX_WEIGHT * aux, aux


def pipeline_case(axes, kind: str = "lm", form: str = "pipeline",
                  cfg_kw=None, n_micro: int = 2, steps: int = 2,
                  factor=None, seed: int = 0, batch=None, world: int = 8,
                  full=None, toks=None, device="cpu"):
    """`steps` adam(1e-3) steps of the pipelined `kind` on `axes`
    (__graft_entry__'s witness, from its weights: init_params of a
    seeded CPU generator, or `full`; tokens seeded, or `toks`).  form
    "pipeline": make_pipelined_apply — in a job each rank its blocks
    (pp.place over param_shardings) and its data member's rows, its
    gradients reduced over the data axes; in one process the whole tree
    on the global batch; form "sequential": sequential_apply, the
    witness (pipe_seq_loss).  Returns the losses, aux values, gradient
    norms before each update, and the whole parameters at the start and
    after the steps (rank 0's readings in a job)."""
    from tf_operator_tpu_torch.models.transformer import MOE_AUX_WEIGHT
    from tf_operator_tpu_torch.parallel import pp
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.runtime.optim import Adam

    job = dist.is_initialized()
    mesh = _mesh(axes) if job else make_mesh(axes, world=world)
    mod = _module(kind)
    cfg = pipe_cfg(kind, mesh.shape["pp"], **(cfg_kw or {}))
    moe = kind == "lm" and cfg.n_experts > 0
    if full is None:
        full = mod.init_params(torch.Generator().manual_seed(seed), cfg,
                               mesh.shape["pp"])
    if batch is None:
        batch = n_micro * 2 * mesh.shape["dp"] * mesh.shape["fsdp"] * (
            mesh.shape["ep"] if moe else 1)
    if toks is None:
        toks = np.random.default_rng(seed + 1).integers(
            0, cfg.vocab_size, (batch, cfg.max_len))
    toks = torch.as_tensor(toks, dtype=torch.long)
    specs = mod.param_shardings(full, mesh)
    if form == "pipeline":
        kw = dict(capacity_factor=factor) if moe else {}
        apply = mod.make_pipelined_apply(cfg, mesh, n_micro, **kw)
        if job:
            toks = pp.data_rows(toks, mesh, n_micro, apply.batch_axes)
    tree = pp.place(full, specs, mesh) if job else pp.tree_map(
        lambda t: t.clone(), full)
    tree = pp.tree_map(lambda t: t.to(device).requires_grad_(), tree)
    toks = toks.to(device)
    params, flat_specs = pp.named_leaves(tree), pp.named_leaves(specs)
    tx = Adam(1e-3)
    opt = tx.init(params)
    start = {k: (_full(p.detach(), flat_specs[k], mesh) if job
                 else p.detach()).cpu().clone() for k, p in params.items()}
    losses, auxes, gnorms = [], [], []
    n_shards = mesh.axis_size(("dp", "fsdp", "ep") if moe
                              else ("dp", "fsdp"))
    for _ in range(steps):
        if form == "sequential":
            loss, aux = pipe_seq_loss(kind, cfg, tree, toks, n_micro,
                                      n_shards, factor)
        elif moe:
            loss, ce = mod.pipeline_lm_loss_with_aux(apply, tree, toks,
                                                     MOE_AUX_WEIGHT)
            aux = (loss - ce) / MOE_AUX_WEIGHT
        else:
            loss, aux = mod.pipeline_lm_loss(apply, tree, toks), None
        loss.backward()
        if job:
            pp.reduce_gradients_(params, flat_specs, mesh, apply.batch_axes)
            loss = pp.mean_over_data(loss, mesh, apply.batch_axes)
        losses.append(float(loss.detach()))
        auxes.append(None if aux is None else float(aux.detach()))
        gnorms.append(_grad_norm(params, flat_specs, mesh, job))
        opt = tx.update_(params, opt)
    end = {k: (_full(p.detach(), flat_specs[k], mesh) if job
               else p.detach()).cpu().clone() for k, p in params.items()}
    return {"losses": losses, "aux": auxes, "gnorms": gnorms,
            "start": start, "params": end}


# ------------------------------------------------------------ ulysses
UL_B, UL_D = 2, 16
UL_CASES = {   # (mesh axes, seq, heads, kv heads, causal, window, flash)
    "sp2_gqa_flash_window": ({"tp": 2, "dp": 4}, 64, 4, 2, True, 10, True),
    "sp2_full": ({"tp": 2, "dp": 4}, 64, 4, 4, False, None, False),
    "sp4_broadcast_kv": ({"tp": 4, "dp": 2}, 64, 4, 2, True, None, False),
    "sp4_window": ({"tp": 4, "dp": 2}, 64, 4, 4, True, 10, True),
}


def ul_inputs(seed: int, s: int, h: int, kv: int):
    """q [B, S, H, D], k and v [B, S, KV, D] and dO (f32 numpy); B is two
    rows a data member of the largest mesh."""
    rng = np.random.default_rng(seed)
    f = lambda n: rng.standard_normal(  # noqa: E731
        (UL_B * 4, s, n, UL_D)).astype(np.float32)
    return f(h), f(kv), f(kv), f(h)


def ulysses_fn_case(axes, s, h, kv, causal, window, flash, seed,
                    device="cpu"):
    """ops/ulysses.ulysses_attention over the mesh's tp ranks: each rank
    its data member's rows and its tp coordinate's sequence block,
    forward and backward against dO; returns the global output and the
    gradients of q, k and v (rank 0), or one process's over the whole
    sequence (the einsum reference, kv broadcast)."""
    from tf_operator_tpu_torch.models.transformer import (
        dot_product_attention)
    from tf_operator_tpu_torch.ops.ulysses import ulysses_attention

    q, k, v, do = ul_inputs(seed, s, h, kv)
    if not dist.is_initialized():
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        g = h // kv
        out = dot_product_attention(
            leaves[0], leaves[1].repeat_interleave(g, dim=2),
            leaves[2].repeat_interleave(g, dim=2), causal, window=window)
        out.backward(torch.from_numpy(do))
        return {"out": out.detach(), "grads": [x.grad for x in leaves]}
    mesh = _mesh(axes)
    n, t = mesh.shape["tp"], mesh.coords()["tp"]
    i, m = mesh.axis_index(("dp",)), mesh.shape["dp"]
    rows, sl = q.shape[0] // m, s // n
    cut = lambda a: np.ascontiguousarray(  # noqa: E731
        a[i * rows:(i + 1) * rows, t * sl:(t + 1) * sl])
    leaves = [torch.from_numpy(cut(a)).to(device).requires_grad_()
              for a in (q, k, v)]
    out = ulysses_attention(*leaves, causal, group=mesh.group("tp"),
                            use_flash=flash, window=window)
    out.backward(torch.from_numpy(cut(do)).to(device))
    mine = dict(i=i, t=t, out=out.detach().cpu(),
                grads=[x.grad.cpu() for x in leaves])
    ranks = _gather_ranks(mine)

    def whole(get):
        return torch.cat([torch.cat([get(r) for r in sorted(
            (r for r in ranks if r["i"] == ii), key=lambda r: r["t"])], 1)
            for ii in range(m)], 0)

    return {"out": whole(lambda r: r["out"]),
            "grads": [whole(lambda r, j=j: r["grads"][j])
                      for j in range(3)]}


# ------------------------------------------------------------ reshard
D_IN, D_HID, D_OUT = 256, 128, 8   # w1 is 256 x 128 = 32768 > min_size
RS_BATCH = 8


class Mlp(torch.nn.Module):
    """tests/test_zreshard.py's two-layer MLP: w1/w2 cross the fsdp
    min_size, b1/b2 replicate."""

    def __init__(self) -> None:
        super().__init__()
        for name, shape in (("w1", (D_IN, D_HID)), ("b1", (D_HID,)),
                            ("w2", (D_HID, D_OUT * 32)),
                            ("b2", (D_OUT * 32,))):
            setattr(self, name, torch.nn.Parameter(torch.zeros(shape)))

    def forward(self, x):
        h = torch.relu(x @ self.w1 + self.b1)
        return (h @ self.w2 + self.b2)[:, :D_OUT]


def mlp_init(seed: int = 0):
    """The MLP's weights (numpy f32): w ~ 0.05 · N(0, 1), b = 0."""
    rng = np.random.default_rng(seed)
    return {"w1": (0.05 * rng.standard_normal((D_IN, D_HID))).astype(
                np.float32),
            "b1": np.zeros(D_HID, np.float32),
            "w2": (0.05 * rng.standard_normal((D_HID, D_OUT * 32))).astype(
                np.float32),
            "b2": np.zeros(D_OUT * 32, np.float32)}


def mlp_batches(start: int = 0, n: int = 64):
    """Deterministic per-step (x [8, 256], labels [8]) so two runs
    (resized or not) feed identical data at identical step numbers."""
    for i in range(start, start + n):
        rng = np.random.default_rng(1000 + i)
        yield (rng.standard_normal((RS_BATCH, D_IN)).astype(np.float32),
               rng.integers(0, D_OUT, RS_BATCH).astype(np.int64))


def mlp_setup(mesh, seed: int = 0):
    """(model, state, recording step, losses): the MLP placed on `mesh`
    (a job's) by models/reshard.state_shardings, or whole in one process
    (mesh None), adam(1e-2), runtime/train.make_train_step with the
    state's shardings pinned."""
    from tf_operator_tpu_torch.models.reshard import state_shardings
    from tf_operator_tpu_torch.parallel.placement import place
    from tf_operator_tpu_torch.runtime.optim import Adam
    from tf_operator_tpu_torch.runtime.train import (TrainState,
                                                     make_train_step)

    whole = {k: torch.from_numpy(v) for k, v in mlp_init(seed).items()}
    if mesh is None:
        model = Mlp()
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(whole[k])
        state = TrainState.create(model, Adam(1e-2))
        step = make_train_step(model, has_batch_stats=False)
    else:
        with torch.device("meta"):
            model = Mlp()
        place(model, mesh, state_shardings(whole, mesh), whole,
              device="cpu")
        state = TrainState.create(model, Adam(1e-2))
        step = make_train_step(model, has_batch_stats=False, mesh=mesh,
                               state_shardings=state_shardings(state, mesh))
    losses = []

    def recording(s, x, y):
        s, m = step(s, x, y)
        losses.append(float(m["loss"]))
        return s, m

    return model, state, recording, losses


def _member_rows(batches, mesh):
    """Each (x, y) of `batches` cut to this rank's data member's rows."""
    from tf_operator_tpu_torch.parallel.mesh import BATCH_AXES

    i, n = mesh.axis_index(BATCH_AXES), mesh.axis_size(BATCH_AXES)
    per = RS_BATCH // n
    for x, y in batches:
        yield (torch.from_numpy(x[i * per:(i + 1) * per]),
               torch.from_numpy(y[i * per:(i + 1) * per]))


def reshard_leg_case(axes, start: int = 0, num_steps: int = 6,
                     ckpt_dir=None, save_interval: int = 100,
                     drain_at=None, device="cpu"):
    """runtime/loop.run_training of the MLP on a job's fsdp mesh from
    batch `start` to `num_steps` total steps, checkpointing to
    `ckpt_dir` every `save_interval` (resuming from it where it holds a
    step); `drain_at`: SIGTERM lands between the steps of that batch
    index and the next.  Returns the losses, the loop's result, and the
    state's shardings."""
    from tf_operator_tpu_torch.models.reshard import (host_gather,
                                                      state_shardings)
    from tf_operator_tpu_torch.runtime.loop import (PreemptionGuard,
                                                    run_training)
    from tf_operator_tpu_torch.runtime.train import Checkpointer

    mesh = _mesh(axes)
    _, state, step, losses = mlp_setup(mesh)
    guard = PreemptionGuard(install=False)

    def batches():
        for i, b in enumerate(_member_rows(mlp_batches(start), mesh)):
            if drain_at is not None and i == drain_at:
                guard.trigger()
            yield b

    res = run_training(state, step, batches(), num_steps=num_steps,
                       checkpointer=(Checkpointer(ckpt_dir) if ckpt_dir
                                     else None),
                       save_interval_steps=save_interval, guard=guard)
    specs = state_shardings(res.state, mesh)
    host = host_gather(res.state)
    return {"losses": losses, "host": host.params, "preempted": res.preempted,
            "steps_run": res.steps_run, "resumed_from": res.resumed_from,
            "last_saved_step": res.last_saved_step,
            "step": int(res.state.step), "specs": specs.params,
            "opt_specs": specs.opt_state,
            "blocks": {k: tuple(p.shape)
                       for k, p in res.state.params.items()}}
