"""Tensor-parallel serving cases for tests/test_torch_tp_serving.py: each
case serves a tiny f32 Llama (generate, speculative_generate or
serve_loop), either as every rank of a job of gloo processes over a mesh
(the model placed by parallel/placement.shard_model, its caches by
parallel/tp.kv_cache_sharding), or as one process, and returns what the
tests compare: the tokens, the schedule, the draft counts, the exports,
and the blocks of the KV caches the call made (this rank's, as CPU
tensors).

Every rank writes its own readings, so the tests hold each rank against
every other and against one process.  The job starts with
torch.multiprocessing's spawn and meets through a file under tmp_path;
init_process_group has a 60 s timeout and the join its own deadline, so a
hang fails the test.  This module imports nothing of JAX, so the spawned
processes start quickly.
"""
import contextlib
import dataclasses
import datetime
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE_S = 150
N_RANKS = 8
# {name: (mesh axes, ranks)}: a mesh of fewer ranks than the job runs on
# its first ranks (the others make the same groups and skip the case)
MESHES = {
    "tp2dp4": ({"tp": 2, "dp": 4}, 8),      # tests/test_tp_serving.py
    "dp2fsdp2tp2": ({"dp": 2, "fsdp": 2, "tp": 2}, 8),
    "tp4dp2": ({"tp": 4, "dp": 2}, 8),      # tiny's KV = 2 replicates
    "tp2": ({"tp": 2}, 2),                  # tests/test_zpagedkernel.py
    "dp2tp2": ({"dp": 2, "tp": 2}, 4),
}
SERVE_LENS = (6, 11, 4, 9)                  # test_tp_serving.py:189


def cfg_of(**kw):
    from tf_operator_tpu_torch.models import llama

    kw.setdefault("dtype", torch.float32)
    return llama.tiny(**kw)


def batch(seed: int, b: int, n: int, vocab: int = 256) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(
        np.int64)


def serve_prompts(seed: int = 3, lens=SERVE_LENS, vocab: int = 256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int64) for n in lens]


def build(cfg, seed: int, mesh, int8: bool = False, device="cpu"):
    """The Llama of `cfg` over seeded weights (drawn on the CPU, so both
    sides of a comparison hold the same ones) on `device`: whole in one
    process, or each rank's blocks over `mesh`, drawn leaf by leaf."""
    from tf_operator_tpu_torch.models import bridge
    from tf_operator_tpu_torch.models.llama import Llama
    from tf_operator_tpu_torch.parallel.placement import shard_model

    if mesh is None:
        params = (bridge.init_int8_params(cfg, seed, device="cpu") if int8
                  else bridge.init_params(cfg, seed, device="cpu"))
        return Llama.from_params(cfg, params, device=device)
    with torch.device("meta"):
        model = Llama(cfg)
    pairs = (bridge.iter_int8_params(cfg, seed, device="cpu") if int8
             else bridge.iter_params(cfg, seed, device="cpu"))
    shard_model(model, mesh, pairs, device=device, requires_grad=False)
    return model.eval()


def _host(cache):
    """A cache's leaves as CPU copies ((k, v) a layer; int8 as (q,
    scale))."""
    from tf_operator_tpu_torch.models.quant import QTensor

    def one(t):
        if isinstance(t, QTensor):
            return (t.q.cpu().clone(), t.scale.cpu().clone())
        return t.cpu().clone()

    return [(one(k), one(v)) for k, v in cache]


@contextlib.contextmanager
def caches_made():
    """Every dense ring or block pool made inside, in order of making
    (llama.init_cache and paging.init_block_pool, as serving, generate
    and speculation call them)."""
    from tf_operator_tpu_torch.models import llama, paging

    made = []
    orig = llama.init_cache, paging.init_block_pool

    def init_cache(*a, **kw):
        made.append(("dense", orig[0](*a, **kw)))
        return made[-1][1]

    def init_block_pool(*a, **kw):
        made.append(("pool", orig[1](*a, **kw)))
        return made[-1][1]

    llama.init_cache, paging.init_block_pool = init_cache, init_block_pool
    try:
        yield made
    finally:
        llama.init_cache, paging.init_block_pool = orig


def _results(res):
    return [dict(tokens=list(r.tokens), admitted=r.admitted_at_step,
                 finished=r.finished_at_step, slot=r.slot,
                 acc=(r.accepted_drafts, r.proposed_drafts),
                 kv_blocks=r.kv_blocks) for r in res]


def _stats(stats):
    """The ServeStats counts (the int fields: host clocks, rates and the
    memory peak aside)."""
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(stats)
            if type(getattr(stats, f.name)) is int}


# ------------------------------------------------------------------- cases
GEN = {
    # name: (cfg keywords, batch, prompt len, new tokens, generate kw,
    #        int8 weights)
    "gen": (dict(max_len=64), 4, 12, 8, {}, False),
    "gen_tied": (dict(max_len=64, tie_embeddings=True), 4, 12, 6, {}, False),
    "gen_sample": (dict(max_len=64), 4, 12, 8,
                   dict(temperature=0.8, top_k=20, top_p=0.9), False),
    "gen_int8": (dict(max_len=64), 4, 12, 8, dict(int8=True), True),
    "gen_window": (dict(max_len=256, sliding_window=16), 4, 20, 24, {},
                   False),
    "gen_chunked": (dict(max_len=256, sliding_window=16), 4, 50, 8,
                    dict(cache_len=64, prefill_chunk=16), False),
    "gen_kvq": (dict(max_len=64), 4, 12, 8, dict(kv_quant=True), False),
}


def gen_case(mesh, name: str, device="cpu"):
    """llama.generate (test_tp_serving.py:44-122, test_kv_quant.py:144)
    with cache_sharding=kv_cache_sharding(cfg, mesh, B)."""
    from tf_operator_tpu_torch.models import llama, quant
    from tf_operator_tpu_torch.parallel.tp import kv_cache_sharding

    cfg_kw, b, p_len, new, kw, int8 = GEN[name]
    cfg = cfg_of(**cfg_kw)
    model = build(cfg, 0, mesh, int8=int8, device=device)
    kw = dict(kw)
    if kw.pop("int8", False):
        kw["params_transform"] = quant.make_dequantizer(torch.float32)
    if "temperature" in kw:
        kw["generator"] = torch.Generator(device=device).manual_seed(7)
    if mesh is not None:
        kw["cache_sharding"] = kv_cache_sharding(cfg, mesh, b)
    with caches_made() as made:
        toks = llama.generate(model, batch(1, b, p_len), new, device=device,
                              **kw)
    return dict(tokens=toks.tolist(), caches=[_host(made[0][1])],
                wq=tuple(model.blocks[0].attn.wq.shape))


def spec_case(mesh, device="cpu"):
    """speculative_generate with both models placed and no cache
    shardings given (test_tp_serving.py:168): tokens = generate's."""
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.models.speculative import (
        speculative_generate)

    cfg = cfg_of(max_len=128)
    dcfg = cfg_of(max_len=128, n_layers=1, tie_embeddings=True)
    model = build(cfg, 0, mesh, device=device)
    draft = build(dcfg, 2, mesh, device=device)
    prompt = batch(1, 4, 12)
    with caches_made() as made:
        toks, st = speculative_generate(model, draft, prompt, 10, k=3,
                                        return_stats=True, device=device)
    return dict(tokens=toks.tolist(), stats=st,
                generate=llama.generate(model, prompt, 10,
                                        device=device).tolist(),
                caches=[_host(made[0][1]), _host(made[1][1])])


SERVE = {
    # name: (cfg keywords, serve_loop keywords, int8 weights, draft,
    #        shared prefix length)
    "dense_spec": (dict(max_len=128), dict(
        paged=False, slots=4, max_new_tokens=10, spec_k=2,
        steps_per_sync=2), False, True, 0),
    "dense_prefix": (dict(max_len=128), dict(
        paged=False, slots=4, max_new_tokens=10, steps_per_sync=2,
        scheduler="continuous"), False, False, 8),
    "paged": (dict(max_len=128), dict(
        slots=4, max_new_tokens=8, block_size=4), False, False, 0),
    # a pool too small for both lanes: preemptions
    "paged_cont": (dict(max_len=128), dict(
        slots=2, max_new_tokens=[12, 5, 9, 7], block_size=4,
        scheduler="continuous", prefill_chunk=4, pool_blocks=7), False,
        False, 0),
    # the target as its own draft: drafts accepted
    "paged_spec": (dict(max_len=128), dict(
        slots=4, max_new_tokens=10, block_size=4, spec_k=2,
        scheduler="continuous"), False, "self", 0),
    # lanes finishing apart: prompt segments fused into decode blocks
    "int8": (dict(max_len=128), dict(
        slots=2, max_new_tokens=[12, 5, 9, 7], block_size=4, kv_quant=True,
        scheduler="continuous", prefill_chunk=4), True, False, 0),
    # a window of 120 over 128-slot rings: the long lanes wrap, and the
    # rotation swaps (and copies) the shared prefix's slots
    "window": (dict(max_len=256, sliding_window=120), dict(
        slots=3, max_new_tokens=[80, 40, 90], block_size=4,
        prefill_chunk=8, steps_per_sync=4), False, False, 16),
    "window_cont": (dict(max_len=256, sliding_window=120), dict(
        slots=3, max_new_tokens=[80, 40, 90], block_size=4,
        prefill_chunk=8, steps_per_sync=4, scheduler="continuous"),
        False, False, 16),
    "mixtral": (dict(max_len=128, n_experts=4, moe_every=1, moe_top_k=2),
                dict(slots=2, max_new_tokens=8, block_size=4), False,
                False, 0),
}
SERVE_PROMPTS = {"window": (40, 20, 64), "window_cont": (40, 20, 64)}


def serve_case(mesh, name: str, device="cpu"):
    """serve_loop with cache_sharding (and draft_cache_sharding) =
    kv_cache_sharding(cfg, mesh, slots) of each model."""
    from tf_operator_tpu_torch.models import quant
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.parallel.tp import kv_cache_sharding

    cfg_kw, kw, int8, with_draft, n_fix = SERVE[name]
    cfg = cfg_of(**cfg_kw)
    model = build(cfg, 0, mesh, int8=int8, device=device)
    kw = dict(kw)
    if int8:
        kw["params_transform"] = quant.make_dequantizer(torch.float32)
    slots = kw["slots"]
    if with_draft:
        self_draft = with_draft == "self"
        dcfg = cfg if self_draft else dataclasses.replace(cfg, n_layers=1)
        kw["draft"] = build(dcfg, 0 if self_draft else 7, mesh,
                            device=device)
    if mesh is not None:
        kw["cache_sharding"] = kv_cache_sharding(cfg, mesh, slots)
        if with_draft:
            kw["draft_cache_sharding"] = kv_cache_sharding(dcfg, mesh, slots)
    if n_fix:
        kw["shared_prefix"] = serve_prompts(11, (n_fix,))[0]
    prompts = serve_prompts(3, SERVE_PROMPTS.get(name, SERVE_LENS))
    with caches_made() as made:
        res, stats = serve_loop(model, prompts, return_stats=True,
                                device=device, **kw)
    n = 2 if with_draft else 1
    return dict(results=_results(res), stats=_stats(stats),
                caches=[_host(c) for _, c in made[:n]],
                kinds=[k for k, _ in made[:n]])


def fixpoint_case(mesh, device="cpu"):
    """test_zpagedkernel.py:222: one decode block over a pool placed by
    the tp pool sharding leaves each rank's pool its own block (the
    tests compare it with one process's)."""
    from tf_operator_tpu_torch.models import paging
    from tf_operator_tpu_torch.models.serving import (
        _pool_sharding, decode_block)
    from tf_operator_tpu_torch.parallel.tp import kv_cache_sharding

    cfg = cfg_of(max_len=128)
    model = build(cfg, 0, mesh, device=device)
    sh = (None if mesh is None
          else _pool_sharding(kv_cache_sharding(cfg, mesh, 2)))
    pool = paging.init_block_pool(cfg, 12, 4, device=device, sharding=sh)
    table = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0]], dtype=torch.int32,
                         device=device)
    with torch.inference_mode():
        tok, pos, toks = decode_block(
            model, pool, torch.zeros(2, dtype=torch.long, device=device),
            torch.tensor([9, 5], dtype=torch.int32, device=device),
            torch.zeros(2, dtype=torch.bool, device=device), table, 2,
            lambda lg: torch.argmax(lg, dim=-1))
    return dict(tokens=toks.tolist(), pos=pos.tolist(),
                caches=[_host(pool)])


def tp4_case(mesh, device="cpu"):
    """tiny (H=4, KV=2) at tp 4: the kv heads replicate in JAX's spec,
    and each rank's cache holds the one kv head its query head reads."""
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.parallel.tp import kv_cache_sharding

    cfg = cfg_of(max_len=128)
    model = build(cfg, 0, mesh, device=device)
    sh = None if mesh is None else kv_cache_sharding(cfg, mesh, 4)
    with caches_made() as made:
        res = serve_loop(model, serve_prompts(), slots=4, max_new_tokens=8,
                         block_size=4, cache_sharding=sh, device=device)
        gen = llama.generate(model, batch(1, 4, 12), 8, cache_sharding=sh,
                             device=device)
    return dict(results=_results(res), tokens=gen.tolist(),
                caches=[_host(made[0][1]), _host(made[1][1])],
                kinds=[made[0][0], made[1][0]])


def handoff_case(mesh, adopt_path=None, kv_quant=False, device="cpu"):
    """The prefill/decode handoff under tp: prefill_only over a shared
    prefix (its exports), and, given the path of another side's
    handoffs, adopting them under both schedulers."""
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.parallel.tp import kv_cache_sharding

    cfg = cfg_of(max_len=128)
    model = build(cfg, 0, mesh, device=device)
    prefix = serve_prompts(11, (8,))[0]
    sufs = serve_prompts(3)
    kw = dict(slots=4, max_new_tokens=8, block_size=4, prefill_chunk=4,
              kv_quant=kv_quant, device=device)
    if mesh is not None:
        kw["cache_sharding"] = kv_cache_sharding(cfg, mesh, 4)
    hand = serve_loop(model, sufs, shared_prefix=prefix, prefill_only=True,
                      **kw)
    out = dict(handoffs=[_own_storage(h) for h in hand])
    if adopt_path is not None:
        other = torch.load(adopt_path, weights_only=False)
        full = [np.concatenate([prefix, s]) for s in sufs]
        for sched in ("slot", "continuous"):
            res = serve_loop(model, full, adopt=other, scheduler=sched,
                             **kw)
            out[sched] = _results(res)
    return out


def _own_storage(hand):
    """A handoff whose payload tensors own their storage (an export's are
    typed views of one packed buffer, which torch.save refuses)."""
    from tf_operator_tpu_torch.models import paging
    from tf_operator_tpu_torch.models.quant import QTensor

    exp = hand.export
    if exp is None:
        return hand

    def one(t):
        return (QTensor(t.q.clone(), t.scale.clone())
                if isinstance(t, QTensor) else t.clone())

    payload = {h: [(one(k), one(v)) for k, v in row]
               for h, row in exp.payload.items()}
    return dataclasses.replace(hand, export=paging.BlockExport(
        exp.block_size, exp.hashes, exp.shared, payload, exp.window))


CASES = {"gen": gen_case, "spec": spec_case, "serve": serve_case,
         "fixpoint": fixpoint_case, "tp4": tp4_case,
         "handoff": handoff_case}


def _meshes(rank: int):
    """Every mesh of MESHES, built in one order on every rank."""
    from tf_operator_tpu_torch.parallel.mesh import Mesh, mesh_shape

    return {name: Mesh(mesh_shape(axes, n), rank=rank, groups=True)
            for name, (axes, n) in MESHES.items()}


def job_body(rank: int, jobs, device="cpu") -> dict:
    """This rank's readings of `jobs` ({tag: (case, mesh name, kwargs)})
    inside an initialized job of N_RANKS processes."""
    meshes = _meshes(rank)
    out = {}
    for tag, (case, mesh_name, kw) in jobs.items():
        if rank >= MESHES[mesh_name][1]:
            continue  # the mesh runs on the job's first ranks
        t0 = time.perf_counter()
        out[tag] = CASES[case](meshes[mesh_name], device=device, **kw)
        out[tag]["seconds"] = time.perf_counter() - t0
    return out


def _worker(rank, n, init_file, out_dir, jobs):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=60))
    try:
        torch.save(job_body(rank, jobs), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def start(jobs, tmp_path, n: int = N_RANKS):
    """Start `jobs` ({tag: (case, mesh name, kwargs)}) in one job of n
    spawned gloo ranks under tmp_path; join() waits."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, n, str(tmp_path / "init"), str(tmp_path),
                               jobs))
             for r in range(n)]
    for p in procs:
        p.start()
    return procs, tmp_path, time.monotonic() + DEADLINE_S


def join(started):
    """[rank r's {tag: readings}] of a started job."""
    procs, tmp_path, deadline = started
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
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def one_process(case: str, device="cpu", **kw):
    """`case` as one process (on one torch thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return CASES[case](None, device=device, **kw)
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------- the job and its checks
# tag -> (case, mesh name, keyword arguments): the port's counterparts of
# tests/test_tp_serving.py:44-189, test_zpagedkernel.py:207-222 and
# test_kv_quant.py:144, and its own cases
JOBS = {
    **{name: ("gen", "tp2dp4", dict(name=name)) for name in GEN},
    "spec": ("spec", "tp2dp4", {}),
    "dense_spec": ("serve", "dp2fsdp2tp2", dict(name="dense_spec")),
    "dense_prefix": ("serve", "dp2fsdp2tp2", dict(name="dense_prefix")),
    "paged_tp2": ("serve", "tp2", dict(name="paged")),
    "paged_dp2tp2": ("serve", "dp2tp2", dict(name="paged")),
    "paged_cont": ("serve", "tp2dp4", dict(name="paged_cont")),
    "paged_spec": ("serve", "tp2dp4", dict(name="paged_spec")),
    "int8": ("serve", "tp2dp4", dict(name="int8")),
    "window": ("serve", "tp2dp4", dict(name="window")),
    "window_cont": ("serve", "tp2dp4", dict(name="window_cont")),
    "mixtral": ("serve", "tp2dp4", dict(name="mixtral")),
    "fixpoint": ("fixpoint", "tp2", {}),
    "tp4": ("tp4", "tp4dp2", {}),
}
# the handoff both ways on a tp 2 job: tag -> int8 KV
HANDOFF = {"handoff": False, "handoff_kvq": True}


def run(tmp_path, device="cpu", start_job=start, join_job=join):
    """The job's readings (one dict a rank) and one process's of the same
    cases (made while the job runs), the handoffs crossing both ways:
    the job adopts one process's exports, and one process adopts the
    job's."""
    one_hand = {}
    jobs = dict(JOBS)
    for tag, kvq in HANDOFF.items():
        one_hand[tag] = one_process("handoff", kv_quant=kvq,
                                    device=device)["handoffs"]
        torch.save(one_hand[tag], tmp_path / f"{tag}_one.pt")
        jobs[tag] = ("handoff", "tp2", dict(
            adopt_path=str(tmp_path / f"{tag}_one.pt"), kv_quant=kvq))
    job = start_job(jobs, tmp_path)
    one = {tag: one_process(case, device=device, **kw)
           for tag, (case, _, kw) in JOBS.items()}
    ranks = join_job(job)
    for tag, kvq in HANDOFF.items():
        torch.save(ranks[0][tag]["handoffs"], tmp_path / f"{tag}_tp.pt")
        one[tag] = one_process("handoff", kv_quant=kvq, device=device,
                               adopt_path=str(tmp_path / f"{tag}_tp.pt"))
        one[tag]["own"] = one_process(
            "handoff", kv_quant=kvq, device=device,
            adopt_path=str(tmp_path / f"{tag}_one.pt"))
        one[tag]["handoffs"] = one_hand[tag]
    return ranks, one


def ranks_of(tag):
    return range(MESHES[JOBS[tag][1] if tag in JOBS else "tp2"][1])


def _outputs(r):
    """What a case's ranks must agree on exactly (no caches, clocks or
    weight shapes)."""
    return {k: v for k, v in r.items()
            if k not in ("caches", "seconds", "wq")}


def check_outputs(tag, ranks, one) -> None:
    """Every rank's tokens, schedule and counts = one process's."""
    want = _outputs(one[tag])
    for r in ranks_of(tag):
        assert _outputs(ranks[r][tag]) == want, (tag, r)


def _cache_layout(tag, reading):
    """[(cfg, batch, kind)] of the caches a case's readings hold."""
    case, _, kw = JOBS[tag]
    if case == "gen":
        cfg_kw, b = GEN[kw["name"]][:2]
        return [(cfg_of(**cfg_kw), b, "dense")]
    if case == "spec":
        return [(cfg_of(max_len=128), 4, "dense"),
                (cfg_of(max_len=128, n_layers=1, tie_embeddings=True), 4,
                 "dense")]
    if case == "fixpoint":
        return [(cfg_of(max_len=128), 2, "pool")]
    if case == "tp4":
        return [(cfg_of(max_len=128), 4, k) for k in reading["kinds"]]
    cfg_kw, skw, _, with_draft, _ = SERVE[kw["name"]]
    cfg = cfg_of(**cfg_kw)
    dcfg = cfg if with_draft == "self" else cfg_of(**dict(cfg_kw,
                                                          n_layers=1))
    cfgs = [cfg] + ([dcfg] if with_draft else [])
    return [(c, skw["slots"], k) for c, k in zip(cfgs, reading["kinds"])]


def _expected_block(whole, spec, mesh, rank, heads):
    """`rank`'s block of a whole cache leaf: its kv heads, then its rows
    (or blocks) by the spec."""
    from tf_operator_tpu_torch.parallel.mesh import shard_of

    if heads is not None:
        whole = whole.index_select(2, torch.tensor(heads))
    return shard_of(whole, tuple(spec[:2]), mesh, rank)


def close(got, want, tag) -> None:
    """f32 within 1e-5 (the tp sums run in another order); int8 (q,
    scale) pairs within one quantization step."""
    if isinstance(want, tuple):
        (gq, gs), (wq, ws) = got, want
        torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-6)
        step = float(ws.max())
        diff = (gq.float() * gs - wq.float() * ws).abs().max()
        assert float(diff) <= 1.01 * step + 1e-6, tag
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{tag}: {m}")


def _live(t, kind):
    """A pool's blocks past the scratch block: several frozen lanes
    write block 0 at once, which of them lands is unspecified (the card
    differs from the CPU), and no read sees it."""
    if isinstance(t, tuple):
        return tuple(_live(x, kind) for x in t)
    return t[1:] if kind == "pool" else t


def check_caches(tag, ranks, one) -> None:
    """Each rank's cache (lanes, rings or pool) at the end is its block
    of one process's: its rows where the batch splits over the data
    axes (a pool: every block but the scratch one), and its kv
    heads."""
    from tf_operator_tpu_torch.models.serving import (
        _pool_sharding, _row_sharding)
    from tf_operator_tpu_torch.parallel.mesh import Mesh, mesh_shape
    from tf_operator_tpu_torch.parallel.tp import kv_cache_sharding

    axes, n = MESHES[JOBS[tag][1]]
    layout = _cache_layout(tag, one[tag])
    assert len(one[tag]["caches"]) == len(layout)
    for r in ranks_of(tag):
        mesh = Mesh(mesh_shape(axes, n), rank=r)
        for c, (got_c, want_c, (cfg, b, kind)) in enumerate(zip(
                ranks[r][tag]["caches"], one[tag]["caches"], layout)):
            sh = kv_cache_sharding(cfg, mesh, b)
            if kind == "pool":
                sh = _pool_sharding(sh)
            elif JOBS[tag][0] == "spec":   # given none: the batch whole
                sh = _row_sharding(sh)
            heads = sh.kv_heads()
            for (gk, gv), (wk, wv) in zip(got_c, want_c):
                for g, w in ((gk, wk), (gv, wv)):
                    if isinstance(w, tuple):
                        w = tuple(_expected_block(t, sh.spec, mesh, r, heads)
                                  for t in w)
                        assert g[0].shape == w[0].shape, (tag, r, c)
                    else:
                        w = _expected_block(w, sh.spec, mesh, r, heads)
                        assert g.shape == w.shape, (tag, r, c)
                    close(_live(g, kind), _live(w, kind), (tag, r, c))


def _rows(row):
    """A payload row's leaves in the wire order (k then v a layer; int8
    as (q, scale))."""
    from tf_operator_tpu_torch.models.quant import QTensor

    return [x for kv in row for t in kv
            for x in ((t.q, t.scale) if isinstance(t, QTensor) else (t,))]


def check_exports(tag, ranks, one) -> None:
    """A tp 2 prefill_only job's handoffs: both ranks' are the same bit
    for bit (first tokens, hashes, shared flags, every payload byte),
    each hash is the blake2b of its own block's whole bytes (the kv heads
    gathered over tp), and each block is one process's block, its kv
    heads in order (within `close`: the tp sums run in another order, so
    past the first layer the bytes, and with them the hashes, are not
    one process's).  First tokens, shared flags and block counts are one
    process's exactly."""
    from tf_operator_tpu_torch.models import paging
    from tf_operator_tpu_torch.models.quant import QTensor

    want = one[tag]["handoffs"]
    got0 = ranks[0][tag]["handoffs"]
    for r in ranks_of(tag):
        got = ranks[r][tag]["handoffs"]
        assert len(got) == len(want)
        for g, g0, w in zip(got, got0, want):
            assert (g.first_token, g.completed, g.prompt_len) == (
                w.first_token, w.completed, w.prompt_len), (tag, r)
            assert g.export.shared == w.export.shared
            assert len(g.export.hashes) == len(w.export.hashes)
            assert g.export.hashes == g0.export.hashes, (tag, r)
            assert sorted(g.export.payload) == sorted(g0.export.payload)
            for h, row in g.export.payload.items():
                leaves = _rows(row)
                assert all(torch.equal(a, b) for a, b in zip(
                    leaves, _rows(g0.export.payload[h]))), (tag, r, h)
                assert paging._hash_block(
                    [x.contiguous().view(-1).view(torch.uint8)
                     for x in leaves]) == h
        # a shared prefix's payload rides the first export that ships it
        g_all = {h: row for x in got for h, row in x.export.payload.items()}
        w_all = {h: row for x in want for h, row in x.export.payload.items()}
        for g, w in zip(got, want):
            for gh, wh in zip(g.export.hashes, w.export.hashes):
                gl, wl = _rows(g_all[gh]), _rows(w_all[wh])
                if isinstance(w_all[wh][0][0], QTensor):
                    for i in range(0, len(gl), 2):
                        close((gl[i], gl[i + 1]), (wl[i], wl[i + 1]), tag)
                else:
                    for a, b in zip(gl, wl):
                        close(a, b, tag)


def check_adoption(tag, ranks, one) -> None:
    """One process adopts the tp job's exports, and the tp job adopts
    one process's: both, under either scheduler, give the tokens and
    schedule one process gives adopting its own."""
    for sched in ("slot", "continuous"):
        want = one[tag]["own"][sched]
        assert one[tag][sched] == want, sched
        for r in ranks_of(tag):
            assert ranks[r][tag][sched] == want, (sched, r)


def check_reach(one) -> None:
    """The schedules exercise what the cases are named for."""
    st = {tag: one[tag]["stats"] for tag in JOBS if "stats" in one[tag]}
    assert st["paged_cont"]["preemptions"] > 0
    assert st["int8"]["fused_prefill_tokens"] > 0
    assert st["paged_spec"]["accepted_drafts"] > 0
    for tag in ("window", "window_cont"):
        assert st[tag]["window_evicted_blocks"] > 0
        assert st[tag]["prefix_block_hits"] > 0
    assert st["dense_spec"]["proposed_drafts"] > 0
    assert one["spec"]["tokens"] == one["spec"]["generate"]
    assert one["spec"]["stats"]["accepted_drafts"] > 0
