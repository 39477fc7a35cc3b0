"""The port's paged speculative serving (tf_operator_tpu_torch.models.
speculative and serve_loop(draft=, spec_k=, draft_transform=)) against
the JAX package's serve_loop(paged=True, draft=...) through its gather
oracle, on the CPU at tiny f32 widths: a 2-layer target and a 1-layer
draft of their own seeded weights, both bridged.

Greedy: the tokens, the schedule and each request's accepted and
proposed drafts equal JAX's under both schedulers, with EOS inside a
round, over a copy-on-write prefix and with int8 weights, KV and draft
all at once; the four draft fields of ServeStats (and the rest of the
telemetry) equal JAX's; speculative tokens equal target-only serving.
Sampling cannot match jax.random, so the residual distribution is held
against JAX's before its draw, and sampled runs are checked for seed
determinism and the top-k support.  The refusals carry JAX's messages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_telemetry import assert_same_telemetry, run_pair
from tests.torch_serving_util import int8_models, port_model, prompts
from tests.torch_serving_util import one_torch_thread, tiny_models
from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu.models import speculative as jspec
from tf_operator_tpu.models.serving import serve_loop as jax_serve
from tf_operator_tpu_torch.models import quant as tq
from tf_operator_tpu_torch.models import speculative as tspec
from tf_operator_tpu_torch.models.serving import serve_loop



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tiny tensors run on one torch thread (the JAX side
    keeps its own pool)."""
    with one_torch_thread():
        yield

@pytest.fixture(scope="module")
def models():
    """(JAX target, its params, port target, JAX draft, draft params,
    port draft): the draft is the target's config at one layer, seed 9
    (test_zcontbatch.py's _draft_setup)."""
    jmodel, params, tmodel = tiny_models(max_len=256)
    jdraft = jl.Llama(jl.tiny(dtype=jnp.float32, max_len=256, n_layers=1))
    dparams = jdraft.init(jax.random.PRNGKey(9), jnp.zeros((1, 8), jnp.int32),
                          train=False)["params"]
    return (jmodel, params, tmodel, jdraft, dparams,
            port_model(dparams, max_len=256, n_layers=1))


def _pair(models, reqs, **kw):
    jmodel, params, tmodel, jdraft, dparams, tdraft = models
    return run_pair((jmodel, params, tmodel), reqs,
                    jax_kw=dict(draft=jdraft, draft_params=dparams),
                    port_kw=dict(draft=tdraft), **kw)


def _schedule(res):
    return [(r.tokens, r.admitted_at_step, r.finished_at_step, r.slot,
             r.accepted_drafts, r.proposed_drafts, r.kv_blocks)
            for r in res]


SPEC_KW = dict(slots=2, max_new_tokens=8, spec_k=2, steps_per_sync=3,
               block_size=8)
SPEC_PROMPTS = prompts([6, 9, 5, 7], 7)


@pytest.fixture(scope="module")
def early(models):
    """The target's own first layer as the draft (bench.py's early-exit
    draft): it agrees with the target often, so rounds accept some
    drafts and reject others."""
    jmodel, params, tmodel, jdraft = models[:4]
    dparams = {k: v for k, v in params.items() if k != "block1"}
    return (jmodel, params, tmodel, jdraft, dparams,
            port_model(dparams, max_len=256, n_layers=1))


@pytest.fixture(scope="module")
def sched_runs(models, early):
    """test_zcontbatch.py:146's setup through both loops, per scheduler
    and draft (one JAX reference run each): its seeded 1-layer draft,
    which the target rejects, and the early-exit draft."""
    return {(sched, draft): _pair(models if draft == "seeded" else early,
                                  SPEC_PROMPTS, scheduler=sched, **SPEC_KW)
            for sched in ("slot", "continuous")
            for draft in ("seeded", "early_exit")}


@pytest.mark.parametrize("draft", ["seeded", "early_exit"])
@pytest.mark.parametrize("scheduler", ["slot", "continuous"])
def test_schedulers_match_jax(models, sched_runs, scheduler, draft):
    (jres, jst, jseen), (tres, tst, tseen) = sched_runs[scheduler, draft]
    assert _schedule(tres) == _schedule(jres)
    assert_same_telemetry((jres, jst, jseen), (tres, tst, tseen))
    assert tst.speculative and tst.proposed_drafts > 0
    assert sum(r.proposed_drafts for r in tres) == tst.proposed_drafts
    if draft == "early_exit":
        assert 0 < tst.accepted_drafts < tst.proposed_drafts
    # greedy speculation gives target-only tokens
    tmodel = models[2]
    plain = serve_loop(tmodel, SPEC_PROMPTS, device="cpu",
                       **{k: v for k, v in SPEC_KW.items() if k != "spec_k"})
    assert [r.tokens for r in tres] == [r.tokens for r in plain]


@pytest.mark.parametrize("draft", ["seeded", "early_exit"])
def test_continuous_equals_slot(sched_runs, draft):
    slot = sched_runs["slot", draft][1][0]
    cont = sched_runs["continuous", draft][1][0]
    assert [r.tokens for r in cont] == [r.tokens for r in slot]


def test_eos_inside_a_round_matches_jax(early, sched_runs):
    """An eos_id the run emits at a round's interior: the lane stops
    there, its accepted/proposed count only its own rounds, and the
    schedule equals JAX's."""
    tres = sched_runs["slot", "early_exit"][1][0]
    # request 1's third token: spec_k=2 rounds emit up to 3 tokens, so
    # a mid-stream token is some round's interior or its end
    eos = tres[1].tokens[2]
    (jres, jst, jseen), (res, st, seen) = _pair(
        early, SPEC_PROMPTS, eos_id=eos, **SPEC_KW)
    assert _schedule(res) == _schedule(jres)
    assert_same_telemetry((jres, jst, jseen), (res, st, seen))
    assert res[1].tokens == tres[1].tokens[:3]
    assert st.wasted_lane_steps > 0


def test_cow_prefix_matches_jax(early):
    """test_paging.py:136's unaligned 10-token prefix over blocks of 4:
    the boundary block is copied in both pools at every admission and
    the draft writes the prefix once."""
    pfx = prompts([10], 3)[0]
    (jres, jst, jseen), (res, st, seen) = _pair(
        early, prompts([5, 9, 3, 7, 6], 4), slots=2,
        max_new_tokens=8, block_size=4, shared_prefix=pfx, spec_k=3,
        steps_per_sync=2)
    assert _schedule(res) == _schedule(jres)
    assert_same_telemetry((jres, jst, jseen), (res, st, seen))
    assert st.cow_copies == 5 and st.prefix_block_hits == 10
    assert st.accepted_drafts > 0


def test_full_stack_int8_matches_jax(models):
    """test_paging.py:205's composition: prefix sharing, streamed
    chunks one per turn, int8 weights and KV, and an int8 draft through
    draft_transform (the early-exit draft of the int8 target) — tokens,
    schedule and drafts equal JAX's."""
    jmodel, params, tmodel, jdraft = models[:4]
    qp, tq_model, jkw = int8_models(params, max_len=256)
    qd = {k: v for k, v in qp.items() if k != "block1"}
    tq_draft = port_model(qd, max_len=256, n_layers=1)
    deq = tq.make_dequantizer(torch.float32)
    pfx = prompts([8], 5)[0]
    kw = dict(slots=2, max_new_tokens=8, shared_prefix=pfx,
              prefill_chunk=8, prefill_chunks_per_sync=1, kv_quant=True,
              spec_k=2, steps_per_sync=2, block_size=4)
    (jres, jst, jseen), (res, st, seen) = run_pair(
        (jmodel, qp, tq_model), prompts([6, 9, 4], 6),
        jax_kw=dict(jkw, draft=jdraft, draft_params=qd,
                    draft_transform=jq.make_dequantizer(jnp.float32)),
        port_kw=dict(draft=tq_draft, params_transform=deq,
                     draft_transform=deq), **kw)
    assert _schedule(res) == _schedule(jres)
    assert_same_telemetry((jres, jst, jseen), (res, st, seen))
    assert st.accepted_drafts > 0


@pytest.mark.parametrize("scheduler", ["slot", "continuous"])
def test_draft_fields_of_serve_stats_match_jax(sched_runs, scheduler):
    """test_serving_telemetry.py:88's checks on the early-exit runs
    (drafts accepted and rejected): the four draft fields equal JAX's,
    and sum the per-request counts."""
    (jres, jst, _), (res, st, _) = sched_runs[scheduler, "early_exit"]
    fields = ("speculative", "accepted_drafts", "proposed_drafts",
              "acceptance_rate")
    assert ([getattr(st, f) for f in fields]
            == [getattr(jst, f) for f in fields])
    assert st.speculative and st.proposed_drafts > 0
    assert st.accepted_drafts == sum(r.accepted_drafts for r in res)
    assert st.acceptance_rate == st.accepted_drafts / st.proposed_drafts
    for pr, r in zip(st.per_request, res):
        assert pr["accepted_drafts"] == r.accepted_drafts
        assert pr["proposed_drafts"] == r.proposed_drafts


# --------------------------------------------------------------- sampling
def test_residual_distribution_equals_jax(monkeypatch):
    """residual_probs against the distribution JAX's residual_sample
    draws from (the logits it hands jax.random.categorical), for rows
    with overlap, a residual left only outside the draft's support,
    identical rows (an empty residual: the target itself) and a padded
    all-zero draft row (the bonus draw)."""
    rng = np.random.default_rng(0)
    t = rng.random((6, 32)).astype(np.float32)
    d = rng.random((6, 32)).astype(np.float32)
    t[:, 20:] = 0.0                       # truncated: outside top-k
    d[1] = np.where(t[1] > 0, t[1], 0.0) * 1.5
    d[2] = t[2]                           # empty residual
    d[3] = 0.0                            # the padded bonus row
    t /= t.sum(-1, keepdims=True)
    d[[0, 1, 4, 5]] /= d[[0, 1, 4, 5]].sum(-1, keepdims=True)
    d[2] = t[2]
    seen = {}

    def capture(key, logits, *a, **k):
        seen["logits"] = np.asarray(logits)
        return jnp.zeros(logits.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jspec.residual_sample(jax.random.PRNGKey(0), jnp.asarray(t),
                          jnp.asarray(d))
    want = np.asarray(jax.nn.softmax(seen["logits"], axis=-1))
    got = tspec.residual_probs(torch.from_numpy(t),
                               torch.from_numpy(d)).numpy()
    # JAX floors an empty entry at log(1e-30): weights of 1e-30
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got[2], t[2], rtol=1e-6)
    np.testing.assert_allclose(got[3], t[3], rtol=1e-6)
    assert (got[:, 20:] == 0).all()
    g = torch.Generator().manual_seed(0)
    draws = tspec.residual_sample(g, torch.from_numpy(t).repeat(50, 1),
                                  torch.from_numpy(d).repeat(50, 1))
    assert bool((draws < 20).all())


def test_sampled_speculation_is_seeded_and_inside_top_k(models):
    """Sampled rounds draw from the caller's generator: one seed gives
    one run, another seed another, and every emitted token lies in the
    target's top-k at its position (a draft outside it is rejected, the
    residual has no mass there)."""
    tmodel, tdraft = models[2], models[5]
    reqs = prompts([6, 9, 5], 11)
    kw = dict(slots=2, max_new_tokens=9, temperature=0.8, top_k=20,
              spec_k=3, steps_per_sync=2, block_size=4, device="cpu",
              draft=tdraft)
    runs = [[r.tokens for r in serve_loop(
        tmodel, reqs, generator=torch.Generator().manual_seed(s), **kw)]
        for s in (1, 1, 2)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    with torch.no_grad():
        for p, toks in zip(reqs, runs[0]):
            seq = torch.as_tensor(np.concatenate([p, toks]))[None]
            logits = tmodel(seq.long())[0]
            for i, t in enumerate(toks):
                top = torch.topk(logits[len(p) - 1 + i], 20).indices
                assert t in top.tolist(), (i, t)


# --------------------------------------------------------------- refusals
def _jax_error(models, **kw):
    jmodel, params = models[0], models[1]
    with pytest.raises(ValueError) as ei:
        jax_serve(jmodel, params, [jnp.asarray(p) for p in SPEC_PROMPTS],
                  paged=True, paged_kernel="gather", **kw)
    return str(ei.value)


def _port_error(models, **kw):
    with pytest.raises(ValueError) as ei:
        serve_loop(models[2], SPEC_PROMPTS, device="cpu", **kw)
    return str(ei.value)


@pytest.mark.parametrize("case", [
    "spec_k", "vocab", "prefill_only", "adopt", "max_len", "pool"])
def test_refusals_carry_jax_messages(models, case):
    jdraft, dparams, tdraft = models[3], models[4], models[5]
    jkw = dict(draft=jdraft, draft_params=dparams)
    tkw = dict(draft=tdraft)
    kw = {}
    if case == "spec_k":
        kw = dict(spec_k=0)
    elif case == "vocab":
        jd = jl.Llama(jl.tiny(dtype=jnp.float32, n_layers=1, vocab_size=128))
        jkw = dict(draft=jd, draft_params=jd.init(
            jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
            train=False)["params"])
        from tf_operator_tpu_torch.models import bridge, llama as tl
        tcfg = tl.tiny(dtype=torch.float32, n_layers=1, vocab_size=128)
        tkw = dict(draft=tl.Llama.from_params(
            tcfg, bridge.init_params(tcfg, 1, device="cpu"), device="cpu"))
    elif case == "prefill_only":
        kw = dict(prefill_only=True)
    elif case == "adopt":
        kw = dict(adopt=[])
    elif case == "max_len":
        kw = dict(max_new_tokens=245)
    elif case == "pool":
        kw = dict(block_size=4, pool_blocks=4, max_new_tokens=6)
    assert _port_error(models, **tkw, **kw) == _jax_error(models, **jkw, **kw)


@pytest.mark.parametrize("windowed", ["target", "draft"])
def test_windowed_speculation_is_refused_as_jax(models, windowed):
    jmodel, params, tmodel, jdraft, dparams, tdraft = models
    wkw = dict(sliding_window=16)
    if windowed == "target":
        jmodel, params, tmodel = tiny_models(max_len=256, **wkw)
    else:
        jdraft = jl.Llama(jl.tiny(dtype=jnp.float32, max_len=256,
                                  n_layers=1, **wkw))
        tdraft = port_model(dparams, max_len=256, n_layers=1, **wkw)
    kw = dict(block_size=4, max_new_tokens=4, spec_k=3)
    with pytest.raises(ValueError) as ej:
        jax_serve(jmodel, params, [jnp.asarray(p) for p in SPEC_PROMPTS],
                  paged=True, paged_kernel="gather", draft=jdraft,
                  draft_params=dparams, **kw)
    with pytest.raises(ValueError) as et:
        serve_loop(tmodel, SPEC_PROMPTS, device="cpu", draft=tdraft, **kw)
    assert str(et.value) == str(ej.value)
    assert "does not compose with speculation" in str(et.value)


def test_a_draft_without_weights_is_refused(models):
    """JAX refuses a draft model without draft_params; the port's draft
    holds its own weights, so a draft that is not a port Llama is the
    same mistake, refused with JAX's words."""
    msg = _port_error(models, draft=object())
    assert msg.startswith("draft model given without draft_params")
