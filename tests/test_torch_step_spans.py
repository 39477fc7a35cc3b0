"""The train step's phase spans (engine/tracing: Tracer.train_step,
Tracer.phase, Tracer.backward_part), opened by the four training-step factories,
TrainState.apply_gradients and parallel/dp.finish_step: on only while
torch.profiler captures, one `train_step` root a step with its phases in
order, totals of the latest capture, the same bits with the profiler on
and off, host starts on the profiler's clock, and `train_step.grad_sync`
in a job of two gloo ranks.

This module imports nothing of JAX: a spawned rank imports it to run
`grad_sync_case`."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests import torch_sharded_util as su
from tf_operator_tpu_torch import train_bert, train_llama, train_t5
from tf_operator_tpu_torch.engine import tracing
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import transformer as tt
from tf_operator_tpu_torch.models.transformer import lm_loss
from tf_operator_tpu_torch.models.transformer_bridge import (
    init_transformer_params, transformer_from_params)
from tf_operator_tpu_torch.runtime import optim
from tf_operator_tpu_torch.runtime.train import (
    TrainState, cross_entropy_loss, make_train_step)

TRACER = tracing.get_tracer()
STEP, FWD, BWD, OPT, HEAD, SYNC = (
    "train_step", "train_step.forward", "train_step.backward",
    "train_step.optimizer", "train_step.head", "train_step.grad_sync")


def _llama(tie: bool):
    cfg = tl.tiny(tie_embeddings=tie, dtype=torch.float32, remat=True)
    return tl.Llama.from_params(
        cfg, bridge.init_params(cfg, 0, device="cpu", train=True),
        device="cpu", train=True)


def _tokens(seed: int, shape=(2, 32), vocab: int = 256):
    return torch.randint(0, vocab, shape,
                         generator=torch.Generator().manual_seed(seed))


def _setup(kind: str):
    """(state, a function of a seed giving one step's arguments, the step)
    of a tiny model under each of the four step factories."""
    if kind in ("llama_untied", "llama_tied"):
        model = _llama(kind == "llama_tied")
        return (TrainState.create(model, optim.Adafactor(1e-3)),
                lambda s: (_tokens(s),), train_llama.make_lm_step(model))
    if kind in ("t5", "t5_blocked"):
        cfg = tt.tiny(causal=True, dtype=torch.float32)
        model = transformer_from_params(
            cfg, init_transformer_params(cfg, 0, device="cpu"), device="cpu")
        return (TrainState.create(model, optim.Adafactor(1e-3)),
                lambda s: (_tokens(s),),
                train_t5.make_lm_step(model, blocked_ce=kind == "t5_blocked"))
    if kind == "bert":
        cfg = tt.tiny(dtype=torch.float32)
        model = transformer_from_params(
            cfg, init_transformer_params(cfg, 0, device="cpu"), device="cpu")

        def args(s):
            return next(train_bert.mlm_batches(2, 32, cfg.vocab_size, s,
                                               device="cpu"))

        return (TrainState.create(model, optim.AdamW(1e-3)), args,
                train_bert.make_mlm_step(model))
    torch.manual_seed(0)
    model = torch.nn.Linear(8, 4)

    def rows(s):
        g = torch.Generator().manual_seed(s)
        return torch.randn((8, 8), generator=g), torch.arange(8) % 4

    return (TrainState.create(model, optim.SGD(0.1)), rows,
            make_train_step(model, cross_entropy_loss,
                            has_batch_stats=False, accum_steps=2))


def _capture(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _run(state, args, step, seeds):
    for s in seeds:
        state, m = step(state, *args(s))
    return state, m


def _shape(sp):
    return (sp.name, [_shape(c) for c in sp.children])


def _roots_now():
    """The tracer's ring now (held, so that no id is reused)."""
    return TRACER.traces()


def _new_roots(before):
    """The `train_step` roots that landed in the ring since `before`."""
    seen = {id(r) for r in before}
    return [r for r in TRACER.traces() if r.name == STEP and id(r) not in seen]


def test_no_capture_records_no_span(monkeypatch):
    """Profiler off: a tiny Llama step enters no record_function range,
    records no CUDA event, lands no span and leaves the totals alone."""
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(tracing, "_event", lambda: calls.append("event"))
    state, args, step = _setup("llama_untied")
    ring, totals = TRACER.traces(), TRACER.phase_totals()
    _run(state, args, step, [1, 2])
    assert calls == []
    assert TRACER.traces() == ring
    assert TRACER.phase_totals() == totals


HEADED = [(FWD, [(HEAD, [])]), (BWD, [(HEAD, [])]), (OPT, [])]
PLAIN = [(FWD, []), (BWD, []), (OPT, [])]


@pytest.mark.parametrize("kind,children", [
    ("llama_untied", HEADED), ("llama_tied", HEADED), ("t5", PLAIN),
    ("t5_blocked", HEADED), ("bert", PLAIN),
    # two micro-batches: a forward and a backward each
    ("train_step", [(FWD, []), (BWD, []), (FWD, []), (BWD, []), (OPT, [])]),
])
def test_each_step_is_one_root_with_its_phases_in_order(kind, children):
    state, args, step = _setup(kind)
    state, _ = _run(state, args, step, [1])       # untraced
    before = _roots_now()
    _capture(lambda: _run(state, args, step, [2, 3]))
    roots = _new_roots(before)
    assert [r.attrs["step"] for r in roots] == [1, 2]
    assert all(r.attrs["tokens"] > 0 for r in roots)
    for r in roots:
        assert _shape(r) == (STEP, children)
        assert r.category == "train" and r.device_duration is not None
    totals = TRACER.phase_totals()
    assert totals[STEP].count == 2
    assert totals[OPT].count == 2 and SYNC not in totals
    for name, t in totals.items():
        # on the CPU a phase's device interval is its host interval
        assert t.device_s == t.host_s > 0, name
    # the phases lie inside the step
    inner = sum(totals[n].host_s for n in (FWD, BWD, OPT))
    assert inner <= totals[STEP].host_s


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_a_capture_changes_no_bit(tie):
    """Two steps with the profiler off and on: equal losses and
    parameters, bit for bit; the untied head split equals the whole
    model's logits."""
    runs = []
    for traced in (False, True):
        model = _llama(tie)
        state = TrainState.create(model, optim.Adafactor(1e-3))
        step = train_llama.make_lm_step(model)

        def two():
            losses = []
            st = state
            for s in (5, 6):
                st, m = step(st, _tokens(s))
                losses.append(m["loss"])
            return losses

        losses = _capture(two)[0] if traced else two()
        runs.append((losses, {k: p.detach().clone()
                              for k, p in model.named_parameters()}))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    model, t = _llama(False), _tokens(7)
    with torch.no_grad():
        assert torch.equal(train_llama.untied_loss(model, t),
                           lm_loss(model(t), t))


def test_span_starts_are_on_the_profilers_clock():
    """Each phase span's host start lies within 1 ms of its
    record_function event's start in the same capture (a first capture
    warms up the process's first range entry)."""
    state, args, step = _setup("llama_untied")
    state, _ = _capture(lambda: _run(state, args, step, [1]))[0]
    before = _roots_now()
    _, prof = _capture(lambda: _run(state, args, step, [2, 3]))
    starts = {}
    for e in prof.profiler.kineto_results.events():
        starts.setdefault(e.name(), []).append(e.start_ns())
    spans = [sp for r in _new_roots(before) for sp in r.walk()]
    # a backward part has no range of its own: it starts with backward
    ranged = [sp for sp in spans
              if not (sp.name == HEAD and sp.parent.name == BWD)]
    assert len(ranged) == 2 * 5
    for sp in ranged:
        gap = min(abs(sp.wall_start * 1e9 - s) for s in starts[sp.name])
        assert gap < 1e6, (sp.name, gap)


def test_each_capture_reports_its_own_steps():
    """Captures are told apart by a step between them with the profiler
    off: each capture's totals count its own steps only."""
    state, args, step = _setup("llama_tied")
    state, _ = _run(state, args, step, [0])       # untraced
    state, _ = _capture(lambda: _run(state, args, step, [1, 2]))[0]
    first = TRACER.phase_totals()
    state, _ = _run(state, args, step, [3])       # untraced
    _capture(lambda: _run(state, args, step, [4, 5, 6]))
    second = TRACER.phase_totals()
    assert first[STEP].count == 2 and first[HEAD].count == 4
    assert second[STEP].count == 3 and second[HEAD].count == 6
    assert TRACER.phase_totals() == second


def grad_sync_case(axes, **kw):
    """One untraced and one traced make_lm_step step of the tiny untied
    Llama, each rank (or the one process) on its own rows: the traced
    step's phase tree."""
    from tf_operator_tpu_torch.parallel import dp

    torch.manual_seed(0)
    model = _llama(False)
    dp.replicate_(model)
    state = TrainState.create(model, optim.Adafactor(1e-3))
    step = train_llama.make_lm_step(model)
    rank = dp.rank(dp.job_group())
    state, _ = step(state, _tokens(10 + rank))
    before = _roots_now()
    _capture(lambda: step(state, _tokens(20 + rank)))
    return {"tree": [_shape(r) for r in _new_roots(before)],
            "totals": sorted(TRACER.phase_totals())}


def test_grad_sync_is_a_phase_of_a_job_only(tmp_path):
    out = su.join(su.start(
        {"spans": ("tests.test_torch_step_spans:grad_sync_case", None, {})},
        tmp_path, n=2))["spans"]
    assert out["tree"] == [(STEP, [(FWD, [(HEAD, [])]), (BWD, [(HEAD, [])]),
                                   (SYNC, []), (OPT, [])])]
    assert SYNC in out["totals"]
    alone = grad_sync_case(None)
    assert alone["tree"] == [(STEP, HEADED)]
    assert SYNC not in alone["totals"]
