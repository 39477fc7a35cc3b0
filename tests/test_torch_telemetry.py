"""The port's serving telemetry (tf_operator_tpu_torch.engine.{metrics,
tracing}, models.telemetry and serve_loop's wiring) against the JAX
package's, on the CPU at tiny f32 widths.

First the seven non-speculative cases of tests/test_serving_telemetry.py,
run on the port.  Then the same requests through both serve loops (the
JAX one paged, through its gather oracle) under the slot scheduler, the
continuous one, a shared prefix and the handoff: every ServeStats field
that is not a clock reading, the span trees (names, nesting, categories,
attrs, lanes), every histogram's observation count, the non-clock
counters and the request recorder's events per request must be equal.
The metric families and the Chrome export are held against their JAX
originals directly.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_metrics_exposition import parse_exposition
from tests.torch_serving_util import (one_torch_thread, prompts as np_prompts,
                                      tiny_models)
from tf_operator_tpu.engine import metrics as jem
from tf_operator_tpu.engine import tracing as jtr
from tf_operator_tpu.engine.reqtrace import RequestRecorder
from tf_operator_tpu.models import telemetry as jtel
from tf_operator_tpu.models.serving import serve_loop as jax_serve
from tf_operator_tpu_torch.engine import metrics as em
from tf_operator_tpu_torch.engine import tracing as ttr
from tf_operator_tpu_torch.engine.tracing import Span, Tracer
from tf_operator_tpu_torch.models.serving import serve_loop
from tf_operator_tpu_torch.models.telemetry import ServeStats, ServeTelemetry

LENS = [5, 13, 3, 9, 17]
BUDGETS = [8, 5, 9, 6, 7]
# ServeStats fields read off the host clock (compared for consistency,
# not equality)
CLOCK_FIELDS = {
    "wall_time_s", "tokens_per_sec", "queue_wait_mean_s",
    "queue_wait_max_s", "ttft_mean_s", "ttft_max_s", "tpot_mean_s",
    "e2e_latency_mean_s", "e2e_latency_max_s", "prefill_time_s",
    "decode_time_s", "occupancy_mean", "kv_block_occupancy_mean"}
CLOCK_DETAIL = {"queue_wait_s", "ttft_s", "e2e_s", "duration"}
CLOCK_COUNTERS = {"SERVING_PREFILL_TIME", "SERVING_DECODE_TIME"}
# the port names its read paths "cuda" / "plain" where JAX says
# "pallas" / "gather"
KERNEL = {"plain": "gather", "cuda": "pallas"}



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tiny tensors run on one torch thread (the JAX side
    keeps its own pool)."""
    with one_torch_thread():
        yield

@pytest.fixture(scope="module")
def models():
    jmodel, params, tmodel = tiny_models()
    return jmodel, params, tmodel


def _prompts(lens, seed=1):
    return np_prompts(lens, seed)


# ------------------------------------------ tests/test_serving_telemetry.py
def test_serve_stats_plain_internally_consistent(models):
    _, _, tmodel = models
    prompts = _prompts([6, 11, 3, 9, 7])
    res, stats = serve_loop(tmodel, prompts, slots=2, max_new_tokens=10,
                            device="cpu", return_stats=True)
    assert isinstance(stats, ServeStats)
    assert stats.requests == len(prompts)
    assert stats.slots == 2 and not stats.speculative
    assert stats.paged and stats.paged_kernel == "plain"
    assert stats.total_tokens == sum(len(r.tokens) for r in res)
    assert stats.wall_time_s > 0
    assert stats.tokens_per_sec > 0
    assert len(stats.per_request) == len(prompts)
    for pr, r in zip(stats.per_request, res):
        assert pr["tokens"] == len(r.tokens)
        assert pr["slot"] == r.slot
        assert pr["queue_wait_s"] >= 0
        assert 0 <= pr["ttft_s"] <= pr["e2e_latency_s"]
        assert pr["queue_wait_s"] + pr["ttft_s"] <= pr["e2e_latency_s"]
        assert pr["e2e_latency_s"] <= stats.wall_time_s
        assert pr["accepted_drafts"] == 0 and pr["proposed_drafts"] == 0
    e2es = [pr["e2e_latency_s"] for pr in stats.per_request]
    assert abs(stats.e2e_latency_mean_s - sum(e2es) / len(e2es)) < 1e-9
    assert stats.e2e_latency_max_s == max(e2es)
    assert stats.ttft_max_s == max(pr["ttft_s"] for pr in stats.per_request)
    assert 0 < stats.occupancy_mean <= 2
    assert 1 <= stats.occupancy_max <= 2
    assert 0 < stats.kv_block_occupancy_mean <= stats.kv_blocks_total
    assert stats.decode_time_s > 0 and stats.prefill_time_s > 0
    assert stats.tpot_mean_s is not None and stats.tpot_mean_s > 0
    assert stats.accepted_drafts == 0 and stats.proposed_drafts == 0
    assert stats.acceptance_rate is None
    # the CPU has no device memory to report
    assert stats.hbm_peak_bytes == {}


def test_stats_collection_does_not_change_tokens(models):
    _, _, tmodel = models
    prompts = _prompts([6, 8, 5], seed=3)
    kw = dict(slots=2, max_new_tokens=8, device="cpu")
    plain = serve_loop(tmodel, prompts, **kw)
    with_stats, _ = serve_loop(tmodel, prompts, return_stats=True, **kw)
    private = serve_loop(tmodel, prompts,
                         telemetry=ServeTelemetry(tracer=Tracer()), **kw)
    assert [r.tokens for r in plain] == [r.tokens for r in with_stats]
    assert [r.tokens for r in plain] == [r.tokens for r in private]


def test_empty_request_list_returns_empty_stats(models):
    _, _, tmodel = models
    res, stats = serve_loop(tmodel, [], slots=3, device="cpu",
                            return_stats=True)
    assert res == []
    assert stats.requests == 0 and stats.total_tokens == 0
    assert stats.slots == 3 and not stats.speculative
    assert serve_loop(tmodel, [], device="cpu") == []
    _, spec = serve_loop(tmodel, [], slots=2, device="cpu", draft=tmodel,
                         return_stats=True)
    assert spec.speculative and spec.slots == 2


def test_summary_is_json_safe_and_drops_per_request(models):
    _, _, tmodel = models
    _, stats = serve_loop(tmodel, _prompts([5, 7], seed=5), slots=2,
                          max_new_tokens=6, device="cpu", return_stats=True)
    s = stats.summary()
    assert "per_request" not in s
    json.dumps(s)
    assert s["requests"] == 2
    # JAX's fields, in JAX's order
    assert list(s) == [f.name for f in dataclasses.fields(jtel.ServeStats)
                       if f.name != "per_request"]


def test_new_families_round_trip_exposition(models):
    _, _, tmodel = models
    prompts = _prompts([6, 9], seed=7)
    before = em.SERVING_REQUESTS.get()
    tokens_before = em.SERVING_TOKENS.get()
    res = serve_loop(tmodel, prompts, slots=2, max_new_tokens=8,
                     device="cpu")
    samples = parse_exposition(em.expose_all())
    (_, req_count), = samples["tpu_operator_serving_requests_total"]
    assert req_count == before + len(prompts)
    (_, tok_count), = samples["tpu_operator_serving_tokens_total"]
    assert tok_count == tokens_before + sum(len(r.tokens) for r in res)
    for fam in ("tpu_operator_serving_ttft_seconds",
                "tpu_operator_serving_queue_wait_seconds",
                "tpu_operator_serving_request_latency_seconds"):
        assert f"{fam}_bucket" in samples, fam
        (_, count), = samples[f"{fam}_count"]
        assert count >= len(prompts)
    (_, occ), = samples["tpu_operator_serving_batch_occupancy"]
    assert occ == 0
    assert em.SERVING_BATCH_OCCUPANCY.get() == 0


def test_chrome_trace_dump_valid_and_well_nested(models, tmp_path):
    _, _, tmodel = models
    tracer = Tracer()
    prompts = _prompts([40, 6, 9], seed=9)
    res = serve_loop(tmodel, prompts, slots=2, max_new_tokens=8,
                     prefill_chunk=8, prefill_chunks_per_sync=1,
                     block_size=8, device="cpu",
                     telemetry=ServeTelemetry(tracer=tracer))
    roots = tracer.traces()
    assert len(roots) == len(prompts)
    by_req = {sp.attrs["request"]: sp for sp in roots}
    for i, r in enumerate(res):
        root = by_req[i]
        assert root.name == "serve_request"
        assert root.category == "serving"
        assert root.attrs["slot"] == r.slot
        assert root.attrs["tokens"] == len(r.tokens)
        assert [c.name for c in root.children] == ["queued", "prefill",
                                                   "decode"]
        prefill = root.children[1]
        if i == 0:
            assert len(prefill.children) == 5
            seg = prefill.children[0]
            assert seg.name == "prefill_segment"
            assert seg.attrs["token_start"] == 0
        for parent in root.walk():
            p_end = parent.wall_start + parent.duration
            for c in parent.children:
                assert c.wall_start >= parent.wall_start - 1e-6
                assert c.wall_start + c.duration <= p_end + 1e-6
    path = tmp_path / "serve_trace.json"
    tracer.dump(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    assert all(e["ph"] == "X" and e["cat"] == "serving" for e in events)
    assert sum(1 for e in events if e["name"] == "serve_request") == 3
    for e in events:
        assert e["dur"] >= 0 and isinstance(e["ts"], float)


def test_record_rejects_unfinished_root():
    with pytest.raises(ValueError, match="unfinished"):
        Tracer().record(Span(name="x", start=0.0, wall_start=0.0))


# ----------------------------------------------- the copies, held directly
def test_families_equal_the_jax_package():
    """Each copied family: same name, type, HELP text and buckets as the
    JAX package's family of the same Python name; the 24 of them are
    the port's whole registry."""
    fams = {n: v for n, v in vars(em).items()
            if n.startswith("SERVING_") and isinstance(v, em.Metric)}
    assert len(fams) == 24
    assert sorted(m.name for m in em._REGISTRY) == sorted(
        m.name for m in fams.values())
    for name, m in fams.items():
        j = getattr(jem, name)
        assert (m.name, m.TYPE, m.help) == (j.name, j.TYPE, j.help), name
        if isinstance(m, em.Histogram):
            assert m.buckets == j.buckets, name
    assert em.Histogram.DEFAULT_BUCKETS == jem.Histogram.DEFAULT_BUCKETS


def test_chrome_export_equals_the_jax_package():
    """The same span tree through both tracers gives the same Chrome
    trace, category and limit filters included."""
    def tree(mod):
        root = mod.Span(name="serve_request", start=1.0, wall_start=100.0,
                        attrs={"request": 0, "slot": 1}, duration=2.5,
                        thread_id=7, category="serving")
        kid = mod.Span(name="prefill", start=1.5, wall_start=100.5,
                       attrs={"segments": 2}, duration=1.0, parent=root,
                       thread_id=7, category="serving")
        root.children.append(kid)
        other = mod.Span(name="sync", start=0.0, wall_start=99.0,
                         duration=0.25, thread_id=3)
        return [other, root]

    jt, pt = jtr.Tracer(), ttr.Tracer()
    for a, b in zip(tree(jtr), tree(ttr)):
        jt.record(a)
        pt.record(b)
    for kw in ({}, {"category": "serving"}, {"limit": 1},
               {"category": "reconcile", "limit": 5}):
        assert pt.to_chrome_trace(**kw) == jt.to_chrome_trace(**kw), kw
    assert pt.export_chrome_json() == jt.export_chrome_json()
    assert [s.to_dict() for s in pt.traces()] == [
        s.to_dict() for s in jt.traces()]


# ---------------------------------------- the same runs through both loops
_HISTS = ("SERVING_TTFT", "SERVING_TPOT", "SERVING_QUEUE_WAIT",
          "SERVING_REQUEST_LATENCY", "SERVING_HANDOFF_DURATION")


def _hist_counts(mod):
    return {n: {k: v[0][-1] for k, v in getattr(mod, n)._obs.items()}
            for n in _HISTS}


# the families the port copies, by kind (read from either module)
_FAMILIES = {n: type(m).__name__ for n, m in vars(em).items()
             if n.startswith("SERVING_") and isinstance(m, em.Metric)}


def _counters(mod):
    return {n: getattr(mod, n).samples() for n, kind in _FAMILIES.items()
            if kind == "Counter" and n not in CLOCK_COUNTERS}


def _gauges(mod):
    """Every series a serve loop writes to the gauge families.  The
    router's per-fleet series of the same families (labelled "fleet",
    router.py:1408-1409) are left out: they are no serve loop's, and a
    router or fleet test earlier in the process leaves them behind."""
    return {n: {k: v for k, v in getattr(mod, n).samples().items()
                if "fleet" not in dict(k)}
            for n, kind in _FAMILIES.items()
            if kind == "Gauge" and n != "SERVING_HBM_PEAK"}


def _delta(after, before):
    out = {}
    for name, vals in after.items():
        d = {k: v - before[name].get(k, 0) for k, v in vals.items()}
        out[name] = {_kernel_key(k): v for k, v in d.items() if v}
    return out


def _kernel_key(key):
    return tuple((a, KERNEL.get(b, b) if a == "kernel" else b)
                 for a, b in key)


def _span_tree(sp):
    return (sp.name, sp.category, sp.thread_id, dict(sp.attrs),
            [_span_tree(c) for c in sp.children])


def _events(rec, n):
    out = []
    for i in range(n):
        tl = rec.request_timeline("local/serve", f"req{i}")
        out.append([(e["event"], {k: v for k, v in e["detail"].items()
                                  if k not in CLOCK_DETAIL})
                    for e in (tl["events"] if tl else [])])
    return out


def _instrumented(fn, mod, tel_cls, tracer_cls, n):
    """fn(telemetry) under fresh instruments; returns (fn's result,
    what the instruments saw)."""
    rec = RequestRecorder()
    tracer = tracer_cls()
    h0, c0 = _hist_counts(mod), _counters(mod)
    out = fn(tel_cls(tracer=tracer, reqtrace=rec))
    h1, c1 = _hist_counts(mod), _counters(mod)
    seen = {
        # the series this run observed: one that another test in the
        # process left behind, and this run did not touch, is no part of
        # it (tests/test_torch_tp_serving.py's handoffs leave the port's)
        "hist": {n_: {k: v - h0[n_].get(k, 0) for k, v in h1[n_].items()
                      if v != h0[n_].get(k, 0)}
                 for n_ in _HISTS},
        "counters": _delta(c1, c0),
        "gauges": {k: {_kernel_key(a): b for a, b in v.items()}
                   for k, v in _gauges(mod).items()},
        "spans": sorted((_span_tree(r) for r in tracer.traces()),
                        key=lambda t: t[3]["request"]),
        "events": _events(rec, n),
    }
    return out, seen


def _non_clock(stats):
    d = dataclasses.asdict(stats)
    out = {k: v for k, v in d.items()
           if k not in CLOCK_FIELDS and k != "per_request"}
    out["paged_kernel"] = KERNEL.get(out["paged_kernel"], out["paged_kernel"])
    out["tpot_is_none"] = stats.tpot_mean_s is None
    out["per_request"] = [
        {k: v for k, v in r.items()
         if k in ("request", "slot", "tokens", "accepted_drafts",
                  "proposed_drafts")} | {"tpot_is_none": r["tpot_s"] is None}
        for r in stats.per_request]
    return out


def run_pair(models, prompts, jax_kw=None, port_kw=None, paged=True,
             **kw):
    """The same requests through JAX's serve_loop and the port's, paged
    (JAX through its gather oracle) or over dense rings, each with a
    private tracer, a RequestRecorder and return_stats (jax_kw and
    port_kw: keywords for one side only); returns ((jax results, stats,
    seen), (port results, stats, seen))."""
    jmodel, params, tmodel = models
    jkw = dict(kw, **(jax_kw or {}))
    kw = dict(kw, **(port_kw or {}))
    layout = (dict(paged=True, paged_kernel="gather") if paged
              else dict(paged=False))
    (jres, jst), jseen = _instrumented(
        lambda tel: jax_serve(jmodel, params,
                              [jnp.asarray(p) for p in prompts],
                              return_stats=True, telemetry=tel, **layout,
                              **jkw),
        jem, jtel.ServeTelemetry, jtr.Tracer, len(prompts))
    (tres, tst), tseen = _instrumented(
        lambda tel: serve_loop(tmodel, prompts, device="cpu", paged=paged,
                               return_stats=True, telemetry=tel, **kw),
        em, ServeTelemetry, Tracer, len(prompts))
    return (jres, jst, jseen), (tres, tst, tseen)


def assert_same_telemetry(jax_side, port_side):
    _, jst, jseen = jax_side
    _, tst, tseen = port_side
    assert _non_clock(tst) == _non_clock(jst)
    for key in ("hist", "counters", "gauges", "spans", "events"):
        assert tseen[key] == jseen[key], key
    # the clocks are at least consistent
    for st in (tst, jst):
        assert st.wall_time_s > 0 and st.decode_time_s >= 0


def _results(res):
    return [(r.tokens, r.admitted_at_step, r.finished_at_step, r.slot,
             r.accepted_drafts, r.proposed_drafts, r.kv_blocks)
            for r in res]


SCHED_KW = dict(slots=2, max_new_tokens=BUDGETS, block_size=4,
                prefill_chunk=8, pool_blocks=7, steps_per_sync=4)


@pytest.mark.parametrize("scheduler", ["slot", "continuous"])
def test_scheduler_telemetry_equals_jax(models, scheduler):
    """Five ragged requests through 2 lanes over a 7-block pool, prompts
    streamed in 8-token segments: the gate holds the queue head (slot),
    or the step gate admits lazily, preempts and fuses segments into
    decode dispatches (continuous)."""
    _scheduler_case(models, scheduler)


def _scheduler_case(models, scheduler):
    j, t = run_pair(models, _prompts(LENS), scheduler=scheduler, **SCHED_KW)
    assert _results(t[0]) == _results(j[0])
    assert_same_telemetry(j, t)
    st = t[1]
    if scheduler == "continuous":
        assert st.fused_prefill_tokens > 0 and st.preemptions > 0
    else:
        assert st.admissions_blocked_on_memory > 0
    assert st.occupancy_max == 2 and st.kv_blocks_peak_used <= 7


def test_shared_prefix_telemetry_equals_jax(models):
    """An unaligned 10-token prefix (a CoW block a lane), suffixes
    through 2 lanes: CoW copies, prefix block hits and the span trees
    equal."""
    _shared_prefix_case(models)


def _shared_prefix_case(models):
    pfx = _prompts([10], seed=3)[0]
    j, t = run_pair(models, _prompts([5, 9, 3, 7, 6], seed=4), slots=2,
                    max_new_tokens=8, block_size=4, shared_prefix=pfx)
    assert _results(t[0]) == _results(j[0])
    assert_same_telemetry(j, t)
    assert t[1].cow_copies == 5 and t[1].prefix_block_hits == 10


def test_handoff_telemetry_equals_jax(models):
    """prefill_only over a shared prefix, then the decode side adopting
    the handoffs under the continuous scheduler: exports, adoptions,
    handoff block counts and durations observed, and the decode side's
    spans (admitted after the adoption, then activated) equal JAX's."""
    _handoff_case(models)


def _handoff_case(models):
    pfx = _prompts([8], seed=5)[0]
    sufs = _prompts([5, 9, 3, 7], seed=6)
    kw = dict(slots=2, max_new_tokens=[6, 1, 7, 5], block_size=4)
    j, t = run_pair(models, sufs, shared_prefix=pfx, prefill_only=True,
                    **kw)
    assert_same_telemetry(j, t)
    assert t[1].handoff_exports == 3  # one request finished at prefill
    jhand, thand = j[0], t[0]
    full = [np.concatenate([pfx, s]) for s in sufs]
    jmodel, params, tmodel = models
    (jres, jst), jseen = _instrumented(
        lambda tel: jax_serve(jmodel, params, [jnp.asarray(p) for p in full],
                              paged=True, paged_kernel="gather",
                              adopt=jhand, scheduler="continuous",
                              return_stats=True, telemetry=tel, **kw),
        jem, jtel.ServeTelemetry, jtr.Tracer, len(full))
    (tres, tst), tseen = _instrumented(
        lambda tel: serve_loop(tmodel, full, device="cpu", adopt=thand,
                               scheduler="continuous", return_stats=True,
                               telemetry=tel, **kw),
        em, ServeTelemetry, Tracer, len(full))
    assert _results(tres) == _results(jres)
    assert_same_telemetry((jres, jst, jseen), (tres, tst, tseen))
    assert tst.handoff_adoptions == 3 and tst.prefix_block_hits > 0
    # the decode side's TTFT runs from the adopted lane's admission
    events = [e for e, _ in tseen["events"][0]]
    assert events.index("admitted") < events.index("first_token")


def test_comparisons_ignore_router_fleet_gauges(models):
    """A router or fleet test earlier on the same worker leaves
    {"fleet": ...} series in the JAX package's KV-block gauges
    (router.py:1408-1409), which no port serve loop writes.  Planted as
    the router sets them, they must not reach the four comparisons
    above, which still hold every other gauge series exactly; the
    registry is put back as it was."""
    fams = (jem.SERVING_KV_BLOCKS_USED, jem.SERVING_KV_BLOCKS_TOTAL)
    saved = [dict(f._values) for f in fams]
    try:
        for f in fams:
            f.set(3, {"fleet": "decode"})
        for scheduler in ("slot", "continuous"):
            _scheduler_case(models, scheduler)
        _shared_prefix_case(models)
        _handoff_case(models)
        assert all(f.get({"fleet": "decode"}) == 3 for f in fams)
    finally:
        for f, vals in zip(fams, saved):
            f._values.clear()
            f._values.update(vals)
