"""The ring over tp (ops/ring_flash.make_ring_flash_attention_fn(mesh,
"tp"), parallel/comm.exchange, parallel/ring.ProcessRing over a mesh
group): one spawned job of eight JAX-free gloo ranks
(tests/torch_sharded_util.py) runs every case in turn.

  - The attention function on rings of 2, 4 and 8 ranks (tp 2 x dp 4,
    tp 4 x dp 2, tp 4 x fsdp 2, tp 8), each rank handing over its own
    heads as a tp-placed model does, is held against JAX's
    make_ring_flash_attention_fn(mesh, "tp", interpret=True) on the
    forced host devices (tests/test_ring_flash.py:35-60): the output
    and the gradients of q, k and v, causal and windowed and full, kv
    heads dividing tp and not (tp 4 with 2 and 3 kv heads, tp 8 with
    2), within 1e-5.  Where the kv heads do not divide tp several ranks
    hold copies of one kv head; the sum of their gradients is JAX's.
    Every data member's ranks give the same readings, and each ring
    member is the rank at that tp coordinate.
  - A train_llama step with the ring over tp on tp 2 x fsdp 2 x dp 2,
    and mistral's window under remat (the backward replays the exchange)
    on tp 4 x fsdp 2 (kv heads 2: the wkv stays whole), against the
    port's one process with flash attention, two
    steps: losses and gradient norms 1e-5 relative, parameters rtol
    1e-5 + atol 1e-5, as tests/test_torch_sharded.py holds them.
  - train_llama --smoke --tp 2 --ring as the eight ranks of a job.
"""
import jax
import numpy as np
import pytest
import torch

from tests import torch_sharded_util as u
from tf_operator_tpu.ops import ring_flash as jrf
from tf_operator_tpu.parallel import mesh as jm
from tf_operator_tpu_torch.parallel import mesh as pm

TRAIN = {
    "ring_tp": ({"tp": 2, "fsdp": 2, "dp": 2}, dict(ring=True)),
    "ring_tp4_window": ({"tp": 4, "fsdp": 2},
                        dict(ring=True, window=16, d_ff=256, remat=True)),
}
CLI = ["--smoke", "--tp", "2", "--ring", "--steps", "2",
       "--per-host-batch", "2", "--seq-len", "16"]


def _jax_ring(axes, h, kv, causal, window, seed):
    n = axes["tp"]
    jmesh = jm.make_mesh({"tp": n}, devices=jax.devices()[:n])
    fn = jrf.make_ring_flash_attention_fn(jmesh, "tp", interpret=True)
    q, k, v, do = u.ring_inputs(seed, h, kv)

    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, causal,
                                              window=window), q, k, v)
        return (out,) + vjp(do)

    return [np.asarray(x) for x in jax.jit(run)(q, k, v, do)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_tp")
    jobs = {tag: ("ring_fn", axes, dict(h=h, kv=kv, causal=c, window=w,
                                        seed=i))
            for i, (tag, (axes, h, kv, c, w)) in enumerate(
                u.RING_CASES.items())}
    jobs.update({tag: ("llama", axes, kw)
                 for tag, (axes, kw) in TRAIN.items()})
    jobs["cli"] = ("cli_parallel", None, dict(argv=CLI))
    job = u.start(jobs, tmp)
    want = {tag: _jax_ring(axes, h, kv, c, w, i)
            for i, (tag, (axes, h, kv, c, w)) in enumerate(
                u.RING_CASES.items())}
    one = {tag: u.one_process("llama", **kw)
           for tag, (_, kw) in TRAIN.items()}
    return {"got": u.join(job), "jax": want, "one": one}


@pytest.mark.parametrize("tag", sorted(u.RING_CASES))
def test_ring_over_tp_matches_jax(run, tag):
    axes, h, kv, _, _ = u.RING_CASES[tag]
    ranks = run["got"][tag]
    want_out, want_dq, want_dk, want_dv = run["jax"][tag]
    mesh = pm.make_mesh(axes, world=8)
    n = axes["tp"]
    by_member = {}
    for r, rec in enumerate(ranks):
        c = mesh.coords(r)
        assert rec["tp"] == rec["ring_rank"] == c["tp"]
        # the member one place on is the rank at the next tp coordinate
        nxt = dict(c, tp=(c["tp"] + 1) % n)
        assert rec["peer"] == int(mesh.grid[tuple(nxt[a] for a in
                                                  pm.AXIS_ORDER)])
        key = tuple(v for a, v in c.items() if a != "tp")
        by_member.setdefault(key, []).append(rec)
    assert len(by_member) == 8 // n
    for recs in by_member.values():
        recs = sorted(recs, key=lambda rec: rec["tp"])
        out = torch.cat([rec["out"] for rec in recs], dim=2)
        dq = torch.cat([rec["grads"][0] for rec in recs], dim=2)
        dk = torch.zeros(want_dk.shape)
        dv = torch.zeros(want_dv.shape)
        for rec in recs:
            for j, head in enumerate(rec["ids"]):
                dk[:, :, head] += rec["grads"][1][:, :, j]
                dv[:, :, head] += rec["grads"][2][:, :, j]
        for got, want, name in ((out, want_out, "out"), (dq, want_dq, "dq"),
                                (dk, want_dk, "dk"), (dv, want_dv, "dv")):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{tag} {name}")


@pytest.mark.parametrize("tag", sorted(TRAIN))
def test_ring_over_tp_trains_as_one_process(run, tag):
    got, want = run["got"][tag], run["one"][tag]
    assert len(got["losses"]) == u.STEPS
    assert all(g > 0 for g in got["gnorms"])
    u.check(got, want, adam=False, tag=tag)


def test_train_llama_tp_ring_cli(run):
    rc, out = run["got"]["cli"]
    assert rc == 0, out
    assert ("mesh {'dcn': 1, 'pp': 1, 'dp': 4, 'fsdp': 1, 'ep': 1, "
            "'tp': 2}") in out
    assert "ring attention over ProcessRing(rank 0 of 2)" in out
    assert "complete: steps=2 resumed_from=None" in out
