"""The plain versions of the port's ring step kernels (K3f
`carry_fwd_plain`, K3q `ring_dq_plain`, K3kv `ring_dkv_plain` in
tf_operator_tpu_torch.ops.ring_flash) against the JAX package's Pallas
step kernels themselves (`_carry_fwd_call`, `_bwd_step_call`, interpret
mode, as tests/test_ring_flash.py runs them on the CPU).

JAX takes [B*H, S, D] inputs with kv repeated to H heads and returns
per-head dk/dv, which `_fold_dkv` sums; the port takes compact kv and
sums each group itself.  Both get the same half-chunk offsets.
Tolerances: 1e-5 in f32 (tiles folded by online softmax against
whole-shard einsums), 3e-2 in bf16 (p and dS rounded to bf16, 2^-8
relative).  Cases: a diagonal, a past and a future (fully masked) step;
contiguous and zigzag offsets; window 8 with a partly live step; a
carry-in with rows that saw no key; lse = POS_INF rows.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.ops import ring_flash as trf

# the package re-exports functions under the modules' names
jrf = importlib.import_module("tf_operator_tpu.ops.ring_flash")

N = 4
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------- one ring step
B, SL, H, D = 2, 64, 4, 32
STEP_TOL = {"f32": 1e-5, "bf16": 3e-2}

# (name, layout, my, src, window, carry): S_local = 64 of a ring of 4
STEP_CASES = [
    ("diagonal", "contiguous", 2, 2, None, "fresh"),
    ("past", "contiguous", 2, 1, None, "mid"),
    ("future", "contiguous", 1, 2, None, "mid"),
    ("zigzag-diagonal", "zigzag", 1, 1, None, "fresh"),
    ("zigzag-cross", "zigzag", 1, 2, None, "mid"),
    ("window-8", "contiguous", 2, 1, 8, "mid"),
    ("masked-rows", "contiguous", 2, 2, None, "masked"),
]


def _step_inputs(seed, kv, carry):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, do = f(B, SL, H, D), f(B, SL, H, D)
    k, v = f(B, SL, kv, D), f(B, SL, kv, D)
    m = np.full((B, H, SL), trf.NEG_INF, np.float32)
    l = np.zeros((B, H, SL), np.float32)
    acc = np.zeros((B, SL, H, D), np.float32)
    if carry != "fresh":
        m, l, acc = f(B, H, SL), np.abs(f(B, H, SL)) + 1, f(B, SL, H, D)
    if carry == "masked":
        # rows that saw no key before this step
        m[:, :, :20] = trf.NEG_INF
        l[:, :, :20] = 0.0
        acc[:, :20] = 0.0
    lse, delta = f(B, H, SL) + 3, f(B, H, SL)
    lse[:, 1, 5:9] = trf.POS_INF  # rows that saw no key in the ring
    return dict(q=q, k=k, v=v, do=do, m=m, l=l, acc=acc, lse=lse,
                delta=delta)


def _to_bh(x, group=1):
    """[B, S, Hx, D] -> [B*Hx*group, S, D] (kv repeated group times)."""
    b, s, hx, d = x.shape
    y = jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * hx, s, d)
    return jnp.repeat(y, group, axis=0) if group > 1 else y


def _stat_bh(x):
    """[B, H, S] -> [B*H, S, 1]."""
    return jnp.asarray(x).reshape(-1, x.shape[-1], 1)


def _from_bh(x, heads):
    """[B*Hx, S, D] -> [B, S, Hx, D]."""
    x = _np(x)
    return x.reshape(-1, heads, *x.shape[1:]).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("kv,dt", [(1, "f32"), (2, "f32"), (4, "f32"),
                                   (2, "bf16")])
@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_step_plain_versions_match_pallas_step_kernels(case, kv, dt):
    name, layout, my, src, window, carry = case
    x = _step_inputs(STEP_CASES.index(case) * 10 + kv, kv, carry)
    jdt, tdt = _DT[dt]
    g = H // kv
    q_off = trf.offsets(my, N, SL, layout)
    k_off = trf.offsets(src, N, SL, layout)
    jq_off = jrf._offsets(jnp.int32(my), N, SL, layout)
    jk_off = jrf._offsets(jnp.int32(src), N, SL, layout)
    blk = dict(blk_q=32, blk_k=32, interpret=True, window=window)
    jq, jdo = (_to_bh(x[n]).astype(jdt) for n in ("q", "do"))
    jk, jv = (_to_bh(x[n], g).astype(jdt) for n in ("k", "v"))
    tq, tk, tv, tdo = (torch.from_numpy(x[n]).to(tdt)
                       for n in ("q", "k", "v", "do"))
    t = {n: torch.from_numpy(x[n]) for n in ("m", "l", "acc", "lse", "delta")}
    tol = STEP_TOL[dt]

    jm, jl_, jacc = jrf._carry_fwd_call(
        jq, jk, jv, _stat_bh(x["m"]), _stat_bh(x["l"]), _to_bh(x["acc"]),
        jq_off, jk_off, causal=True, **blk)
    m, l, acc = trf.carry_fwd_plain(tq, tk, tv, t["m"], t["l"], t["acc"],
                                    q_off, k_off, True, window)
    np.testing.assert_allclose(m.numpy(), _np(jm).reshape(B, H, SL),
                               rtol=tol, atol=tol, err_msg="m")
    np.testing.assert_allclose(l.numpy(), _np(jl_).reshape(B, H, SL),
                               rtol=tol, atol=tol, err_msg="l")
    np.testing.assert_allclose(acc.numpy(), _from_bh(jacc, H), rtol=tol,
                               atol=tol, err_msg="acc")
    if name == "future":
        # a dead step leaves the carry as it was, bit for bit
        for a, n in ((m, "m"), (l, "l"), (acc, "acc")):
            assert torch.equal(a, t[n]), n
    if carry == "masked":
        # a masked row that sees its first keys here starts from them
        assert bool((l[:, :, :20] > 0).all())

    jdq, jdk, jdv = jrf._bwd_step_call(
        jq, jk, jv, jdo, _stat_bh(x["lse"]), _stat_bh(x["delta"]), jq_off,
        jk_off, causal=True, **blk)
    bwd = (tq, tk, tv, tdo, t["lse"], t["delta"], q_off, k_off, True, window)
    dq = trf.ring_dq_plain(*bwd)
    dk, dv = trf.ring_dkv_plain(*bwd)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    np.testing.assert_allclose(dq.numpy(), _from_bh(jdq, H), rtol=tol,
                               atol=tol, err_msg="dq")
    for got, want, n in ((dk, jdk, "dk"), (dv, jdv, "dv")):
        folded = jrf._fold_dkv(jnp.asarray(want), g)
        np.testing.assert_allclose(got.numpy(), _from_bh(folded, kv),
                                   rtol=tol, atol=tol, err_msg=n)


def test_wrappers_run_the_plain_versions_in_place_on_the_cpu():
    """On CPU tensors the launch wrappers update the carry and add to the
    accumulators in place, count no launch, and equal the plain
    versions."""
    x = _step_inputs(11, 2, "mid")
    t = {n: torch.from_numpy(v.copy()) for n, v in x.items()}
    offs = ((64, 96), (0, 32), True, None)
    want = trf.carry_fwd_plain(t["q"], t["k"], t["v"], t["m"], t["l"],
                               t["acc"], *offs)
    before = dict(trf.launches)
    trf.ring_fwd(t["q"], t["k"], t["v"], t["m"], t["l"], t["acc"], *offs)
    for a, b in zip((t["m"], t["l"], t["acc"]), want):
        assert torch.equal(a, b)
    bwd = (t["q"], t["k"], t["v"], t["do"], t["lse"], t["delta"])
    dq = torch.ones((B, SL, H, D))
    dk, dv = torch.ones((B, SL, 2, D)), torch.ones((B, SL, 2, D))
    trf.ring_dq(*bwd, dq, *offs)
    trf.ring_dkv(*bwd, dk, dv, *offs)
    torch.testing.assert_close(dq, 1 + trf.ring_dq_plain(*bwd, *offs),
                               rtol=0, atol=0)
    dk_c, dv_c = trf.ring_dkv_plain(*bwd, *offs)
    torch.testing.assert_close(dk, 1 + dk_c, rtol=0, atol=0)
    torch.testing.assert_close(dv, 1 + dv_c, rtol=0, atol=0)
    assert trf.launches == before
