"""The port's Llama (tf_operator_tpu_torch.models.llama) against the JAX
package's models/llama.py: rotary tables and rotation, RMSNorm, and the
paged decoder end to end (bridged flax params, prefill segments and
per-lane decode steps), on the CPU where every KV read takes the paged
kernel's plain version and the JAX side reads through its gather oracle.
"""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import paging as jpg
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import paging as tpg

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


# ------------------------------------------------------------------ rotary
@pytest.mark.parametrize("scaling", [None, "llama3"])
def test_rope_table_matches_jax(scaling):
    """The same f32 ops in the same order; 1e-6 relative covers one ulp
    of pow/division on either side."""
    kw = dict(max_len=4096, head_dim=128, theta=500000.0)
    t_sc = j_sc = None
    if scaling:
        j_sc = jl.RopeScaling(factor=8.0, original_max_len=1024)
        t_sc = tl.RopeScaling(factor=8.0, original_max_len=1024)
    got = tl.rope_table(scaling=t_sc, **kw).numpy()
    want = np.asarray(jl.rope_table(scaling=j_sc, **kw))
    assert got.dtype == np.float32 and got.shape == (4096, 64)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("per_lane", [False, True])
def test_apply_rope_matches_jax(dt, per_lane):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    table = np.asarray(jl.rope_table(64, 16, 10000.0))
    angles = np.array(table[[[3, 4, 5, 6, 7], [9, 10, 11, 12, 13]]]
                      if per_lane else table[3:8])
    jdt, tdt = _DT[dt]
    want = np.asarray(jl.apply_rope(jnp.asarray(x, jdt),
                                    jnp.asarray(angles)).astype(jnp.float32))
    got = tl.apply_rope(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(angles)).float().numpy()
    # f32: cos/sin of the same angles from two libms; bf16: then one
    # rounding of the result to bf16 on each side
    tol = 1e-6 if dt == "f32" else 8e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_matches_flax(dt):
    """flax RMSNorm(dtype=...) as llama uses it: f32 statistics, f32
    scale, result cast to dtype (bf16: one rounding each side)."""
    jdt, tdt = _DT[dt]
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((2, 4, 32))).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    want = fnn.RMSNorm(epsilon=1e-5, dtype=jdt).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x, jdt))
    norm = tl.RMSNorm(32, 1e-5, tdt)
    norm.scale.data.copy_(torch.from_numpy(scale))
    got = norm(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-6 if dt == "f32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# ------------------------------------------------------- paged decoder
def _models(dt, **kw):
    jdt, tdt = _DT[dt]
    jcfg = jl.tiny(dtype=jdt, **kw)
    jmodel = jl.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                         train=False)["params"]
    tcfg = tl.tiny(dtype=tdt, **kw)
    tmodel = tl.Llama.from_params(
        tcfg, bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, params)),
        device="cpu")
    return jcfg, jmodel, params, tcfg, tmodel


class _Pair:
    """One paged pool per package, driven call for call."""

    def __init__(self, dt, n_blocks, bs, **kw):
        (self.jcfg, self.jmodel, self.params, self.tcfg,
         self.tmodel) = _models(dt, **kw)
        self.jcache = jpg.init_block_pool(self.jcfg, n_blocks, bs)
        self.apply = jax.jit(
            lambda p, tok, cache, pos, table: self.jmodel.apply(
                {"params": p}, tok, cache=cache, cache_pos=pos,
                block_table=table, paged_kernel="gather"))
        self.tcache = tpg.init_block_pool(self.tcfg, n_blocks, bs,
                                          device="cpu")

    def __call__(self, tokens, pos, table):
        jpos = (jnp.asarray(pos, jnp.int32) if isinstance(pos, np.ndarray)
                else jnp.int32(pos))
        want, self.jcache = self.apply(self.params, jnp.asarray(tokens),
                                       self.jcache, jpos, jnp.asarray(table))
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        with torch.inference_mode():
            got = self.tmodel(torch.from_numpy(tokens), self.tcache, tpos,
                              torch.from_numpy(table))
        return got.numpy(), np.asarray(want)


# f32: the same algorithm on two BLAS libraries (2e-6 measured on O(1)
# logits).  bf16: every projection rounds to bf16 on both sides, but XLA
# and torch round at different points of their accumulations, so hidden
# states differ by bf16 ulps (2^-8 relative) that the f32 lm_head sums
# over d_model=64 inputs (0.04 measured on logits of magnitude ~4).
_LOGIT_TOL = {"f32": 1e-5, "bf16": 6e-2}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_forward_matches_jax(dt):
    """Two prompts prefill into their own blocks (one in two segments),
    then both lanes decode together, each at its own position (vector
    cache_pos), with every logit compared after every call."""
    pair = _Pair(dt, n_blocks=12, bs=4, max_len=64)
    rng = np.random.default_rng(2)
    table = np.array([[1, 2, 3, 4, 0, 0], [5, 6, 7, 8, 9, 0]], np.int32)
    p0 = rng.integers(0, 256, (1, 7)).astype(np.int32)
    p1 = rng.integers(0, 256, (1, 4)).astype(np.int32)
    tol = _LOGIT_TOL[dt]
    for tokens, pos, row in ((p0[:, :4], 0, 0), (p0[:, 4:], 4, 0),
                             (p1, 0, 1)):
        got, want = pair(tokens, pos, table[row:row + 1])
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    pos = np.array([7, 4], np.int32)
    tok = np.array([[int(p0[0, -1])], [int(p1[0, -1])]], np.int32)
    for _ in range(4):
        got, want = pair(tok, pos, table)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        tok = np.argmax(want[:, -1], axis=-1).astype(np.int32)[:, None]
        pos = pos + 1
    # every layer's pools hold the same K/V (scratch block aside)
    for jpools, tpools in zip(pair.jcache, pair.tcache):
        for jp, tp in zip(jpools, tpools):
            np.testing.assert_allclose(tp.float().numpy()[1:],
                                       np.asarray(jp.astype(jnp.float32))[1:],
                                       rtol=tol, atol=tol)


def test_rope_index_clamps_like_jax():
    """JAX clamps out-of-range gathers where torch would fault: a lane
    stepping past max_len (a finished lane running to its block edge)
    rotates by the table's last row, and a scalar start too close to
    max_len slides back to max_len - L (dynamic_slice_in_dim)."""
    pair = _Pair("f32", n_blocks=12, bs=4, max_len=16)
    rng = np.random.default_rng(3)
    table = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], np.int32)
    tokens = rng.integers(0, 256, (2, 3)).astype(np.int32)
    got, want = pair(tokens, 14, table)          # start 14 + 3 > 16
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pos = np.array([15, 18], np.int32)           # lane 1 past max_len
    got, want = pair(tokens[:, :1], pos, table)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sampling_helpers():
    """Greedy is jnp.argmax exactly (first maximum on ties); truncation
    masks match JAX's; sampling draws from the caller's generator."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    logits[1, 7] = logits[1, 9] = logits[1].max() + 1.0  # a tie
    t = torch.from_numpy(logits)
    assert tl._select_token(t, 0.0).tolist() == \
        np.asarray(jnp.argmax(jnp.asarray(logits), -1)).tolist()
    for top_k, top_p in ((5, 0.0), (0, 0.7), (10, 0.5)):
        got = tl._truncate_logits(t, 0.8, top_k, top_p).numpy()
        want = np.asarray(jl._truncate_logits(jnp.asarray(logits), 0.8,
                                              top_k, top_p))
        np.testing.assert_array_equal(got <= np.finfo(np.float32).min,
                                      want <= np.finfo(np.float32).min)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    draws = [tl._select_token(t, 1.0, torch.Generator().manual_seed(7),
                              top_k=5).tolist() for _ in range(2)]
    assert draws[0] == draws[1]
    kept = np.argsort(logits, -1)[:, -5:]
    assert all(d in kept[i] for i, d in enumerate(draws[0]))
    with pytest.raises(ValueError, match="generator"):
        tl._select_token(t, 1.0)
    with pytest.raises(ValueError, match="top_k"):
        tl.check_truncation(50, 51, 0.0)
    with pytest.raises(ValueError, match="top_p"):
        tl.check_truncation(50, 0, 1.5)
    assert tl.prefill_segments(10, 4) == jl.prefill_segments(10, 4)
    assert tl.prefill_segments(10, None) == jl.prefill_segments(10, None)


def test_config_factories_match_jax():
    for name in ("llama3_8b", "llama31_8b", "tiny"):
        want = dataclasses.asdict(getattr(jl, name)())
        got = dataclasses.asdict(getattr(tl, name)())
        for key, val in got.items():
            if key == "dtype":
                assert val == torch.bfloat16
            elif key == "rope_scaling" and val is not None:
                assert val == want[key]
            else:
                assert val == want[key], (name, key)
    with pytest.raises(NotImplementedError, match="sliding"):
        tl.Llama(tl.tiny(sliding_window=8))


def test_init_params_follow_flax_initializers():
    """Seeded random weights in the port's storage dtypes, with flax's
    default scales: lecun-normal per fan-in (the attention output
    contracts heads and head_dim), normal(1/sqrt(d_model)) for the
    embedding, ones for the norms.  Stds within 5 % over >= 64k draws."""
    cfg = tl.tiny(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                  vocab_size=512)
    sd = bridge.init_params(cfg, seed=0, device="cpu")
    again = bridge.init_params(cfg, seed=0, device="cpu")
    other = bridge.init_params(cfg, seed=1, device="cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["embed"], other["embed"])
    with torch.device("meta"):
        spec = tl.Llama(cfg).state_dict()
    assert {k: (v.shape, v.dtype) for k, v in sd.items()} == \
        {k: (v.shape, v.dtype) for k, v in spec.items()}
    assert sd["lm_head"].dtype == torch.float32
    assert sd["embed"].dtype == cfg.dtype
    fan_in = {"embed": 256, "lm_head": 256, "blocks.0.attn.wq": 256,
              "blocks.0.attn.out": 4 * 64, "blocks.0.mlp.wo": 512}
    for name, fan in fan_in.items():
        std = float(sd[name].float().std())
        assert abs(std * fan ** 0.5 - 1.0) < 0.05, (name, std)
    assert bool((sd["blocks.1.ln2.scale"] == 1).all())
    model = tl.Llama.from_params(cfg, sd, device="cpu")
    cache = tpg.init_block_pool(cfg, 2, 4, device="cpu")
    with torch.inference_mode():
        logits = model(torch.arange(6)[None], cache, 0,
                       torch.tensor([[1, 2]], dtype=torch.int32))
    assert logits.shape == (1, 6, 512) and bool(torch.isfinite(logits).all())


def test_params_from_jax_refuses_trees_it_does_not_map():
    cfg = tl.tiny()
    with pytest.raises(KeyError):
        bridge.params_from_jax(cfg, {"embed": {"embedding": np.zeros(
            (cfg.vocab_size, cfg.d_model), np.float32)}})
    with pytest.raises(ValueError, match="missing"):
        tl.Llama.from_params(cfg, {}, device="cpu")
