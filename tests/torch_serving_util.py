"""Helpers shared by the port's prefix, handoff and window tests: the
tiny f32 models of both frameworks over one set of weights, prompts from
numpy, the numpy bridge of tensors (bf16 by its bits), the same block
pools built in both frameworks, and a handoff carried across the two
frameworks (the block table and the blake2b hashes are the wire
format)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tf_operator_tpu.models import llama as jl
from tf_operator_tpu.models import paging as jp
from tf_operator_tpu.models import quant as jq
from tf_operator_tpu.models.serving import KVHandoff as JaxHandoff
from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models import llama as tl
from tf_operator_tpu_torch.models import paging as tp
from tf_operator_tpu_torch.models import quant as tq
from tf_operator_tpu_torch.models.serving import KVHandoff


def port_model(params, **cfg_kw):
    """The port's tiny f32 Llama over the JAX package's (possibly
    int8-quantized) params; cfg_kw overrides the config (max_len 128
    unless given)."""
    tcfg = tl.tiny(**{"dtype": torch.float32, "max_len": 128, **cfg_kw})
    return tl.Llama.from_params(
        tcfg, bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, params)),
        device="cpu")


def tiny_models(**cfg_kw):
    """(JAX model, its params, the port's model over the same weights);
    cfg_kw overrides both configs alike (e.g. sliding_window)."""
    jmodel = jl.Llama(jl.tiny(**{"dtype": jnp.float32, "max_len": 128,
                                 **cfg_kw}))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                         train=False)["params"]
    return jmodel, params, port_model(params, **cfg_kw)


def int8_models(params, **cfg_kw):
    """The int8-weight side: (quantized params, the port's model over
    them, the keywords JAX's serve_loop takes to dequantize them)."""
    qp = jq.quantize_params(params)
    return qp, port_model(qp, **cfg_kw), dict(
        params_transform=jq.make_dequantizer(jnp.float32))


def schedule(results):
    """What a serve_loop run decided per request: tokens, the steps it
    went live and finished, its lane and its blocks."""
    return [(r.tokens, r.admitted_at_step, r.finished_at_step, r.slot,
             r.kv_blocks) for r in results]


def prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def pool_pair(kind, n=8, bs=4, kv=2, d=4, layers=2, seed=0):
    """The same pools as a JAX cache and a port cache (f32, bf16 or int8
    QTensor leaves), from one numpy draw."""
    rng = np.random.default_rng(seed)
    jcache, tcache = [], []
    for _ in range(layers):
        jpair, tpair = [], []
        for _ in range(2):
            x = rng.standard_normal((n + 1, bs, kv, d)).astype(np.float32)
            if kind == "int8":
                q = rng.integers(-127, 128, x.shape).astype(np.int8)
                sc = rng.random((n + 1, bs, kv, 1)).astype(np.float32)
                jpair.append(jq.QTensor(q=jnp.asarray(q),
                                        scale=jnp.asarray(sc)))
                tpair.append(tq.QTensor(q=to_torch(q), scale=to_torch(sc)))
            else:
                jx = jnp.asarray(x, jnp.bfloat16 if kind == "bf16"
                                 else jnp.float32)
                jpair.append(jx)
                tpair.append(to_torch(np.asarray(jx)))
        jcache.append(tuple(jpair))
        tcache.append(tuple(tpair))
    return jcache, tcache


# ------------------------------------------------ numpy bridge of the wire
def row_to_jax(row):
    """One payload row (per layer a (k, v) pair) as the JAX package's."""
    leaf = lambda t: (jq.QTensor(q=to_numpy(t.q), scale=to_numpy(t.scale))
                      if isinstance(t, tq.QTensor) else to_numpy(t))
    return [(leaf(k), leaf(v)) for k, v in row]


def row_to_port(row):
    leaf = lambda t: (tq.QTensor(q=to_torch(t.q), scale=to_torch(t.scale))
                      if isinstance(t, jq.QTensor) else to_torch(t))
    return [(leaf(k), leaf(v)) for k, v in row]


def _export_to(exp, mod, row_fn):
    if exp is None:
        return None
    return mod.BlockExport(exp.block_size, exp.hashes, exp.shared,
                           {h: row_fn(r) for h, r in exp.payload.items()},
                           exp.window)


def _convert(h, cls, mod, row_fn):
    fields = {f.name: getattr(h, f.name) for f in dataclasses.fields(h)}
    return cls(**dict(fields, export=_export_to(h.export, mod, row_fn)))


def handoff_to_jax(h: KVHandoff) -> JaxHandoff:
    """A port handoff as the JAX package's (its window dict as it is)."""
    return _convert(h, JaxHandoff, jp, row_to_jax)


def handoff_to_port(h: JaxHandoff) -> KVHandoff:
    return _convert(h, KVHandoff, tp, row_to_port)
