"""Checkpoint import and export: Hugging Face LLaMA/Mixtral weights.

The port's copy of tf_operator_tpu/models/convert.py (numpy only, so the
copy differs in the config it builds, the port's LlamaConfig, and in
`params_from_hf`, its bridge to the port's state dict).  A
`LlamaForCausalLM` or `MixtralForCausalLM` state dict (torch tensors or
numpy arrays) converts into the JAX package's flax parameter tree of
numpy arrays, which models/bridge.params_from_jax maps onto the port's
names; `export_hf_llama` is the inverse.

Convention notes (the silent-wrongness traps this module exists to
avoid):
- RoPE pairing: transformers' LLaMA stores q/k already permuted for the
  split-halves (rotate_half) convention, the one models/llama.apply_rope
  implements, so q/k need no head-dim permutation here.  (Original Meta
  checkpoints use interleaved pairs; convert them to HF format first.)
- torch nn.Linear stores [out_features, in_features]; the flax layouts
  are [in, ...out...], so every projection transposes.
- GQA: HF k/v carry the compact KV head count, as models/llama does.
- Mixtral: each expert's w1 (gate) and w3 (up) pack into the raw
  [X, D, 2F] wi, gate first; w2 (down) into [X, F, D] wo; the router
  (`block_sparse_moe.gate`) is the f32 [D, X] router kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from tf_operator_tpu_torch.models import bridge
from tf_operator_tpu_torch.models.llama import LlamaConfig, RopeScaling


def _np(x) -> np.ndarray:
    """torch tensor (any float dtype, bf16 included) / np array ->
    float32 numpy (params live f32; the model casts to cfg.dtype at
    use)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def config_from_hf(hf_config: Any, **overrides) -> LlamaConfig:
    """Derive the matching LlamaConfig from a `transformers.LlamaConfig`
    (object or its to_dict()). Hand-building the config invites silent
    numeric drift — e.g. transformers defaults rms_norm_eps to 1e-6 while
    LlamaConfig defaults norm_eps to 1e-5, a mismatch that skews logits
    by ~1% and is invisible to every shape check."""
    d = hf_config if isinstance(hf_config, dict) else hf_config.to_dict()
    # map what models/llama.py reproduces; refuse the rest — importing
    # anyway would pass every shape check and silently produce wrong
    # logits, the exact trap this helper exists to close
    rope_scaling = None
    rs = d.get("rope_scaling")
    if rs is not None:
        kind = rs.get("rope_type") or rs.get("type")
        if kind != "llama3":
            raise ValueError(
                f"rope_scaling type {kind!r} is not supported "
                f"(models/llama.rope_table implements plain RoPE and the "
                f"llama3 frequency-dependent scaling); importing a "
                f"{kind!r}-scaled checkpoint would decode with silently "
                f"wrong rotations")
        rope_scaling = RopeScaling(
            factor=float(rs["factor"]),
            low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            original_max_len=int(
                rs.get("original_max_position_embeddings", 8192)),
        )
    act = d.get("hidden_act", "silu")
    if act not in ("silu", "swish"):
        raise ValueError(
            f"hidden_act={act!r} is not supported (the SwiGLU MLP is "
            f"silu-gated)")
    base = dict(
        vocab_size=d["vocab_size"],
        d_model=d["hidden_size"],
        n_heads=d["num_attention_heads"],
        n_kv_heads=d.get("num_key_value_heads") or d["num_attention_heads"],
        n_layers=d["num_hidden_layers"],
        d_ff=d["intermediate_size"],
        max_len=d["max_position_embeddings"],
        rope_theta=float(d.get("rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        norm_eps=float(d.get("rms_norm_eps", 1e-6)),
        tie_embeddings=bool(d.get("tie_word_embeddings", False)),
        sliding_window=d.get("sliding_window"),
    )
    if d.get("num_local_experts"):
        # MixtralConfig: sparse FFN in every block, top-k routing
        base.update(
            n_experts=int(d["num_local_experts"]),
            moe_top_k=int(d.get("num_experts_per_tok", 2)),
            moe_every=1,
        )
    base.update(overrides)
    return LlamaConfig(**base)


def import_hf_llama(state_dict: Mapping[str, Any],
                    cfg: LlamaConfig) -> Dict:
    """HF `LlamaForCausalLM.state_dict()` (or `MixtralForCausalLM` when
    cfg.n_experts > 0) -> params for `models.llama.Llama(cfg)`. Shapes
    are validated against cfg; missing or extra keys raise with the
    offending name."""
    e, h, kv, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sd = dict(state_dict)

    def take(name: str, shape) -> np.ndarray:
        if name not in sd:
            raise KeyError(f"checkpoint is missing {name!r}")
        x = _np(sd.pop(name))
        if tuple(x.shape) != tuple(shape):
            raise ValueError(
                f"{name}: checkpoint shape {tuple(x.shape)} != expected "
                f"{tuple(shape)} for this LlamaConfig")
        return x

    params: Dict[str, Any] = {
        "embed": {
            "embedding": take("model.embed_tokens.weight",
                              (cfg.vocab_size, e)),
        },
        "ln_f": {"scale": take("model.norm.weight", (e,))},
    }
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        wq = take(p + "self_attn.q_proj.weight", (h * d, e))
        wk = take(p + "self_attn.k_proj.weight", (kv * d, e))
        wv = take(p + "self_attn.v_proj.weight", (kv * d, e))
        wo = take(p + "self_attn.o_proj.weight", (e, h * d))
        block: Dict[str, Any] = {
            "ln1": {"scale": take(p + "input_layernorm.weight", (e,))},
            "ln2": {"scale": take(
                p + "post_attention_layernorm.weight", (e,))},
            "attn": {
                # [out, in] -> [in, heads, head_dim]
                "wq": {"kernel": wq.T.reshape(e, h, d)},
                # fused [E, 2, KV, D]: k then v, the wkv slot order
                "wkv": {"kernel": np.stack(
                    [wk.T.reshape(e, kv, d), wv.T.reshape(e, kv, d)],
                    axis=1)},
                # o_proj [E, H*D] -> [heads, head_dim, E]
                "out": {"kernel": wo.T.reshape(h, d, e)},
            },
        }
        use_moe = (cfg.n_experts > 0
                   and i % cfg.moe_every == cfg.moe_every - 1)
        if use_moe:
            # Mixtral sparse block: per-expert w1 (gate) / w3 (up) / w2
            # (down) fold into the packed [X, D, 2F] wi and [X, F, D] wo
            # that MoeSwiGlu reads (gate occupies the first F columns —
            # _expert_ffn splits the last dim in that order)
            mp = p + "block_sparse_moe."
            router = take(mp + "gate.weight", (cfg.n_experts, e))
            wi = np.empty((cfg.n_experts, e, 2 * cfg.d_ff), np.float32)
            wo_e = np.empty((cfg.n_experts, cfg.d_ff, e), np.float32)
            for j in range(cfg.n_experts):
                xp = mp + f"experts.{j}."
                wi[j, :, :cfg.d_ff] = take(
                    xp + "w1.weight", (cfg.d_ff, e)).T
                wi[j, :, cfg.d_ff:] = take(
                    xp + "w3.weight", (cfg.d_ff, e)).T
                wo_e[j] = take(xp + "w2.weight", (e, cfg.d_ff)).T
            block["moe"] = {
                "router": {"kernel": router.T},
                "wi": wi,
                "wo": wo_e,
            }
        else:
            gate = take(p + "mlp.gate_proj.weight", (cfg.d_ff, e))
            up = take(p + "mlp.up_proj.weight", (cfg.d_ff, e))
            down = take(p + "mlp.down_proj.weight", (e, cfg.d_ff))
            block["mlp"] = {
                # SwiGLU gate+up packed [E, 2, F]
                "wi": {"kernel": np.stack([gate.T, up.T], axis=1)},
                "wo": {"kernel": down.T},
            }
        params[f"block{i}"] = block
    if cfg.tie_embeddings:
        # tied checkpoints either omit lm_head or alias it to the embedding
        lm_w = sd.pop("lm_head.weight", None)
        if lm_w is not None and not np.array_equal(
                _np(lm_w), params["embed"]["embedding"]):
            raise ValueError(
                "cfg.tie_embeddings=True but the checkpoint's lm_head "
                "differs from its embedding — convert with an untied cfg")
    else:
        params["lm_head"] = {
            "kernel": take("lm_head.weight", (cfg.vocab_size, e)).T,
        }
    # rotary tables are derived, not stored; buffers like
    # model.rotary_emb.inv_freq may ride along in older dumps
    leftover = [k for k in sd if "rotary" not in k and "inv_freq" not in k]
    if leftover:
        raise ValueError(
            f"unconsumed checkpoint keys (wrong config?): {leftover[:5]}")
    return params


def export_hf_llama(params: Mapping[str, Any],
                    cfg: LlamaConfig) -> Dict[str, np.ndarray]:
    """The inverse: flax params -> an HF `LlamaForCausalLM` (or, when
    cfg.n_experts > 0, `MixtralForCausalLM`) state dict (numpy f32), so
    models trained or LoRA-merged here deploy on any HF-compatible
    stack. Exact inverse of import_hf_llama (tests/test_torch_convert.py
    proves the roundtrip and that transformers itself accepts and
    reproduces the exported weights)."""
    if cfg.n_experts and cfg.moe_every != 1:
        raise ValueError(
            f"export of interleaved-MoE configs (moe_every="
            f"{cfg.moe_every}) is not supported: MixtralForCausalLM has "
            f"experts in EVERY layer; a mixed dense/sparse stack matches "
            f"no HF architecture")
    e, h, kv, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sd: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _np(params["embed"]["embedding"]),
        "model.norm.weight": _np(params["ln_f"]["scale"]),
    }
    for i in range(cfg.n_layers):
        blk = params[f"block{i}"]
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = _np(blk["ln1"]["scale"])
        sd[p + "post_attention_layernorm.weight"] = _np(blk["ln2"]["scale"])
        wkv = _np(blk["attn"]["wkv"]["kernel"])  # [E, 2, KV, D]
        sd[p + "self_attn.q_proj.weight"] = (
            _np(blk["attn"]["wq"]["kernel"]).reshape(e, h * d).T)
        sd[p + "self_attn.k_proj.weight"] = wkv[:, 0].reshape(e, kv * d).T
        sd[p + "self_attn.v_proj.weight"] = wkv[:, 1].reshape(e, kv * d).T
        sd[p + "self_attn.o_proj.weight"] = (
            _np(blk["attn"]["out"]["kernel"]).reshape(h * d, e).T)
        if "moe" in blk:
            mp = p + "block_sparse_moe."
            sd[mp + "gate.weight"] = _np(blk["moe"]["router"]["kernel"]).T
            wi_e = _np(blk["moe"]["wi"])       # [X, E, 2F] gate||up
            wo_e = _np(blk["moe"]["wo"])       # [X, F, E]
            f = wi_e.shape[-1] // 2
            for j in range(wi_e.shape[0]):
                xp = mp + f"experts.{j}."
                sd[xp + "w1.weight"] = wi_e[j, :, :f].T
                sd[xp + "w3.weight"] = wi_e[j, :, f:].T
                sd[xp + "w2.weight"] = wo_e[j].T
        else:
            wi = _np(blk["mlp"]["wi"]["kernel"])  # [E, 2, F]
            sd[p + "mlp.gate_proj.weight"] = wi[:, 0].T
            sd[p + "mlp.up_proj.weight"] = wi[:, 1].T
            sd[p + "mlp.down_proj.weight"] = _np(blk["mlp"]["wo"]["kernel"]).T
    if cfg.tie_embeddings:
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    else:
        sd["lm_head.weight"] = _np(params["lm_head"]["kernel"]).T
    return sd


def params_from_hf(state_dict: Mapping[str, Any], cfg: LlamaConfig,
                   train: bool = False) -> Dict[str, Any]:
    """The port's state dict (CPU tensors, serving storage dtypes or
    train=True f32) from an HF state dict: import_hf_llama's tree through
    models/bridge.params_from_jax."""
    return bridge.params_from_jax(cfg, import_hf_llama(state_dict, cfg),
                                  train=train)
