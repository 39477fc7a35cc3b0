"""Speculative decoding: the draft/verify round, and speculative_generate.

The port of tf_operator_tpu/models/speculative.py: `residual_sample`,
`make_spec_round` (as `spec_round`, over paged pools or dense rings),
the math serve_loop's speculative decode blocks run, and
`speculative_generate` with its per-model ring sizing `_spec_cache_len`.
A DRAFT model proposes k tokens with single-token steps; the TARGET
scores [last, d_1..d_k] in ONE (k+1)-token forward at each lane's own
position; the longest draft prefix the target agrees with is accepted,
plus one token of the target's own.  Over paged pools both models' pools
are routed by ONE block table: they cache the same logical positions, so
one allocation serves both (only the pools are per model).  Over dense
rings (table None) each model has its own ring, and a sliding-window
model's ring may be as small as window + k: the verify's per-row write
wraps modulo the ring, and every aliased slot lies outside the window.

  - the draft runs k+1 steps: the extra step's output is discarded, but
    its write records d_k's K/V at pos+k.  Without it a fully accepted
    round would leave a hole there that every later draft query attends.
  - rollback is free: a rejected round's writes past the accepted length
    sit at positions no query sees yet, and are overwritten before they
    become visible (the paged attention's position mask).
  - greedy (temperature 0): accept while the draft's argmax equals the
    target's; the emitted tokens equal target-only greedy decoding,
    whatever the draft.
  - sampling: both models' logits go through llama._truncate_logits
    (temperature, top_k, top_p) and the proposals are drawn from the
    draft's truncated distribution; d_i is accepted when u * p_d(d_i) <
    p_t(d_i), and at the first rejection the token is drawn from the
    residual norm(max(0, p_t - p_d)).  After k acceptances the padded
    draft row is all zeros, so the same residual draw is the bonus token,
    an exact draw from the target.  Random numbers come from the caller's
    torch.Generator, on the models' device: the draws are not JAX's
    (jax.random), the procedure is.

speculative_generate feeds the acceptance family (engine/metrics
SERVING_ACCEPTED_DRAFTS / SERVING_PROPOSED_DRAFTS, path
"speculative_generate") as the JAX package does.  Paged serving refuses
a sliding-window target or draft, as the JAX package does; dense
serving and speculative_generate take them.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.engine import metrics as _em
from tf_operator_tpu_torch.models import llama as _llama


def residual_probs(t_probs: torch.Tensor,
                   d_probs: torch.Tensor) -> torch.Tensor:
    """norm(max(0, p_target - p_draft)) over the last axis: the
    distribution of a rejected position's correction.  Where the residual
    is empty (identical distributions: unreachable in exact arithmetic,
    since rejection then has probability 0, but round-off can produce
    it) the target distribution itself."""
    res = torch.clamp(t_probs - d_probs, min=0.0)
    mass = res.sum(dim=-1, keepdim=True)
    return torch.where(mass > 0.0, res / torch.clamp(mass, min=1e-30),
                       t_probs)


def residual_sample(generator: torch.Generator, t_probs: torch.Tensor,
                    d_probs: torch.Tensor) -> torch.Tensor:
    """One draw per row [B, V] -> [B] from residual_probs.  A token of
    probability 0 is never drawn (JAX draws from log(max(p, 1e-30)),
    which leaves such a token a weight of 1e-30)."""
    return torch.multinomial(residual_probs(t_probs, d_probs), 1,
                             generator=generator)[:, 0]


def spec_round(target: _llama.Llama, draft: _llama.Llama, t_cache, d_cache,
               last: torch.Tensor, pos: torch.Tensor,
               table: Optional[torch.Tensor], k: int,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One speculation round for every lane, each at its own position.

    last [B]: each lane's latest token (not yet written); pos [B] int32:
    its position.  Both caches are written in place: block pools through
    `table` [B, T], or dense rings when table is None (each lane's
    verify write lands modulo its ring, so a ring smaller than the
    sequence wraps).  Returns (cand [B, k+1], n_acc [B], slot
    [B]): cand[:, :n_acc+1] are the lane's tokens for the round and
    slot == cand[:, n_acc] is its next `last`."""
    sampling = temperature > 0.0
    b = last.shape[0]
    tok, dpos = last, pos
    drafts, dprobs = [], []
    for step in range(k + 1):
        if step == k:
            # the extra step: its write records d_k, its output is unused
            draft(tok[:, None], d_cache, dpos, table, return_hidden=True)
            break
        lg = draft(tok[:, None], d_cache, dpos, table)[:, 0]
        if sampling:
            # truncate FIRST, then sample and keep softmax of the same
            # masked logits: the acceptance ratio needs the distribution
            # the proposal was drawn from
            probs = torch.softmax(
                _llama._truncate_logits(lg, temperature, top_k, top_p),
                dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            dprobs.append(probs)
        else:
            nxt = torch.argmax(lg, dim=-1)
        drafts.append(nxt)
        tok, dpos = nxt, dpos + 1
    drafts_t = torch.stack(drafts, dim=1)                      # [B, k]
    seq = torch.cat([last[:, None], drafts_t], dim=1)          # [B, k+1]
    t_logits = target(seq, t_cache, pos, table)                # [B, k+1, V]
    if sampling:
        tprobs = torch.softmax(
            _llama._truncate_logits(t_logits, temperature, top_k, top_p),
            dim=-1)
        dprobs_t = torch.stack(dprobs, dim=1)                  # [B, k, V]
        p_t = torch.gather(tprobs[:, :k], 2, drafts_t[..., None])[..., 0]
        p_d = torch.gather(dprobs_t, 2, drafts_t[..., None])[..., 0]
        u = torch.rand((b, k), generator=generator, device=p_t.device)
        accept = (u * torch.clamp(p_d, min=1e-30) < p_t).to(torch.long)
        n_acc = torch.cumprod(accept, dim=1).sum(dim=1)        # [B]
        # the lane's position n_acc: rejected there, the residual draw;
        # after k acceptances the padded draft row is zeros and the same
        # draw is the bonus token
        at = n_acc[:, None, None].expand(b, 1, tprobs.shape[-1])
        t_at = torch.gather(tprobs, 1, at)[:, 0]
        d_pad = torch.cat([dprobs_t, torch.zeros_like(dprobs_t[:, :1])],
                          dim=1)
        d_at = torch.gather(d_pad, 1, at)[:, 0]
        slot = residual_sample(generator, t_at, d_at)
    else:
        tpred = torch.argmax(t_logits, dim=-1)                 # [B, k+1]
        match = (drafts_t == tpred[:, :k]).to(torch.long)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)
        # the target's own token at the first disagreement
        slot = torch.gather(tpred, 1, n_acc[:, None])[:, 0]
    idx = torch.arange(k + 1, device=last.device)
    padded = torch.cat([drafts_t, drafts_t[:, :1]], dim=1)
    cand = torch.where(idx[None, :] < n_acc[:, None], padded, slot[:, None])
    return cand, n_acc, slot


def spec_block(target: _llama.Llama, draft: _llama.Llama, t_cache, d_cache,
               tok: torch.Tensor, pos: torch.Tensor, frozen: torch.Tensor,
               table: torch.Tensor, n_rounds: int, k: int,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               generator: Optional[torch.Generator] = None):
    """serve_loop's speculative decode block: n_rounds rounds for every
    lane.  Frozen lanes emit nothing (n_acc -1) and stay put; their
    writes land in the scratch block through their all-scratch table
    rows (dense rings, table None: in their own lane's rows, which the
    next admission's insert overwrites).  Returns (tok, pos, cands [n_rounds, B, k+1], n_accs
    [n_rounds, B]) on the device."""
    cands, n_accs = [], []
    for _ in range(n_rounds):
        cand, n_acc, slot = spec_round(target, draft, t_cache, d_cache, tok,
                                       pos, table, k, temperature, top_k,
                                       top_p, generator)
        n_acc = torch.where(frozen, -1, n_acc)
        tok = torch.where(frozen, tok, slot)
        pos = torch.where(frozen, pos, pos + n_acc.to(pos.dtype) + 1)
        cands.append(cand)
        n_accs.append(n_acc)
    return tok, pos, torch.stack(cands), torch.stack(n_accs)


def _spec_cache_len(name: str, cfg: _llama.LlamaConfig,
                    requested: Optional[int], total: int, k: int,
                    prompt_len: int, prefill_chunk: Optional[int]) -> int:
    """One model's dense ring length for speculative_generate, with JAX's
    refusals.  A full-causal model holds the whole sequence.  A
    sliding-window model may run a ring smaller than the sequence when
    C >= window + k: the (k+1)-position verify write's freshly written
    slot for position p aliases, to a query at q, as position p - C,
    outside q's window (worst case p = q + k), which also keeps a
    rejected round's stale slots invisible.  Default sizing and the
    streaming checks are llama's (chunk_align_cache,
    check_prefill_chunk)."""
    c = requested or total
    c = min(c, cfg.max_len)
    if requested is None and prefill_chunk is not None:
        c = _llama.chunk_align_cache(c, prefill_chunk, cfg.max_len)
    w = cfg.sliding_window
    if w is None:
        if c < total:
            raise ValueError(
                f"{name} cache_len {c} < {total} — a full-causal model "
                f"cannot stream past its cache (every position stays "
                f"visible)")
    elif c < total and c < w + k:
        raise ValueError(
            f"{name} cache_len {c} < window {w} + k {k}: a verify "
            f"round's k+1-position ring write would alias positions "
            f"its own queries still attend (grow the cache or "
            f"shrink k)")
    if prefill_chunk is None:
        if prompt_len > c:
            raise ValueError(
                f"prompt {prompt_len} exceeds {name} cache length {c} "
                f"(the prefill write must not wrap the ring; pass "
                f"prefill_chunk to stream a long prompt)")
    else:
        _llama.check_prefill_chunk(prefill_chunk, c, w,
                                   streams_past_cache=total > c,
                                   who=f"{name} ")
    return c


def speculative_generate(target: _llama.Llama, draft: _llama.Llama, prompt,
                         max_new_tokens: int, k: int = 4,
                         temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         eos_id: Optional[int] = None,
                         cache_len: Optional[int] = None,
                         draft_cache_len: Optional[int] = None,
                         target_transform=None, draft_transform=None,
                         prefill_chunk: Optional[int] = None,
                         kv_quant: bool = False,
                         top_k: int = 0, top_p: float = 0.0,
                         cache_sharding=None, draft_cache_sharding=None,
                         return_stats: bool = False,
                         device: Union[str, torch.device, None] = None):
    """Speculative decoding over dense rings: [B, max_new_tokens] int64
    tokens, each row advancing by its own accepted length (plus one) per
    target forward.  temperature 0 is greedy and gives
    llama.generate(target, ...)'s tokens whatever the draft; above 0,
    speculative sampling with `generator` (a torch.Generator on the
    device), every token a draw from the target's truncated (top_k,
    top_p) distribution.

    target/draft: port Llamas on `device` (default "cuda") sharing a
    vocabulary; k: draft tokens a round.  eos_id: once a row emits it,
    every later token is eos_id (a post-mask).  cache_len /
    draft_cache_len: each model's ring (default the whole sequence plus
    k+1 of verify headroom; a sliding-window model may take window + k,
    _spec_cache_len).  prefill_chunk streams the prompt into both rings.
    kv_quant: int8 rings for both.  target_transform / draft_transform:
    None or quant.make_dequantizer(cfg.dtype).  return_stats: also
    {"target_forwards", "accepted_drafts", "proposed_drafts"}, counting
    the rounds of rows still running.  cache_sharding /
    draft_cache_sharding: tensor-parallel speculation, each model placed
    by parallel/placement.shard_model and its rings by
    parallel/tp.kv_cache_sharding(its cfg, mesh, B), as llama.generate
    takes them; every rank returns one process's tokens and counts."""
    if target.cfg.vocab_size != draft.cfg.vocab_size:
        raise ValueError(
            f"target vocab {target.cfg.vocab_size} != draft vocab "
            f"{draft.cfg.vocab_size} — speculation compares token ids")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    _llama.check_truncation(target.cfg.vocab_size, top_k, top_p)
    if eos_id is not None and not 0 <= int(eos_id) < target.cfg.vocab_size:
        raise ValueError(
            f"eos_id {eos_id} out of range for vocab_size "
            f"{target.cfg.vocab_size}")
    _llama.check_transform("target_transform", target_transform, target)
    _llama.check_transform("draft_transform", draft_transform, draft)
    dev = resolve_device(device)
    _llama.check_model_device("target", target, dev)
    _llama.check_model_device("draft", draft, dev)
    if temperature <= 0.0:
        top_k, top_p = 0, 0.0  # greedy ignores truncation
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(dev)
    b, prompt_len = prompt.shape
    t_sh = _llama.cache_sharding_for("cache_sharding", target,
                                     cache_sharding, b)
    d_sh = _llama.cache_sharding_for("draft_cache_sharding", draft,
                                     draft_cache_sharding, b)
    if max_new_tokens < 0:
        raise ValueError(
            f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if max_new_tokens == 0:
        return torch.zeros((b, 0), dtype=torch.long, device=dev)
    total = prompt_len + max_new_tokens + k + 1  # verify-round headroom
    for name, cfg in (("target", target.cfg), ("draft", draft.cfg)):
        if total > cfg.max_len:
            raise ValueError(
                f"prompt {prompt_len} + new {max_new_tokens} (+{k + 1} "
                f"speculation headroom) exceeds {name} max_len "
                f"{cfg.max_len}")
    if prefill_chunk is not None:
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if prefill_chunk >= prompt_len:
            prefill_chunk = None  # one segment: the unchunked path
    c_t = _spec_cache_len("target", target.cfg, cache_len, total, k,
                          prompt_len, prefill_chunk)
    c_d = _spec_cache_len("draft", draft.cfg, draft_cache_len, total, k,
                          prompt_len, prefill_chunk)
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    t_cache = _llama.init_cache(target.cfg, b, c_t, kv_quant=kv_quant,
                                device=dev, sharding=t_sh)
    d_cache = _llama.init_cache(draft.cfg, b, c_d, kv_quant=kv_quant,
                                device=dev, sharding=d_sh)
    with torch.inference_mode():
        # both rings take every segment; the first token is the target's
        last_logits = _llama.stream_prefill(target, t_cache, prompt,
                                            prefill_chunk)
        for start, end, _ in _llama.prefill_segments(prompt_len,
                                                     prefill_chunk):
            _llama.chunk_write(draft, d_cache, prompt[:, start:end], start)
        first = _llama._select_token(last_logits, temperature, generator,
                                     top_k, top_p)
        out, n_fwd, acc_total, prop_total = _spec_loop(
            target, draft, t_cache, d_cache, first, prompt_len,
            max_new_tokens, k, temperature, top_k, top_p, generator)
    labels = {"path": "speculative_generate"}
    _em.SERVING_ACCEPTED_DRAFTS.inc(labels, acc_total)
    _em.SERVING_PROPOSED_DRAFTS.inc(labels, prop_total)
    if eos_id is not None:
        # from a row's first eos on, every token is eos
        seen = torch.cumsum((out == int(eos_id)).to(torch.int32), dim=1) > 0
        out = torch.where(seen, int(eos_id), out)
    if return_stats:
        return out, {"target_forwards": n_fwd,
                     "accepted_drafts": acc_total,
                     "proposed_drafts": prop_total}
    return out


def _spec_loop(target, draft, t_cache, d_cache, first: torch.Tensor,
               pos0: int, max_new: int, k: int, temperature: float,
               top_k: int, top_p: float, generator):
    """speculative_generate's rounds until every row holds max_new tokens:
    each row advances by its own accepted length; a row that is done
    freezes (its round still runs, its candidates land in the output's
    scratch column, its counts stop).  Returns (out [B, max_new],
    target forwards, accepted drafts, proposed drafts)."""
    b = first.shape[0]
    dev = first.device
    # k+1 columns of headroom: a round may write past max_new; the last
    # column is the done rows' scratch
    out = torch.zeros((b, max_new + k + 1), dtype=torch.long, device=dev)
    out[:, 0] = first
    n_out = torch.ones((b,), dtype=torch.long, device=dev)
    pos = torch.full((b,), pos0, dtype=torch.int32, device=dev)
    last = first
    rows = torch.arange(b, device=dev)[:, None]
    idx = torch.arange(k + 1, device=dev)[None, :]
    n_fwd = acc_total = prop_total = 0
    while bool((n_out < max_new).any()):
        done = n_out >= max_new
        cand, n_acc, slot = spec_round(target, draft, t_cache, d_cache, last,
                                       pos, None, k, temperature, top_k,
                                       top_p, generator)
        write_pos = torch.where(done[:, None], max_new + k, n_out[:, None] + idx)
        out[rows, write_pos] = cand
        n_emit = torch.where(done, 0, n_acc + 1)
        active = (~done).to(torch.long)
        n_out = n_out + n_emit
        pos = pos + n_emit.to(pos.dtype)
        last = torch.where(done, last, slot)
        n_fwd += 1
        acc_total += int((n_acc * active).sum())
        prop_total += k * int(active.sum())
    return out[:, :max_new], n_fwd, acc_total, prop_total
