"""Speculative decoding over paged pools: the draft/verify round.

The port of tf_operator_tpu/models/speculative.py's `residual_sample` and
`make_spec_round` (paged=True), the math serve_loop's speculative decode
blocks run.  A DRAFT model proposes k tokens with single-token steps; the
TARGET scores [last, d_1..d_k] in ONE (k+1)-token forward at each lane's
own position; the longest draft prefix the target agrees with is
accepted, plus one token of the target's own.  Both models' pools are
routed by ONE block table: they cache the same logical positions, so one
allocation serves both (only the pools are per model).

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

Dense `speculative_generate` (speculative.py:353 of the JAX package, over
the dense ring cache) is not ported: it waits for ROADMAP item 7, dense
mode.  Neither is a sliding-window target or draft: serve_loop refuses
it, as the JAX package does under paging.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

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
               last: torch.Tensor, pos: torch.Tensor, table: torch.Tensor,
               k: int, temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One speculation round for every lane, each at its own position.

    last [B]: each lane's latest token (not yet written); pos [B] int32:
    its position.  Both pools are written in place through `table`
    [B, T].  Returns (cand [B, k+1], n_acc [B], slot [B]):
    cand[:, :n_acc+1] are the lane's tokens for the round and slot ==
    cand[:, n_acc] is its next `last`."""
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
    rows.  Returns (tok, pos, cands [n_rounds, B, k+1], n_accs
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
