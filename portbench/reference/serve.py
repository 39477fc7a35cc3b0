"""The serving reference: the plain model run once over each sampled
prompt followed by the tokens the program served for it, and the gaps
the check compares.

The gap of a position is the reference's best logit there less the
reference's logit of the token in question.  Greedy serving puts its own
best token first, so a sound program reads only the gaps its rounding
makes; a control's gaps are those of the tokens a lower-precision model
puts first at the same positions.  The check compares the mean gap of
the served tokens (mean_gap); the widest gap is logged beside it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from portbench.reference import llama as ref
from portbench.reference.precision import int4_params


def layer_picker(params: Dict, transform: Callable = None):
    """layer_params(i) for sequence_logits: layer i's leaves, optionally
    transformed (int4 for the control)."""
    def pick(i: int) -> Dict:
        pre = f"blocks.{i}."
        lp = {k: v for k, v in params.items() if k.startswith(pre)}
        return transform(lp) if transform is not None else lp
    return pick


@torch.no_grad()
def logits(cfg: dict, params: Dict, prompts: Sequence[torch.Tensor],
           served: Sequence[Sequence[int]], control: bool = False,
           mm=ref.plain_mm) -> List[torch.Tensor]:
    """Float32 logits at the positions that chose each served token
    (the prompt's last position and each served token but the last);
    control=True: the int4 reference; mm: the products' precision."""
    ref.no_tf32()
    dims = ref.Dims(cfg)
    dev = prompts[0].device
    seqs, starts = [], []
    for p, toks in zip(prompts, served):
        toks = torch.as_tensor(list(toks)[:-1], dtype=p.dtype, device=dev)
        seqs.append(torch.cat([p, toks]))
        starts.append(p.shape[0] - 1)
    top = {k: v for k, v in params.items() if not k.startswith("blocks.")}
    if control:
        top = int4_params(top)
    return ref.sequence_logits(
        top, seqs, starts, dims,
        layer_picker(params, int4_params if control else None), mm=mm)


def gaps(ref_logits: Sequence[torch.Tensor],
         tokens: Sequence[Sequence[int]]) -> List[float]:
    """The gap of every token: the reference's best logit at its
    position less the reference's logit of the token."""
    out = []
    for lg, toks in zip(ref_logits, tokens):
        t = torch.as_tensor(list(toks), device=lg.device)
        out += (lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]).tolist()
    return out


def first_choices(lg: Sequence[torch.Tensor]) -> List[List[int]]:
    """The token each position of these logits puts first."""
    return [x.argmax(dim=-1).tolist() for x in lg]
