"""The training reference: the plain model and Adafactor driven through
the first steps of a run, and the readings the check compares.

Readings of a run of k steps (the program's or the reference's):
  - losses: the loss of each step;
  - grad_norms: each leaf's norm of the first step's gradient;
  - change_norms: each leaf's norm of (parameters after step k -
    parameters before step 1).
"""
from __future__ import annotations

import statistics
from typing import Callable, Dict, Iterable, List, Optional

import torch

from portbench.reference import llama as ref
from portbench.reference.adafactor import Adafactor


def run(cfg: dict, params: Dict[str, torch.Tensor],
        batches: List[torch.Tensor],
        initial_groups: Callable[[], Iterable[Dict[str, torch.Tensor]]],
        learning_rate: float, mm: Callable = ref.plain_mm,
        rows: Optional[slice] = None) -> dict:
    """Train `params` (float32 leaves, updated in place) for one step a
    batch ([B, S] token rows); `initial_groups()`
    yields the starting leaves again, group by group.  rows: the
    positions the loss averages over (a fault's half batch)."""
    ref.no_tf32()
    dims = ref.Dims(cfg)
    for p in params.values():
        p.requires_grad_(True)
    opt = Adafactor(learning_rate)
    losses, grad_norms = [], {}
    for i, batch in enumerate(batches):
        # the mean over the batch's rows, each row's own mean: the mean
        # over every labelled position, the rows being of one length
        loss = 0.0
        for tokens in batch:
            row = ref.lm_loss(params, tokens, dims, mm=mm, rows=rows) \
                / batch.shape[0]
            row.backward()
            loss += float(row.detach())
        losses.append(loss)
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(p.grad))
                          for k, p in params.items()}
        opt.step(params)
    return dict(losses=losses, grad_norms=grad_norms,
                change_norms=change_norms(params, initial_groups()))


@torch.no_grad()
def change_norms(params: Dict[str, torch.Tensor],
                 initial_groups: Iterable[Dict[str, torch.Tensor]]
                 ) -> Dict[str, float]:
    out = {}
    for group in initial_groups:
        for k, start in group.items():
            out[k] = float(torch.linalg.vector_norm(params[k].detach() - start))
        del group
    return out


def leaf_gap(prog: Dict[str, float], refn: Dict[str, float],
             keep: Iterable[str]) -> float:
    """The worst leaf's |prog - ref| over max(ref leaf, median ref leaf)."""
    keep = list(keep)
    med = statistics.median(refn[k] for k in keep)
    return max(abs(prog[k] - refn[k]) / max(refn[k], med) for k in keep)


def numbers(prog: dict, refr: dict, steps: int) -> Dict[str, float]:
    """The compared numbers: the largest gap of a step's loss; the worst
    leaf's gap of the first gradient's norm; and of the change's norm
    over the leaves whose reference gradient is not nought to rounding
    (at least a thousandth of the median leaf's)."""
    if len(prog["losses"]) < steps or len(refr["losses"]) < steps:
        raise ValueError("fewer steps read than compared")
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"][:steps],
                                              refr["losses"][:steps]))
    g = refr["grad_norms"]
    return dict(loss_gap=loss_gap,
                grad1_gap=leaf_gap(prog["grad_norms"], g, g.keys()),
                change_gap=leaf_gap(prog["change_norms"],
                                    refr["change_norms"], moved(refr)))


def moved(refr: dict) -> List[str]:
    """The leaves whose first reference gradient is at least a thousandth
    of the median leaf's: the others move under Adafactor by round-off
    alone."""
    g = refr["grad_norms"]
    med = statistics.median(g.values())
    return [k for k in g if g[k] >= 1e-3 * med]
