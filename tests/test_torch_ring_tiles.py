"""The rule by which the ring's kernels skip tiles and drop the
per-element mask (`span_live`, `span_full` in csrc/ring_flash.cu, mirrored
in ops/ring_flash.py), held against the mask itself (`_mask`) for every
(member, resident shard) of rings of 2 and 4, both layouts, windows
None/64/512 and S_l in {512, 256, 200, 192}: S_l = 200 puts the half
(100) inside a 64-row tile, and 192 puts it on a 32-row edge.

The spans are the ones the kernels test: 64 x 64 (the scalar kernels'
tiles, K3q's blocks and K3kv's units), 64 q rows x 32 keys (K3q's
score products), 16 q rows x 32 keys (K3q's `full`, per warp) and 64 q
rows x 16 kv rows (K3kv's `full`, per warp).  No span holding a visible
pair may be skipped, and no span taken as full may hold a hidden pair;
spans inside one half-chunk are judged exactly, so no work is wasted
there either.

The tensor-core K3f's (and K3q's) map from (block, warpgroup) to (q tile,
query head), mirrored by `fwd_units`, must cover every (q tile, head) of
a step exactly once: a unit no warpgroup takes would silently keep its
carry as it was.
"""
import numpy as np
import pytest

from tf_operator_tpu_torch.ops import ring_flash as trf

SPANS = [(64, 64), (64, 32), (16, 32), (64, 16)]


def _straddles(lo, hi, s):
    return lo < s // 2 <= min(hi, s - 1)


@pytest.mark.parametrize("s", [512, 256, 200, 192])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
@pytest.mark.parametrize("n", [2, 4])
def test_span_rule_matches_the_mask(n, layout, s):
    checked = exact = 0
    for window in (None, 64, 512):
        for my in range(n):
            for src in range(n):
                q_off = trf.offsets(my, n, s, layout)
                k_off = trf.offsets(src, n, s, layout)
                mask = trf._mask(q_off, k_off, s, True, window,
                                 "cpu").numpy()
                for tq, tk in SPANS:
                    for q_lo in range(0, s, tq):
                        for k_lo in range(0, s, tk):
                            q_hi, k_hi = q_lo + tq - 1, k_lo + tk - 1
                            sub = mask[q_lo:q_hi + 1, k_lo:k_hi + 1]
                            args = (q_lo, q_hi, k_lo, k_hi, q_off, k_off, s,
                                    True, window)
                            live = trf.span_live(*args)
                            full = trf.span_full(*args)
                            where = (f"ring {n} {layout} S_l={s} "
                                     f"window={window} member={my} "
                                     f"resident={src} q {q_lo}..{q_hi} "
                                     f"k {k_lo}..{k_hi}")
                            assert live or not sub.any(), where
                            assert not full or (
                                sub.shape == (tq, tk) and sub.all()), where
                            checked += 1
                            if not (_straddles(q_lo, q_hi, s)
                                    or _straddles(k_lo, k_hi, s)):
                                assert live == bool(sub.any()), where
                                inside = q_hi < s and k_hi < s
                                assert full == (inside and bool(sub.all())), \
                                    where
                                exact += 1
    # spans straddle the half exactly where it is not on a 64-row edge
    assert exact > 0 and (checked > exact) == ((s // 2) % 64 != 0)


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_span_rule_without_a_mask(layout):
    """Non-causal: every span inside S is live and full; a span past S
    is dead, and one reaching past it is never full."""
    s = 200
    off = trf.offsets(1, 4, s, layout)
    for q_lo in range(0, s + 64, 64):
        for k_lo in range(0, s + 32, 32):
            args = (q_lo, q_lo + 63, k_lo, k_lo + 31, off, off, s, False)
            assert trf.span_live(*args) == (q_lo < s and k_lo < s)
            assert trf.span_full(*args) == (q_lo + 63 < s and k_lo + 31 < s)


def test_contiguous_diagonal_skips_the_future_tiles():
    """The causal diagonal of S_l = 512: the 28 tiles of 64 x 64 above
    it are skipped, the 28 below it run without the per-element mask,
    and the 8 on it take the mask."""
    s = 512
    off = trf.offsets(2, 4, s, "contiguous")
    tiles = [(qt, kt) for qt in range(8) for kt in range(8)]
    args = lambda qt, kt: (64 * qt, 64 * qt + 63, 64 * kt, 64 * kt + 63,
                           off, off, s, True)
    live = np.array([trf.span_live(*args(*t)) for t in tiles]).reshape(8, 8)
    full = np.array([trf.span_full(*args(*t)) for t in tiles]).reshape(8, 8)
    assert (live == np.tril(np.ones((8, 8), bool))).all()
    assert (full == np.tril(np.ones((8, 8), bool), -1)).all()


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("h,kv", [(32, 8), (4, 2), (8, 8), (6, 2)])
@pytest.mark.parametrize("s", [512, 256, 200, 192, 90, 48])
def test_fwd_units_cover_every_q_tile_and_head_once(s, h, kv, groups):
    units = trf.fwd_units(s, h, kv, groups)
    n_t = -(-s // 64)
    taken = sorted((qt, head) for _, _, qt, head in units)
    assert taken == [(qt, head) for qt in range(n_t) for head in range(h)]
    # the launcher's grid: ceil(n_t G / groups) blocks per kv head; each
    # (block, warpgroup) holds at most one unit, and a block's units share
    # one kv head, so its K and V tiles serve all of them
    blocks = -(-(n_t * (h // kv)) // groups) * kv
    assert {x for x, _, _, _ in units} == set(range(blocks))
    assert len({(x, wg) for x, wg, _, _ in units}) == len(units)
    assert all(0 <= wg < groups and head // (h // kv) == x % kv
               for x, wg, _, head in units)
    # heaviest first: the q tiles of the blocks in launch order never rise
    first = [qt for _, wg, qt, _ in units if wg == 0]
    assert first == sorted(first, reverse=True)
