"""The port's zigzag layout (tf_operator_tpu_torch.ops.zigzag), ring
schedule and mesh sizing against the JAX package's: every function for
rings of 1 to 8 members, several shard lengths, windows and both
layouts.  Host arithmetic, so equality is exact."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops import zigzag as jzz
from tf_operator_tpu.parallel.mesh import local_mesh_axes as jaxes
from tf_operator_tpu_torch.ops import ring_attention as tra
from tf_operator_tpu_torch.ops import ring_flash as trf
from tf_operator_tpu_torch.ops import zigzag as tzz
from tf_operator_tpu_torch.parallel.mesh import local_mesh_axes

# the package re-exports functions under the modules' names
jra = importlib.import_module("tf_operator_tpu.ops.ring_attention")
jrf = importlib.import_module("tf_operator_tpu.ops.ring_flash")

S_LOCALS = (2, 16, 64, 200)
LAYOUTS = ("contiguous", "zigzag")


@pytest.mark.parametrize("n", range(1, 9))
def test_layout_functions_match_jax(n):
    assert tzz.chunk_ids(n) == jzz.chunk_ids(n)
    for s_local in S_LOCALS:
        s = n * s_local
        perm = tzz.storage_perm(n, s)
        np.testing.assert_array_equal(perm, jzz.storage_perm(n, s))
        assert perm.dtype == np.int32
        np.testing.assert_array_equal(tzz.inverse_perm(perm),
                                      jzz.inverse_perm(perm))
        x = np.arange(2 * s * 3, dtype=np.float32).reshape(2, s, 3)
        to = tzz.to_storage(torch.from_numpy(x), n)
        np.testing.assert_array_equal(to.numpy(),
                                      np.asarray(jzz.to_storage(x, n)))
        np.testing.assert_array_equal(
            tzz.from_storage(to, n).numpy(), x)
        np.testing.assert_array_equal(
            tzz.to_storage(torch.from_numpy(x[0]), n, axis=0).numpy(),
            np.asarray(jzz.to_storage(x[0], n, axis=0)))
        for idx in range(n):
            got = tzz.device_positions(idx, n, s_local)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jzz.device_positions(idx, n, s_local)))
            for layout in LAYOUTS:
                assert (tzz.member_intervals(idx, n, s_local, layout)
                        == jzz.member_intervals(idx, n, s_local, layout))
    with pytest.raises(ValueError, match="divisible"):
        tzz.storage_perm(n, 2 * n + 1)


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_live_steps_and_schedule_match_jax(n, layout):
    for s_local in S_LOCALS:
        for window in (None, 1, 8, s_local, 3 * s_local):
            for causal in (True, False):
                want = jzz.live_ring_steps(n, s_local, layout, window, causal)
                assert tzz.live_ring_steps(n, s_local, layout, window,
                                           causal) == want
                assert (tra.ring_schedule(n, s_local, layout, window, causal)
                        == jra.ring_schedule(n, s_local, layout, window,
                                             causal))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_positions_and_offsets_match_jax(n, layout):
    """The einsum ring's member positions, and the kernel ring's two
    half-chunk offsets, which map row r to the same global id."""
    for s_local in (16, 64, 200):
        for idx in range(n):
            pos = tra._positions(idx, n, s_local, layout)
            np.testing.assert_array_equal(
                pos.numpy(), np.asarray(jra._positions(idx, n, s_local,
                                                        layout)))
            off = trf.offsets(idx, n, s_local, layout)
            np.testing.assert_array_equal(
                np.asarray(off).reshape(2, 1),
                np.asarray(jrf._offsets(jnp.int32(idx), n, s_local, layout)))
            np.testing.assert_array_equal(
                trf._ids(off, s_local, "cpu").numpy(), pos.numpy())


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pair_liveness_is_exact(n, layout):
    """A (member, step) pair is live exactly when the global-position mask
    of its two shards has a visible entry."""
    s_local = 16
    for window in (None, 1, 8, 16, 48):
        for my in range(n):
            for src in range(n):
                qp = tra._positions(my, n, s_local, layout)[:, None]
                kp = tra._positions(src, n, s_local, layout)[None, :]
                mask = qp >= kp
                if window is not None:
                    mask &= kp > qp - window
                assert tzz.pair_live(my, src, n, s_local, layout, window) \
                    == bool(mask.any()), (my, src, window)
                assert tzz.pair_live(my, src, n, s_local, layout, window,
                                     causal=False)


@pytest.mark.parametrize("devices", [1, 2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
def test_local_mesh_axes_matches_jax(devices, tp):
    assert local_mesh_axes(devices, prefer_tp=tp) == jaxes(devices,
                                                           prefer_tp=tp)
