"""The two public functions of the JAX package the port gained last:
``core.histogram.weighted_membership`` and ``kernels.ops.spatial_step``
(one FCM_S v -> v' iteration; the JAX side's Pallas kernel in interpret
mode), on the same seeded inputs, within the port's rtol 1e-5 / atol
1e-6."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import histogram as JH
from repro.kernels import ops as JOPS
from repro_torch.core import histogram as TH
from repro_torch.kernels import ops as TOPS


def test_weighted_membership_matches_jax():
    rng = np.random.default_rng(0)
    vals = np.arange(256, dtype=np.float32)
    v = np.sort(rng.uniform(0, 255, 4)).astype(np.float32)
    want = np.asarray(JH.weighted_membership(jnp.asarray(vals),
                                             jnp.asarray(v), 2.0))
    got = TH.weighted_membership(torch.from_numpy(vals), torch.from_numpy(v),
                                 2.0).numpy()
    assert got.shape == want.shape == (4, 256)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,neighbors", [((9, 11), 4), ((9, 11), 8),
                                             ((3, 5, 6), 6)])
def test_spatial_step_matches_jax(shape, neighbors):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    v = np.array([20.0, 90.0, 160.0, 230.0], np.float32)
    want = np.asarray(JOPS.spatial_step(jnp.asarray(img), jnp.asarray(v),
                                        neighbors=neighbors, block_rows=8,
                                        interpret=True))
    got = TOPS.spatial_step(torch.from_numpy(img), torch.from_numpy(v),
                            neighbors=neighbors).numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
