"""The port's lattice tables and calculus operators against the JAX package.

Integer forms must match bit for bit, float64 forms to 1e-12.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from supervillain_tpu.ops import Lattice as JaxLattice, calculus as jcalc
from supervillain_tpu_torch.ops import Lattice, calculus as tcalc

GEOMETRIES = [(2, 2), (2, 4), (2, 5), (2, 6), (3, 3), (3, 4)]
OPERATORS = {
    'd': lambda D: range(0, D),
    'delta': lambda D: range(1, D + 1),
    'face_sum': lambda D: range(1, D + 1),
    'coface_sum': lambda D: range(0, D),
}


@pytest.mark.parametrize('D,N', GEOMETRIES)
def test_lattice_tables_match_jax(D, N):
    ours, ref = Lattice(D, N), JaxLattice(D, N)
    assert ours.dims == ref.dims and ours.sites == ref.sites and ours.links == ref.links
    assert all(ours.form_shape(p) == ref.form_shape(p) for p in range(D + 1))
    np.testing.assert_array_equal(ours.coords, ref.coords)
    np.testing.assert_array_equal(ours.checkerboard_masks, ref.checkerboard_masks)
    assert ours.n_colors == ref.n_colors
    for op in OPERATORS:
        for p in OPERATORS[op](D):
            assert ours.operator_table(op, p) == ref.operator_table(op, p)
    for color in range(ours.n_colors):
        mask = ours.mask(color, 'cpu')
        assert mask.dtype == torch.bool
        np.testing.assert_array_equal(mask.numpy(), ref.checkerboard_masks[color])


@pytest.mark.parametrize('op', sorted(OPERATORS))
@pytest.mark.parametrize('D,N', GEOMETRIES)
def test_operators_match_jax(op, D, N):
    rng = np.random.default_rng([D, N, sorted(OPERATORS).index(op)])
    ours, ref = Lattice(D, N), JaxLattice(D, N)
    for p in OPERATORS[op](D):
        ints = rng.integers(-5, 6, size=ours.form_shape(p))
        floats = rng.normal(size=ours.form_shape(p))
        got_i = getattr(tcalc, op)(ours, p, torch.as_tensor(ints)).numpy()
        want_i = np.asarray(getattr(jcalc, op)(ref, p, jnp.asarray(ints)))
        assert got_i.dtype.kind == 'i'
        np.testing.assert_array_equal(got_i, want_i)
        got_f = getattr(tcalc, op)(ours, p, torch.as_tensor(floats)).numpy()
        want_f = np.asarray(getattr(jcalc, op)(ref, p, jnp.asarray(floats)))
        np.testing.assert_allclose(got_f, want_f, rtol=0, atol=1e-12)


@pytest.mark.parametrize('op', sorted(OPERATORS))
def test_operators_batch_over_leading_axes(op):
    """A batch of forms gives each form's result (the chain axis of the port)."""
    rng = np.random.default_rng(7)
    L = Lattice(2, 4)
    p = min(OPERATORS[op](2))
    batch = torch.as_tensor(rng.integers(-3, 4, size=(3,) + L.form_shape(p)))
    fn = getattr(tcalc, op)
    together = fn(L, p, batch)
    for b in range(3):
        torch.testing.assert_close(together[b], fn(L, p, batch[b]), rtol=0, atol=0)
