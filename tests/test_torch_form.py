"""The port's host-tier ``Form``, the ``supervillain_tpu_torch.lattice``
namespace and the sparse-operator functions, after ``tests/test_form.py`` and
the sparse case of ``tests/test_calculus.py``: Form semantics held against the
JAX package's Form on the same data (interlaced layouts and incidence sums bit
for bit on integer forms, float64 to 1e-12), and the sparse functions against
the port's dense operators, bit for bit."""

from math import comb

import numpy as np
import pytest
import torch

import supervillain_tpu as jsv
from supervillain_tpu.lattice import Form as JaxForm
from supervillain_tpu_torch import lattice as tl
from supervillain_tpu_torch.lattice import Form, d, delta, laplacian, star, wedge
from supervillain_tpu_torch.ops import Lattice, calculus

TOL = 1e-12


@pytest.fixture(params=[(2, 4), (2, 5), (3, 3), (4, 3)], ids=lambda dn: f'D{dn[0]}N{dn[1]}')
def lattices(request):
    D, N = request.param
    return Lattice(D, N), jsv.Lattice(D, N)


def random_form(lattice, p, rng, integer=False):
    shape = lattice.form_shape(p)
    return lattice.form(p, rng.integers(-4, 5, shape) if integer else rng.standard_normal(shape))


def test_factory_and_metadata(lattices):
    L, _ = lattices
    for p in range(L.D + 1):
        f = L.form(p)
        assert isinstance(f, Form) and f.degree == p and f.lattice is L
        assert f.shape == Form.spatial_shape(degree=p, lattice=L)
        assert not f.any()
    with pytest.raises(ValueError, match='degree-2'):
        Form(np.zeros(L.form_shape(1) if comb(L.D, 1) != comb(L.D, 2) else (7,)), degree=2,
             lattice=L)


def test_same_degree_ufuncs_rewrap_and_slices_unwrap(lattices):
    L, _ = lattices
    rng = np.random.default_rng(1)
    a, b = random_form(L, 1, rng), random_form(L, 1, rng)
    for result in (a + b, a * b, -a, np.abs(a), a ** 2, np.isclose(a, b), a == b, 2.0 * a):
        assert isinstance(result, Form) and result.degree == 1 and result.lattice is L
    total = a.sum()
    assert np.isscalar(total) or total.shape == ()
    s = a[0] + a[0]
    assert type(s) is np.ndarray and s.shape == L.dims


def test_component_view_writes_back(lattices):
    L, _ = lattices
    f = random_form(L, 2, np.random.default_rng(3))
    np.testing.assert_array_equal(f.component(0, 1), f.component((1, 0)))
    f.component(0, 1)[...] = 7.0
    assert (np.asarray(f)[L.comp_index[2][(0, 1)]] == 7.0).all()


@pytest.mark.parametrize('integer', [True, False], ids=['int', 'f64'])
def test_interlaced_and_incidence_sums_match_jax(lattices, integer):
    L, JL = lattices
    rng = np.random.default_rng(4)
    for p in range(L.D + 1):
        f = random_form(L, p, rng, integer)
        ref = JL.form(p, np.asarray(f))
        F = f.to_interlaced()
        np.testing.assert_array_equal(F, ref.to_interlaced())
        np.testing.assert_array_equal(np.asarray(Form.from_interlaced(p, F)), np.asarray(f))
        assert Form.from_interlaced(p, F).lattice == L
        for name in ('face_sum', 'coface_sum'):
            ours, theirs = getattr(f, name)(), getattr(ref, name)()
            if isinstance(theirs, int):
                assert ours == theirs == 0
                continue
            assert isinstance(ours, Form) and ours.degree == theirs.degree
            if integer:
                np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
            else:
                np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=TOL,
                                           atol=TOL)


def test_namespace_form_convention_matches_jax(lattices):
    L, JL = lattices
    from supervillain_tpu import lattice as jl
    rng = np.random.default_rng(6)
    a, b = random_form(L, 0, rng, True), random_form(L, 1, rng, True)
    ja, jb = JL.form(0, np.asarray(a)), JL.form(1, np.asarray(b))
    pairs = [(d(a), jl.d(ja)), (delta(b), jl.delta(jb)), (laplacian(b), jl.laplacian(jb)),
             (star(b), jl.star(jb)), (wedge(a, b), jl.wedge(ja, jb))]
    for ours, theirs in pairs:
        assert isinstance(ours, Form) and ours.degree == theirs.degree
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    # The tensor convention through the same names, on the tensor's device.
    t = torch.as_tensor(np.asarray(a))
    assert torch.equal(d(L, 0, t), calculus.d(L, 0, t))
    assert d(L.form(L.D)) == 0 and delta(L.form(0)) == 0
    with pytest.raises(TypeError):
        d(np.zeros(L.form_shape(0)))
    with pytest.raises(TypeError):
        wedge(np.zeros(L.form_shape(0)), np.zeros(L.form_shape(1)))
    with pytest.raises(ValueError, match='same lattice'):
        wedge(L.form(1), Lattice(L.D, L.N + 2).form(1))


def test_adjointness_in_form_convention(lattices):
    L, _ = lattices
    rng = np.random.default_rng(7)
    for p in range(L.D):
        a, b = random_form(L, p, rng), random_form(L, p + 1, rng)
        lhs = float((np.asarray(d(a)) * np.asarray(b)).sum())
        rhs = float((np.asarray(a) * np.asarray(delta(b))).sum())
        assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


@pytest.mark.parametrize('D,N', [(2, 4), (2, 5), (2, 8), (3, 3), (3, 4), (4, 3)])
def test_sparse_operators_match_dense(D, N):
    """delta_sparse/d_sparse/coface_sum_at/face_sum_at equal the dense
    operators on the equivalent sparse form, bit for bit, and accumulate into
    ``out`` (an array or a tensor)."""
    rng = np.random.default_rng([D, N])
    L = Lattice(D, N)
    color = L.checkerboarding[0]
    comp = int(rng.integers(0, comb(D, 2)))
    vals = rng.integers(-3, 4, len(color[0]))
    dense = torch.zeros(L.form_shape(2), dtype=torch.int64)
    dense[(comp,) + tuple(torch.as_tensor(c) for c in color)] = torch.as_tensor(vals)
    want = calculus.delta(L, 2, dense)
    assert torch.equal(tl.delta_sparse(L, 2, comp, color, vals), want)
    out = np.ones(L.form_shape(1))
    tl.delta_sparse(L, 2, comp, color, vals, out=out)
    np.testing.assert_array_equal(out, 1 + want.numpy())
    out_t = torch.ones(L.form_shape(1), dtype=torch.float64)
    tl.delta_sparse(L, 2, comp, color, torch.as_tensor(vals), out=out_t)
    assert torch.equal(out_t, 1 + want.double())

    zero = torch.zeros(L.form_shape(0), dtype=torch.int64)
    zero[(0,) + tuple(torch.as_tensor(c) for c in color)] = torch.as_tensor(vals)
    assert torch.equal(tl.d_sparse(L, 0, 0, color, vals), calculus.d(L, 0, zero))

    f1 = rng.integers(-3, 4, L.form_shape(1))
    co = calculus.coface_sum(L, 1, torch.as_tensor(f1))
    assert torch.equal(tl.coface_sum_at(L, 1, f1, comp, color),
                       co[(comp,) + tuple(torch.as_tensor(c) for c in color)])
    fa = calculus.face_sum(L, 1, torch.as_tensor(f1))
    assert torch.equal(tl.face_sum_at(L, 1, torch.as_tensor(f1), 0, color),
                       fa[(0,) + tuple(torch.as_tensor(c) for c in color)])


def test_sparse_functions_match_jax():
    from supervillain_tpu.ops import delta_sparse as jdelta_sparse
    L, JL = Lattice(3, 3), jsv.Lattice(3, 3)
    color = L.checkerboarding[1]
    vals = np.arange(len(color[0])) - 4
    np.testing.assert_array_equal(tl.delta_sparse(L, 2, 1, color, vals).numpy(),
                                  np.asarray(jdelta_sparse(JL, 2, 1, color, vals)))
    assert JaxForm is not Form
