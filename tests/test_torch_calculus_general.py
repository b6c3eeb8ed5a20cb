"""The rest of the port's calculus (laplacian, star, wedge, push, pull, inner)
and lattice (counts, factories, checkerboarding, the D=2 aliases) against the
JAX package at D = 2 to 5, odd and even N: integer forms bit for bit, float64
forms to 1e-12; batched forms as each of their items; and the algebraic
identities of ``tests/test_calculus.py`` held by the port's own operators."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from supervillain_tpu.ops import Lattice as JaxLattice, Lattice2D as JaxLattice2D
from supervillain_tpu.ops import calculus as jcalc
from supervillain_tpu_torch.ops import Lattice, Lattice2D, calculus as tcalc

TOL = 1e-12
GEOMETRIES = [(2, 3), (2, 4), (2, 5), (3, 3), (3, 4), (4, 3), (4, 4), (5, 3)]
SMALL = [(2, 3), (2, 4), (3, 3), (4, 3)]


def random_form(rng, L, p, integer, batch=()):
    shape = tuple(batch) + L.form_shape(p)
    return rng.integers(-5, 6, shape) if integer else rng.normal(size=shape)


def assert_same(got, want, integer):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if integer:
        assert np.issubdtype(got.dtype, np.integer)
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def cases(op, D):
    """(p, q) degree pairs of an operator on a D-dimensional lattice."""
    if op == 'wedge':
        return [(pa, pb) for pa in range(D + 1) for pb in range(D - pa + 1)]
    return [(p, None) for p in range(D + 1)]


def ours_and_theirs(op, L, JL, p, q, f, g):
    if op == 'wedge':
        return (tcalc.wedge(L, p, torch.as_tensor(f), q, torch.as_tensor(g)),
                jcalc.wedge(JL, p, jnp.asarray(f), q, jnp.asarray(g)))
    if op == 'inner':
        return tcalc.inner(torch.as_tensor(f), torch.as_tensor(g)), jcalc.inner(f, g)
    if op in ('push', 'pull'):
        shift = tuple(int(s) for s in np.random.default_rng(p).integers(-L.N, L.N, L.D))
        return (getattr(tcalc, op)(torch.as_tensor(f), shift),
                getattr(jcalc, op)(jnp.asarray(f), shift))
    return (getattr(tcalc, op)(L, p, torch.as_tensor(f)),
            getattr(jcalc, op)(JL, p, jnp.asarray(f)))


@pytest.mark.parametrize('integer', [True, False], ids=['int', 'f64'])
@pytest.mark.parametrize('op', ['laplacian', 'star', 'wedge', 'push', 'pull', 'inner'])
@pytest.mark.parametrize('D,N', GEOMETRIES)
def test_operator_matches_jax(D, N, op, integer):
    rng = np.random.default_rng([D, N, len(op)])
    L, JL = Lattice(D, N), JaxLattice(D, N)
    for p, q in cases(op, D):
        f = random_form(rng, L, p, integer)
        g = random_form(rng, L, q if q is not None else p, integer)
        ours, theirs = ours_and_theirs(op, L, JL, p, q, f, g)
        assert_same(ours.numpy(), theirs, integer)


@pytest.mark.parametrize('op', ['laplacian', 'star', 'wedge', 'push'])
@pytest.mark.parametrize('D,N', [(2, 5), (3, 4), (4, 3)])
def test_batched_forms_are_each_item(D, N, op):
    """A leading batch axis of 3 gives each item's result, bit for bit."""
    rng = np.random.default_rng([D, N, 7])
    L = Lattice(D, N)
    for p, q in cases(op, D):
        f = torch.as_tensor(random_form(rng, L, p, True, batch=(3,)))
        g = torch.as_tensor(random_form(rng, L, q if q is not None else p, True, batch=(3,)))
        if op == 'wedge':
            batched = tcalc.wedge(L, p, f, q, g)
            items = [tcalc.wedge(L, p, f[i], q, g[i]) for i in range(3)]
        elif op == 'push':
            batched = tcalc.push(f, (1, 2) + (0,) * (D - 2))
            items = [tcalc.push(f[i], (1, 2) + (0,) * (D - 2)) for i in range(3)]
        else:
            batched = getattr(tcalc, op)(L, p, f)
            items = [getattr(tcalc, op)(L, p, f[i]) for i in range(3)]
        assert torch.equal(batched, torch.stack(items))


def test_operators_stay_on_their_device_and_dtype():
    L = Lattice(3, 3)
    f = torch.ones(L.form_shape(1), dtype=torch.int32)
    for out in (tcalc.laplacian(L, 1, f), tcalc.star(L, 1, f), tcalc.wedge(L, 1, f, 1, f),
                tcalc.push(f, (1, 0, 0)), tcalc.pull(f, (0, 1, 0))):
        assert out.dtype == torch.int32 and out.device == f.device
    with pytest.raises(ValueError, match='Cannot wedge'):
        tcalc.wedge(L, 2, tcalc.d(L, 1, f), 2, tcalc.d(L, 1, f))


# -- the identities of tests/test_calculus.py, on the port's operators ---------

def _f(rng, L, p):
    return torch.as_tensor(rng.normal(size=L.form_shape(p)))


@pytest.mark.parametrize('D,N', GEOMETRIES)
def test_laplacian_is_d_delta_plus_delta_d(D, N):
    rng = np.random.default_rng([D, N, 1])
    L = Lattice(D, N)
    for p in range(D + 1):
        f = _f(rng, L, p)
        composed = torch.zeros_like(f)
        if p < D:
            composed = composed + tcalc.delta(L, p + 1, tcalc.d(L, p, f))
        if p > 0:
            composed = composed + tcalc.d(L, p - 1, tcalc.delta(L, p, f))
        torch.testing.assert_close(tcalc.laplacian(L, p, f), composed, rtol=0, atol=1e-10)


@pytest.mark.parametrize('D,N', GEOMETRIES)
def test_weitzenbock_and_hodge_inner_product(D, N):
    """⟨Δf, f⟩ = ⟨df, df⟩ + ⟨δf, δf⟩ and Σ_x (a ∧ ★b) = ⟨a, b⟩."""
    rng = np.random.default_rng([D, N, 2])
    L = Lattice(D, N)
    for p in range(D + 1):
        f, g = _f(rng, L, p), _f(rng, L, p)
        lhs = float(tcalc.inner(tcalc.laplacian(L, p, f), f))
        df, deltaf = tcalc.d(L, p, f), tcalc.delta(L, p, f)
        assert np.isclose(lhs, float((df * df).sum() + (deltaf * deltaf).sum()),
                          atol=1e-8 * L.sites)
        top = tcalc.wedge(L, p, f, D - p, tcalc.star(L, p, g))
        assert np.isclose(float(top.sum()), float(tcalc.inner(f, g)), atol=1e-8)


@pytest.mark.parametrize('D,N', SMALL)
def test_wedge_associative_and_leibniz(D, N):
    rng = np.random.default_rng([D, N, 3])
    L = Lattice(D, N)
    for n in range(D + 1):
        for m in range(D + 1 - n):
            a, b = _f(rng, L, n), _f(rng, L, m)
            for q in range(D + 1 - n - m):
                c = _f(rng, L, q)
                torch.testing.assert_close(
                    tcalc.wedge(L, n + m, tcalc.wedge(L, n, a, m, b), q, c),
                    tcalc.wedge(L, n, a, m + q, tcalc.wedge(L, m, b, q, c)))
            if n + m < D:
                lhs = tcalc.d(L, n + m, tcalc.wedge(L, n, a, m, b))
                rhs = (tcalc.wedge(L, n + 1, tcalc.d(L, n, a), m, b)
                       + (-1) ** n * tcalc.wedge(L, n, a, m + 1, tcalc.d(L, m, b)))
                torch.testing.assert_close(lhs, rhs)


@pytest.mark.parametrize('D,N', SMALL)
def test_star_star_and_star_d_star(D, N):
    """★★f = (−1)^{p(D−p)} push(f, 𝟙) and ★d★f = (−1)^{D(p−1)+1} push(δf, 𝟙)."""
    rng = np.random.default_rng([D, N, 4])
    L = Lattice(D, N)
    one = (1,) * D
    for p in range(D + 1):
        f = _f(rng, L, p)
        torch.testing.assert_close(tcalc.star(L, D - p, tcalc.star(L, p, f)),
                                   (-1) ** (p * (D - p)) * tcalc.push(f, one))
        if p > 0:
            sign = (-1) ** (D * (p - 1) + 1)
            lhs = tcalc.star(L, D - p + 1, tcalc.d(L, D - p, tcalc.star(L, p, f)))
            torch.testing.assert_close(lhs, sign * tcalc.push(tcalc.delta(L, p, f), one))


@pytest.mark.parametrize('D,N', GEOMETRIES)
def test_push_pull_roundtrip(D, N):
    rng = np.random.default_rng([D, N, 5])
    L = Lattice(D, N)
    f = _f(rng, L, 1)
    shift = tuple(int(s) for s in rng.integers(-N, N, D))
    assert torch.equal(tcalc.pull(tcalc.push(f, shift), shift), f)
    assert torch.equal(tcalc.push(f, (N,) + (0,) * (D - 1)), f)


# -- the lattice ----------------------------------------------------------------

@pytest.mark.parametrize('D,N', GEOMETRIES)
def test_lattice_counts_and_checkerboarding_match_jax(D, N):
    ours, ref = Lattice(D, N), JaxLattice(D, N)
    assert ours.cells_of_degree == ref.cells_of_degree
    assert ours.cells_of_codegree == ref.cells_of_codegree
    assert ours.dim == ref.dim == D
    assert ours.n_colors == ref.n_colors == (2 if N % 2 == 0 else 2 ** max(D, 2))
    assert len(ours.checkerboarding) == len(ref.checkerboarding)
    for a, b in zip(ours.checkerboarding, ref.checkerboarding):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    total = np.zeros(ours.dims, dtype=int)
    for m in ours.checkerboard_masks:
        total += m
        for k in range(D):
            assert not (m & np.roll(m, 1, axis=k)).any()
    assert (total == 1).all()


def test_lattice_factories():
    L = Lattice(3, 4)
    z = L.zeros(2, dtype=torch.int32)
    assert z.shape == (3, 4, 4, 4) and z.dtype == torch.int32 and not z.any()
    r = L.random(1, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    assert r.shape == (3, 4, 4, 4) and bool(((r >= 0) & (r < 1)).all())
    f = L.form(1)
    assert f.degree == 1 and f.lattice is L and f.shape == L.form_shape(1) and not f.any()
    wrapped = L.form(1, r)
    np.testing.assert_array_equal(np.asarray(wrapped), r.numpy())


def test_lattice2d_aliases_match_jax():
    ours, ref = Lattice2D(5), JaxLattice2D(5)
    assert (ours.nt, ours.nx) == (ref.nt, ref.nx) == (5, 5)
    for name in ('t', 'x', 'T', 'X'):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))


def test_plot_form_draws_each_degree():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    L = Lattice2D(4)
    rng = np.random.default_rng(0)
    fig, axes = plt.subplots(1, 3)
    for p, axis in enumerate(axes):
        form = torch.as_tensor(rng.normal(size=L.form_shape(p)))
        assert L.plot_form(p, form, axis, label=f'p={p}') is axis
        assert axis.get_title() == f'p={p}'
    with pytest.raises(ValueError, match='plot_form'):
        L.plot_form(3, np.zeros((1, 4, 4)), axes[0])
    plt.close(fig)
