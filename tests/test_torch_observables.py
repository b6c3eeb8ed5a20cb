"""The port's observables and lattice methods against the JAX package's, on the
CPU: the same NumPy configurations, made from a seed, measured by both
packages' ensembles.  Also: the measurement device (the card by default, so a
measurement without one raises), the bounded chunks of a sequential
observable, and the port's independence from JAX and h5py."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.observables import _taxicab as jtaxicab
from supervillain_tpu_torch.observables import _taxicab as ttaxicab

TOL = 1e-12
#: (action, N, W): both actions, odd and even N, finite and infinite W.
CASES = [('Villain', 5, 2), ('Villain', 6, float('inf')),
         ('Worldline', 6, 2), ('Worldline', 5, float('inf'))]
OBSERVABLES = sorted(tsv.observables.registry)
#: Measured by the JAX package from a float32 dn (int64 promotes with float32 to
#: float32 there); the port measures in float64.
FLOAT32_IN_JAX = {('Villain', 'WindingSquared'), ('Villain', 'Winding_Winding')}


def configurations(action, N, W, count=24, seed=0):
    """Seeded NumPy configurations of either action with realistic magnitudes:
    φ uniform, n mostly 0 (multiples of W at finite W); m closed (δ of an
    integer 2-form plus wrapping cycles), v integer or (W=∞) real."""
    rng = np.random.default_rng([seed, N])
    if action == 'Villain':
        k = rng.choice([-1, 0, 1], p=[0.15, 0.7, 0.15], size=(count, 2, N, N))
        return {'phi': rng.uniform(-np.pi, np.pi, size=(count, 1, N, N)),
                'n': k * (1 if W == float('inf') else W)}
    L = tsv.Lattice2D(N)
    m = tsv.ops.calculus.delta(L, 2, torch.as_tensor(rng.integers(-1, 2, size=(count, 1, N, N))))
    m[:, 0] += torch.as_tensor(rng.integers(-1, 2, size=(count, 1, N)))
    m[:, 1] += torch.as_tensor(rng.integers(-1, 2, size=(count, N, 1)))
    v = (rng.uniform(-3, 3, size=(count, 1, N, N)) if W == float('inf')
         else rng.integers(-2 * W, 2 * W + 1, size=(count, 1, N, N)))
    return {'m': m.numpy(), 'v': v}


def ensembles(action, N, W, kappa=0.5, **kwargs):
    """(JAX ensemble, port ensemble on the CPU) of the same configurations."""
    cfgs = configurations(action, N, W, **kwargs)
    J = getattr(jsv, action)(jsv.Lattice2D(N), kappa, W=W)
    T = getattr(tsv, action)(tsv.Lattice2D(N), kappa, W=W)
    return (jsv.Ensemble(J).from_configurations(jsv.Configurations(cfgs)),
            tsv.Ensemble(T).from_configurations(tsv.Configurations(cfgs), device='cpu'))


def assert_agree(ours, ref, scale=None):
    """Within 1e-12: absolutely for values of order 1, relatively to ``scale``
    (by default the reference's largest magnitude) otherwise."""
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()) if scale is None else scale)
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL * scale)


@pytest.fixture(scope='module', params=CASES, ids=lambda c: f'{c[0]}-N{c[1]}-W{c[2]}')
def pair(request):
    return request.param[0], ensembles(*request.param)


@pytest.mark.parametrize('name', OBSERVABLES)
def test_observable_matches_jax(pair, name):
    action, (ref, ours) = pair
    expect = np.asarray(getattr(ref, name))
    got = getattr(ours, name)
    assert np.iscomplexobj(got) == np.iscomplexobj(expect)
    if (action, name) in FLOAT32_IN_JAX:
        # test_villain_winding_matches_jax_in_float64 holds the port to the
        # same formula in float64; here the reference carries float32 rounding.
        np.testing.assert_allclose(got, expect, rtol=2e-6, atol=2e-6)
    else:
        assert_agree(got, expect)


def test_villain_winding_matches_jax_in_float64():
    """The Villain WindingSquared and Winding_Winding formulas of the JAX
    package, evaluated in float64 with its own calculus and correlation."""
    import jax.numpy as jnp
    from supervillain_tpu.ops import calculus as jcalc
    ref, ours = ensembles('Villain', 6, 3)
    L = ref.Action.Lattice
    dn = np.stack([np.asarray(jcalc.d(L, 1, jnp.asarray(n))).astype(np.float64) for n in ref.n])
    assert_agree(ours.WindingSquared, (dn ** 2).mean(axis=(1, 2, 3)))
    assert_agree(ours.Winding_Winding,
                 np.stack([np.asarray(L.correlation(x, x).real.mean(axis=0)) for x in dn]))


def test_taxicab_tables_match_jax():
    for N in (4, 5, 6):
        for ours, ref in ((ttaxicab.spin_tables(2, N), jtaxicab.spin_tables(2, N)),
                          (ttaxicab.vortex_tables(2, N), jtaxicab.vortex_tables(2, N))):
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('D, N', [(2, 5), (2, 6), (3, 4)])
def test_lattice_fourier_and_reshaping_match_jax(D, N):
    rng = np.random.default_rng(D * 10 + N)
    J, T = jsv.Lattice(D, N), tsv.Lattice(D, N)
    np.testing.assert_array_equal(T.coordinates, J.coordinates)
    np.testing.assert_array_equal(T.R_squared, J.R_squared)
    np.testing.assert_array_equal(T.distance_squared(T.coordinates, T.coordinates[::-1]),
                                  J.distance_squared(J.coordinates, J.coordinates[::-1]))
    f = rng.normal(size=(3,) + J.dims) + 1j * rng.normal(size=(3,) + J.dims)
    g = rng.normal(size=(3,) + J.dims)
    for name in ('correlation', 'convolution'):
        assert_agree(getattr(T, name)(torch.as_tensor(f), torch.as_tensor(g)).numpy(),
                     getattr(J, name)(f, g))
    assert_agree(T.ifft(T.fft(torch.as_tensor(f))).numpy(), f)
    C = rng.normal(size=(4,) + J.dims)
    assert_agree(T.symmetrize(C), J.symmetrize(C))
    assert_agree(T.symmetrize(torch.as_tensor(C)).numpy(), J.symmetrize(C))
    assert_agree(T.symmetrize(np.moveaxis(C, 0, -1), dims=(0,)),
                 J.symmetrize(np.moveaxis(C, 0, -1), dims=(0,)))
    flat = T.linearize(C)
    np.testing.assert_array_equal(flat, J.linearize(C))
    for center in (False, True):
        np.testing.assert_array_equal(T.coordinatize(flat, center_origin=center),
                                      J.coordinatize(flat, center_origin=center))
        np.testing.assert_array_equal(
            T.coordinatize(torch.as_tensor(flat), center_origin=center).numpy(),
            J.coordinatize(flat, center_origin=center))


def test_symmetrized_correlator_is_point_group_invariant():
    L = tsv.Lattice2D(6)
    C = L.symmetrize(np.random.default_rng(1).normal(size=(2, 6, 6)))
    np.testing.assert_allclose(C, np.swapaxes(C, 1, 2), atol=1e-15)
    np.testing.assert_allclose(C, C[:, L.mod(-np.arange(6)) % 6], atol=1e-15)


@pytest.mark.parametrize('name', ['Spin_Spin', 'Vortex_Vortex'])
@pytest.mark.parametrize('action', ['Villain', 'Worldline'])
def test_sequential_chunks_equal_one_batch(monkeypatch, action, name):
    """A sequential observable measured over chunks of 5 draws equals one
    batch of all 24 (the default chunk holds them all)."""
    cls = tsv.observables.registry[name]
    assert cls.sequential and cls.chunk >= 24
    whole = getattr(ensembles(action, 6, 2)[1], name)
    monkeypatch.setattr(cls, 'chunk', 5)
    np.testing.assert_array_equal(getattr(ensembles(action, 6, 2)[1], name), whole)


@pytest.mark.parametrize('action', ['Villain', 'Worldline'])
def test_inline_histogram_is_returned_as_it_is(action):
    ref, ours = ensembles(action, 6, 2)
    name = 'Vortex_Vortex' if action == 'Villain' else 'Spin_Spin'
    hist = np.random.default_rng(2).integers(0, 9, size=(len(ours), 6, 6)).astype(np.float32)
    ours.configuration.fields[name] = hist
    np.testing.assert_array_equal(getattr(ours, name), hist)


def test_measuring_without_a_card_raises_and_names_the_cpu(monkeypatch):
    """Building an ensemble for the card never raises; its first measurement,
    its bootstrap and its derived quantities do, naming device='cpu'."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfgs = configurations('Villain', 4, 1, count=6)
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    e = tsv.Ensemble(S).from_configurations(tsv.Configurations(cfgs))
    assert e.device == 'cuda' and e.cut(1).device == 'cuda' and e.every(2).device == 'cuda'
    for measure in (lambda: e.ActionDensity, lambda: e.Spin_Spin,
                    lambda: tsv.Bootstrap(e, draws=3, seed=0).phi,
                    lambda: tsv.Bootstrap(e, draws=3, seed=0).SpinSusceptibility):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            measure()
    cpu = tsv.Ensemble(S).from_configurations(tsv.Configurations(cfgs), device='cpu')
    assert np.isfinite(tsv.Bootstrap(cpu, draws=3, seed=0).SpinSusceptibility).all()


def test_fleet_views_measure_where_the_fleet_ran():
    S = tsv.Worldline(tsv.Lattice2D(4), 0.5, W=2)
    fleet = tsv.sample_fused_fleet(S, chains=3, steps=4, thin=1, worms=1, keep_fields=True,
                                   device='cpu')
    assert fleet.device.type == 'cpu'
    for e in (fleet.ensemble(1), fleet.pooled_ensemble(1)):
        assert e.device == fleet.device
        assert np.isfinite(e.WindingSquared).all()
        assert np.isfinite(tsv.Bootstrap(e, draws=4, seed=1).SpinCriticalMoment).all()


def test_measure_returns_every_observable():
    _, ours = ensembles('Worldline', 4, 2, count=3)
    assert set(ours.measure()) == set(OBSERVABLES)
    assert ours.measured == set(OBSERVABLES)


def test_port_imports_neither_jax_nor_h5py():
    """Every module of the port imports in a fresh interpreter without pulling
    in jax, the JAX package or h5py."""
    code = '\n'.join([
        'import importlib, pkgutil, sys',
        'import supervillain_tpu_torch as pkg',
        'names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]',
        'for name in names:',
        '    importlib.import_module(name)',
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "h5py")',
        '             or m.split(".")[0] == "supervillain_tpu")',
        'print(len(names), bad)',
    ])
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    assert int(out[0]) > 40, out
    assert out[1:] == ['[]'], out
