"""The port's general generators against the JAX package's, on the CPU.

- the ΔS algebra of ``SiteUpdate``, ``LinkUpdate``, ``ExactUpdate``,
  ``CohomologyUpdate`` and ``PlaquetteUpdate`` equals S(new) − S(old) of the
  port's action and the JAX algebra, in float64 on the D=2 geometries of
  ``tests/test_delta_s.py``;
- ``Sequentially``/``KeepEvery``/``Hammer`` trees have the JAX package's names,
  tags, stats keys, inline shapes and generator specs, for every ``Hammer``
  argument combination at W = 1, 2 and ∞;
- the models' ``gauge_transform``, ``configurations`` and ``field_degrees``;
- ``Ensemble.every`` carries ``KeepEvery`` and ``continue_from`` of a strided
  ensemble runs; generator trees round-trip through HDF5 both ways.
"""

import itertools

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.generators import villain as jv, worldline as jw
from supervillain_tpu.ops import calculus as jcalc
from supervillain_tpu_torch.generators import villain as tv, worldline as tw
from supervillain_tpu_torch.ops import calculus as tcalc

SIZES = (4, 5, 8)
KAPPAS = (0.4, 0.5, 0.6)
TWO_PI = 2 * np.pi


def _close(a, b, scale=1.0):
    """Equal to 1e-12 of ``scale`` (the size of the actions whose difference is taken)."""
    assert abs(float(a) - float(b)) <= 1e-12 * max(1.0, abs(float(scale))), (a, b)


def _villain(N, kappa, W, seed):
    rng = np.random.default_rng(seed)
    phi = rng.normal(size=(1, 1, N, N))
    n = rng.integers(-2, 3, size=(1, 2, N, N))
    return (jsv.Villain(jsv.Lattice2D(N), kappa, W=W), tsv.Villain(tsv.Lattice2D(N), kappa, W=W),
            phi, n, rng)


@pytest.mark.parametrize('N,kappa', itertools.product(SIZES, KAPPAS))
def test_site_delta_s(N, kappa):
    J, T, phi, n, rng = _villain(N, kappa, 1, 1)
    x = tuple(rng.integers(0, N, 2))
    change = np.zeros_like(phi)
    change[(0, 0) + x] = rng.normal()
    tphi, tn, tchange = (torch.as_tensor(a) for a in (phi, n, change))
    r = tcalc.d(T.Lattice, 0, tphi) - TWO_PI * tn.double()
    ours = tv.site_delta_s(kappa, T.Lattice, r, tchange)[(0,) + x]
    full = T(tphi + tchange, tn) - T(tphi, tn)
    jr = jcalc.d(J.Lattice, 0, jnp.asarray(phi[0])) - TWO_PI * jnp.asarray(n[0])
    cd = jcalc.d(J.Lattice, 0, jnp.asarray(change[0]))
    theirs = jnp.sum((kappa / 2) * cd * (2 * jr + cd))
    _close(ours, full, T(tphi, tn))
    _close(ours, theirs)


@pytest.mark.parametrize('N,kappa,W', itertools.product(SIZES, KAPPAS, (1, 2)))
def test_link_delta_s(N, kappa, W):
    J, T, phi, n, rng = _villain(N, kappa, W, 2)
    at = (0, int(rng.integers(0, 2))) + tuple(rng.integers(0, N, 2))
    change = np.zeros_like(n)
    change[at] = W * int(rng.choice([-2, -1, 1, 2]))
    tphi, tn, tchange = (torch.as_tensor(a) for a in (phi, n, change))
    ours = tv.link_delta_s(kappa, tcalc.d(T.Lattice, 0, tphi), tn, tchange)[at]
    full = T(tphi, tn + tchange) - T(tphi, tn)
    dphi = jcalc.d(J.Lattice, 0, jnp.asarray(phi[0]))
    c = jnp.asarray(change[0])
    theirs = jnp.sum(-TWO_PI * kappa * c * (dphi - TWO_PI * jnp.asarray(n[0]) - np.pi * c))
    _close(ours, full, T(tphi, tn))
    _close(ours, theirs)


@pytest.mark.parametrize('N,kappa', itertools.product(SIZES, KAPPAS))
def test_exact_delta_s(N, kappa):
    J, T, phi, n, rng = _villain(N, kappa, 2, 3)
    x = tuple(rng.integers(0, N, 2))
    z = np.zeros((1, 1, N, N), dtype=np.int64)
    z[(0, 0) + x] = rng.choice([-1, 1])
    tphi, tn, tz = (torch.as_tensor(a) for a in (phi, n, z))
    L = T.Lattice
    ours = tv.exact_delta_s(kappa, L, tcalc.d(L, 0, tphi), tn, tz)[(0,) + x]
    change = tcalc.d(L, 0, tz)
    assert torch.equal(tcalc.d(L, 1, tn + change), tcalc.d(L, 1, tn))
    full = T(tphi, tn + change) - T(tphi, tn)
    c = jcalc.d(J.Lattice, 0, jnp.asarray(z[0]))
    dphi = jcalc.d(J.Lattice, 0, jnp.asarray(phi[0]))
    theirs = jnp.sum(-TWO_PI * kappa * c * ((dphi - TWO_PI * jnp.asarray(n[0])) - np.pi * c))
    _close(ours, full, T(tphi, tn))
    _close(ours, theirs)


@pytest.mark.parametrize('N,kappa', itertools.product(SIZES, KAPPAS))
def test_cohomology_delta_s(N, kappa):
    J, T, phi, n, rng = _villain(N, kappa, 1, 4)
    G = tv.CohomologyUpdate(T)
    tphi, tn = torch.as_tensor(phi), torch.as_tensor(n)
    r = tcalc.d(T.Lattice, 0, tphi) - TWO_PI * tn.double()
    for mu in range(2):
        h = int(rng.choice([-2, -1, 1, 2]))
        mask = torch.as_tensor(G._slice_masks[mu])
        ours = tv.cohomology_delta_s(kappa, r[:, mu], mask, torch.tensor([h]))[0]
        new = tn.clone()
        new[0, mu] += h * mask
        full = T(tphi, new) - T(tphi, tn)
        assert torch.equal(tcalc.d(T.Lattice, 1, new), tcalc.d(T.Lattice, 1, tn))
        jr = jcalc.d(J.Lattice, 0, jnp.asarray(phi[0])) - TWO_PI * jnp.asarray(n[0])
        jmask = jv.CohomologyUpdate(J)._slice_masks[mu]
        change_r = -TWO_PI * h
        theirs = jnp.sum(jnp.where(jmask, (kappa / 2) * change_r * (2 * jr[mu] + change_r), 0))
        _close(ours, full, T(tphi, tn))
        _close(ours, theirs)


@pytest.mark.parametrize('N,kappa,W', itertools.product(SIZES, KAPPAS, (1, 2)))
def test_plaquette_delta_s(N, kappa, W):
    rng = np.random.default_rng(5)
    J = jsv.Worldline(jsv.Lattice2D(N), kappa, W=W)
    T = tsv.Worldline(tsv.Lattice2D(N), kappa, W=W)
    L = T.Lattice
    m = tcalc.delta(L, 2, torch.as_tensor(rng.integers(-2, 3, size=(1, 1, N, N))))
    v = torch.as_tensor(rng.integers(-2, 3, size=(1, 1, N, N)))
    x = tuple(rng.integers(0, N, 2))
    t = torch.zeros_like(v)
    t[(0, 0) + x] = int(rng.choice([-1, 1]))
    change_v = torch.zeros_like(v)
    change_v[(0, 0) + x] = int(rng.choice([-1, 0, 1]))
    f = T.links(m, v)
    ours = tw.plaquette_delta_s(kappa, L, f, t, change_v, W)[(0,) + x]
    new_m = m + tcalc.delta(L, 2, t)
    assert T.valid({'m': new_m})
    full = T(new_m, v + change_v) - T(m, v)
    jf = jnp.asarray(f[0].numpy())
    change_f = (jcalc.delta(J.Lattice, 2, jnp.asarray(t[0].numpy()))
                - jcalc.delta(J.Lattice, 2, jnp.asarray(change_v[0].numpy())) / J._W)
    theirs = jnp.sum((0.5 / kappa) * change_f * (2 * jf + change_f))
    _close(ours, full, T(m, v))
    _close(ours, theirs)


# -- trees: names, tags, stats keys, inline shapes, specs ------------------------

def _shapes(G):
    """inline_shapes without the JAX package's dtypes."""
    return {k: tuple(v[0]) if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], tuple)
            else tuple(v) for k, v in G.inline_shapes().items()}


def _same_tree(ours, theirs):
    assert ours.name == theirs.name and str(ours) == str(theirs)
    assert getattr(ours, '_tags', None) == getattr(theirs, '_tags', None)
    assert ({k: sorted(v) for k, v in ours.init_stats().items()}
            == {k: sorted(v) for k, v in theirs.init_stats().items()})
    assert _shapes(ours) == _shapes(theirs)
    spec = tsv.io.generator_spec(ours)
    assert spec == jsv.io.generator_spec(theirs)
    assert tsv.io.generator_spec(tsv.io.generator_from_spec(spec, ours.Action
                                                            if hasattr(ours, 'Action') else
                                                            ours.generators[0].Action)) == spec


VILLAIN_HAMMERS = list(itertools.product((1, 2, float('inf')), (1, 2), (None, 5), (False, True),
                                         (None, 7)))


@pytest.mark.parametrize('W,worms,worm_moves,fleet,cap', VILLAIN_HAMMERS)
def test_villain_hammer_tree_matches_jax(W, worms, worm_moves, fleet, cap):
    J = jsv.Villain(jsv.Lattice2D(4), 0.5, W=W)
    T = tsv.Villain(tsv.Lattice2D(4), 0.5, W=W)
    args = dict(worms=worms, worm_moves=worm_moves, fleet=fleet, max_worm_moves=cap)
    _same_tree(tv.Hammer(T, **args), jv.Hammer(J, **args))


@pytest.mark.parametrize('W,worms,fleet,cap', itertools.product((1, 2, float('inf')), (1, 2),
                                                                (False, True), (None, 7)))
def test_worldline_hammer_tree_matches_jax(W, worms, fleet, cap):
    J = jsv.Worldline(jsv.Lattice2D(4), 0.5, W=W)
    T = tsv.Worldline(tsv.Lattice2D(4), 0.5, W=W)
    args = dict(worms=worms, fleet=fleet, max_worm_moves=cap)
    _same_tree(tw.Hammer(T, **args), jw.Hammer(J, **args))


def test_combinators_match_jax():
    J = jsv.Villain(jsv.Lattice2D(4), 0.5, W=2)
    T = tsv.Villain(tsv.Lattice2D(4), 0.5, W=2)
    trees = [
        (lambda m, g, S: m.Sequentially([g.ClassicWorm(S), g.SiteUpdate(S),
                                         m.KeepEvery(3, g.ClassicWorm(S, max_moves=9)),
                                         g.ClassicWorm(S)])),
        (lambda m, g, S: m.KeepEvery(2, m.Sequentially([g.LinkUpdate(S, interval_n=2),
                                                        g.ExactUpdate(S, interval_z=3)]),
                                     blocked_inline=False)),
        (lambda m, g, S: m.Logger(m.Sequentially([g.CohomologyUpdate(S, interval_h=2),
                                                  g.NeighborhoodUpdate(S, p_n=0.25)]))),
    ]
    for build in trees:
        ours = build(tsv.generators, tv, T)
        theirs = build(jsv.generators, jv, J)
        assert ours.name == theirs.name and str(ours) == str(theirs)
        assert getattr(ours, '_tags', None) == getattr(theirs, '_tags', None)
        assert sorted(ours.init_stats()) == sorted(theirs.init_stats())
        assert _shapes(ours) == _shapes(theirs)
        assert tsv.io.generator_spec(ours) == jsv.io.generator_spec(theirs)
    assert _shapes(tsv.DoNothing()) == _shapes(jsv.generators.DoNothing())
    assert tsv.io.generator_spec(tsv.DoNothing()) == jsv.io.generator_spec(jsv.generators.DoNothing())
    # A composite that keeps stats under foreign tags is refused by both.
    for m, S, fused in ((tsv.generators, T, tsv.FusedHammer), (jsv.generators, J,
                                                               jsv.generators.FusedHammer)):
        with pytest.raises(ValueError, match='self-contained composite'):
            m.Sequentially([fused(S)])


def test_keep_every_blocks_or_keeps_the_last_inline_value():
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    worm = tv.ClassicWorm(S)
    cfg = {k: v[None].expand(3, *v.shape).contiguous() for k, v in S.initial('cpu').items()}
    singles = []
    g = torch.Generator().manual_seed(3)
    c, stats = cfg, worm.init_stats()
    for _ in range(4):
        c, stats, inline = worm.step(g, c, stats)
        singles.append(inline)
    for blocked in (True, False):
        g = torch.Generator().manual_seed(3)
        out, kstats, inline = tsv.KeepEvery(4, worm, blocked_inline=blocked).step(
            g, cfg, worm.init_stats())
        assert torch.equal(out['n'], c['n'])
        assert tsv.generators.base.host_stats(kstats) == tsv.generators.base.host_stats(stats)
        for k in ('Vortex_Vortex', 'Worm_Length'):
            want = (sum(s[k] for s in singles) / 4) if blocked else singles[-1][k]
            torch.testing.assert_close(inline[k], want, rtol=1e-15, atol=0)
            assert inline[k].dtype == torch.float64


def test_steps_keep_chains_independent():
    """A chain's draws differ from its neighbours': the cohomology and
    ChunkedWorm proposals are drawn per chain (a shared draw would couple them)."""
    S = tsv.Villain(tsv.Lattice2D(4), 0.06, W=1)
    G = tsv.Sequentially([tv.CohomologyUpdate(S), tv.ChunkedWorm(S, moves_per_step=6)])
    fleet = tsv.sample_fleet(S, G, chains=32, steps=6, thin=2, device='cpu')
    n = fleet.columns['n'].reshape(6, 32, -1)
    assert all(len({row.tobytes() for row in n[i]}) > 1 for i in range(2, 6))
    worms = fleet.columns['worm'][-1]
    assert len({w.tobytes() for w in worms}) > 1


# -- the models ----------------------------------------------------------------

@pytest.mark.parametrize('N', SIZES)
def test_gauge_transform_matches_jax(N):
    J, T, phi, n, rng = _villain(N, 0.5, 2, 6)
    k = rng.integers(-3, 4, size=(1, N, N))
    ours = T.gauge_transform({'phi': torch.as_tensor(phi[0]), 'n': torch.as_tensor(n[0])}, k)
    theirs = J.gauge_transform({'phi': jnp.asarray(phi[0]), 'n': jnp.asarray(n[0])}, k)
    np.testing.assert_allclose(ours['phi'].numpy(), np.asarray(theirs['phi']), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ours['n'].numpy(), np.asarray(theirs['n']))
    _close(T(ours['phi'], ours['n']), T(torch.as_tensor(phi[0]), torch.as_tensor(n[0])),
           T(ours['phi'], ours['n']))
    for model, cfg in ((T, ours), (J, theirs)):
        with pytest.raises(ValueError, match='integer'):
            model.gauge_transform(cfg, np.zeros((1, N, N)))


@pytest.mark.parametrize('action,W', itertools.product(('Villain', 'Worldline'), (1, float('inf'))))
def test_configurations_and_field_degrees_match_jax(action, W):
    J = getattr(jsv, action)(jsv.Lattice2D(5), 0.5, W=W)
    T = getattr(tsv, action)(tsv.Lattice2D(5), 0.5, W=W)
    assert T.field_degrees() == J.field_degrees()
    ours, theirs = T.configurations(3), J.configurations(3)
    assert sorted(ours.fields) == sorted(theirs.fields)
    for k, v in theirs.fields.items():
        assert ours.fields[k].shape == v.shape and ours.fields[k].dtype == v.dtype
        assert not ours.fields[k].any()


# -- Ensemble.every and continuation, specs through HDF5 -------------------------

def test_every_carries_keep_every_and_continues_strided():
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=2)
    G = tv.Hammer(S)
    full = tsv.Ensemble(S).generate(16, G, seed=5, device='cpu')
    first = tsv.Ensemble(S).generate(10, G, seed=5, device='cpu')
    strided = first.every(2)
    assert isinstance(strided.generator, tsv.KeepEvery)
    assert (strided.generator.n, strided.generator.blocked_inline) == (2, False)
    assert strided.generator.generator is G and strided.index_stride == 2
    rest = tsv.Ensemble.continue_from(strided, 3, device='cpu')
    np.testing.assert_array_equal(rest.index, [10, 12, 14])
    np.testing.assert_array_equal(rest.phi, full.phi[[11, 13, 15]])
    np.testing.assert_array_equal(rest.n, full.n[[11, 13, 15]])
    np.testing.assert_array_equal(rest.Vortex_Vortex, full.Vortex_Vortex[[11, 13, 15]])
    assert rest.stats['ClassicWorm']['sweeps'] == full.stats['ClassicWorm']['sweeps']


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('action', ['Villain', 'Worldline'])
def test_generator_trees_round_trip_through_h5(tmp_path, writer, action):
    """A fleet-scan-style tree (Hammer(fleet=True), strided by every) written
    by either package rebuilds in the other with the same spec."""
    J = getattr(jsv, action)(jsv.Lattice2D(4), 0.5, W=1)
    T = getattr(tsv, action)(tsv.Lattice2D(4), 0.5, W=1)
    jg, tg = (jv, tv) if action == 'Villain' else (jw, tw)
    with h5py.File(tmp_path / 'trees.h5', 'w') as f:
        if writer == 'port':
            e = tsv.Ensemble(T).generate(4, tg.Hammer(T, fleet=True), seed=1, device='cpu')
            e.every(2).to_h5(f.create_group('ensemble'))
            read = jsv.Ensemble.from_h5(f['ensemble'])
        else:
            e = jsv.Ensemble(J).generate(4, jg.Hammer(J, fleet=True), seed=1)
            e.every(2).to_h5(f.create_group('ensemble'))
            read = tsv.Ensemble.from_h5(f['ensemble'], device='cpu')
        spec = (tsv if writer == 'port' else jsv).io.generator_spec(e.every(2).generator)
        assert spec['cls'] == 'KeepEvery' and spec['generator']['cls'] == 'Sequentially'
        assert (jsv if writer == 'port' else tsv).io.generator_spec(read.generator) == spec
    if writer == 'jax':
        rest = tsv.Ensemble.continue_from(read, 2, device='cpu')
        assert len(rest) == 2 and rest.index[0] == read.index[-1] + 2
