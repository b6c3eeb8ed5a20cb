"""HDF5 I/O of the port against the JAX package's, on the CPU: an ensemble (with
measured columns), a fleet and a bootstrap written by either package read in
the other under the strict version check, with equal columns and equal
measurements; generator specs; continuation of a chain from memory and from a
file; the generic object store."""

import h5py
import numpy as np
import pytest
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.generators import villain_fused as jvf, worldline_fused as jwf
from supervillain_tpu_torch.generators import villain as tv, villain_fused as tvf
from supervillain_tpu_torch.generators import worldline as tw, worldline_fused as twf
from test_torch_observables import assert_agree, configurations

JAX_IO, PORT_IO = jsv.io, tsv.io


@pytest.fixture
def h5(tmp_path):
    with h5py.File(tmp_path / 'test.h5', 'w') as f:
        yield f


def _actions(action, N=6, kappa=0.5, W=2):
    return (getattr(jsv, action)(jsv.Lattice2D(N), kappa, W=W),
            getattr(tsv, action)(tsv.Lattice2D(N), kappa, W=W))


def _measured(action):
    """Observables to measure and store: none is an inline column of the fused
    generators (a stored inline column is returned, not measured)."""
    return ('InternalEnergyDensity', 'Spin_Spin', 'TorusWrapping') if action == 'Villain' \
        else ('InternalEnergyDensity', 'Vortex_Vortex', 'Winding_Winding')


@pytest.mark.parametrize('action', ['Villain', 'Worldline'])
def test_jax_ensemble_reads_in_the_port(h5, action):
    J, T = _actions(action)
    cfgs = configurations(action, 6, 2, count=12)
    cfgs['Worm_Length'] = np.arange(12.0)
    ref = jsv.Ensemble(J).from_configurations(jsv.Configurations(cfgs))
    ref.index, ref.index_stride = 10 + 3 * np.arange(12), 3
    ref.generator = (jvf.FusedHammer(J, sweeps_per_step=2, worms=3, p_n=0.25)
                     if action == 'Villain' else jwf.FusedWorldlineUpdate(J, interval_t=2))
    measured = {name: np.asarray(getattr(ref, name)) for name in _measured(action)}
    ref.to_h5(h5.create_group('ensemble'))

    ours = tsv.Ensemble.from_h5(h5['ensemble'], strict=True, device='cpu')
    assert ours.Action == T and len(ours) == 12 and ours.index_stride == 3
    np.testing.assert_array_equal(ours.index, ref.index)
    for k, v in cfgs.items():
        np.testing.assert_array_equal(getattr(ours, k), v)
    assert ours.measured == ref.measured >= set(measured)
    for name, value in measured.items():
        np.testing.assert_array_equal(ours.__dict__[name], value)
        # ...and the port measures the same again on the stored fields.
        fresh = tsv.Ensemble(T).from_configurations(ours.configuration, device='cpu')
        assert_agree(getattr(fresh, name), value)
    assert type(ours.generator).__name__ == type(ref.generator).__name__
    assert PORT_IO.generator_spec(ours.generator)['args'].items() >= \
        JAX_IO.generator_spec(ref.generator)['args'].items()


@pytest.mark.parametrize('action', ['Villain', 'Worldline'])
def test_port_ensemble_reads_in_jax(h5, action):
    J, T = _actions(action, N=4)
    G = (tvf.FusedHammer(T, sweeps_per_step=2, worms=1, p_n=0.5) if action == 'Villain'
         else twf.FusedWorldlineHammer(T, sweeps_per_step=2, interval_v=2))
    ours = tsv.Ensemble(T).generate(6, G, seed=4, device='cpu')
    measured = {name: getattr(ours, name) for name in _measured(action)}
    ours.to_h5(h5.create_group('ensemble'))

    ref = JAX_IO.ensemble_from_h5(h5['ensemble'], strict=True)
    assert ref.Action == J and len(ref) == 6
    for k in ours.configuration.keys():
        np.testing.assert_array_equal(np.asarray(getattr(ref, k)), getattr(ours, k))
    for k in T.fields:
        np.testing.assert_array_equal(ref._final[k], getattr(ours, k)[-1])
    for name, value in measured.items():
        np.testing.assert_array_equal(ref.__dict__[name], value)
    assert JAX_IO.generator_spec(ref.generator) == {
        **PORT_IO.generator_spec(G),
        'args': {k: v for k, v in PORT_IO.generator_spec(G)['args'].items()
                 if k in JAX_IO.h5._SPEC_ARGS.get(type(G).__name__, ())}}
    assert ref.generator._stats == ours.stats


def test_fleets_read_in_either_package(h5):
    fleet = tsv.sample_fused_fleet(tsv.Villain(tsv.Lattice2D(4), 0.5, W=2), chains=3, steps=4,
                                   thin=2, worms=1, keep_fields=True, device='cpu')
    fleet.to_h5(h5.create_group('port'))
    ref = jsv.parallel.fleet.Fleet.from_h5(h5['port'])
    theirs = jsv.parallel.fleet.Fleet(ref.Action, ref.columns, ref.stats, ref.final,
                                      ref.index, ref.weight)
    theirs.to_h5(h5.create_group('jax'))
    back = tsv.Fleet.from_h5(h5['jax'], device='cpu')
    S = fleet.Action
    for f in (ref, back):
        assert (type(f.Action).__name__, f.Action.Lattice.N, f.Action.kappa, f.Action.W) == \
            ('Villain', 4, S.kappa, S.W)
        assert len(f) == 4 and f.chains == 3
        np.testing.assert_array_equal(f.index, fleet.index)
        for k, v in fleet.columns.items():
            np.testing.assert_array_equal(f.columns[k], v)
        for k, v in fleet.final.items():
            np.testing.assert_array_equal(f.final[k], v)
        assert {t: {k: float(x) for k, x in s.items()} for t, s in f.stats.items()} == fleet.stats
    assert back.device == 'cpu'
    assert_agree(back.pooled_ensemble(1).Spin_Spin,
                 np.asarray(jsv.Ensemble(ref.Action).from_configurations(
                     jsv.Configurations({k: v[1:].reshape((-1,) + v.shape[2:])
                                         for k, v in ref.columns.items()})).Spin_Spin))


def test_fleet_extend_h5_appends_records(h5):
    S = tsv.Worldline(tsv.Lattice2D(4), 0.5, W=2)
    a = tsv.sample_fused_fleet(S, chains=2, steps=3, thin=1, worms=1, device='cpu')
    b = tsv.sample_fused_fleet(S, chains=2, steps=2, thin=1, worms=1, seed=1, device='cpu')
    a.to_h5(h5.create_group('fleet'))
    b.extend_h5(h5['fleet'])
    merged = tsv.Fleet.from_h5(h5['fleet'], device='cpu')
    assert len(merged) == 5
    for k in a.columns:
        np.testing.assert_array_equal(merged.columns[k], np.concatenate([a.columns[k],
                                                                         b.columns[k]]))
    np.testing.assert_array_equal(merged.final['m'], b.final['m'])


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_bootstraps_read_in_either_package(h5, writer):
    J, T = _actions('Worldline', N=5)
    cfgs = configurations('Worldline', 5, 2, count=20)
    ref = jsv.Bootstrap(jsv.Ensemble(J).from_configurations(jsv.Configurations(cfgs)),
                        draws=12, seed=9)
    ours = tsv.Bootstrap(tsv.Ensemble(T).from_configurations(tsv.Configurations(cfgs),
                                                             device='cpu'), draws=12, seed=9)
    source, target = (ref, ours) if writer == 'jax' else (ours, ref)
    values = {name: np.asarray(getattr(source, name))
              for name in ('ActionDensity', 'Vortex_Vortex', 'SpinCriticalMoment')}
    source.to_h5(h5.create_group('boot'))
    read = type(target).from_h5(h5['boot'], target.Ensemble)
    np.testing.assert_array_equal(read.indices, source.indices)
    assert read.draws == 12
    for name, value in values.items():
        np.testing.assert_array_equal(read.__dict__[name], value)
        assert_agree(np.asarray(getattr(target, name)), value)


def test_continue_from_resumes_the_stream_in_memory_and_from_a_file(h5):
    """generate(5) then continue_from(5) gives generate(10) bit for bit, from
    the ensemble in memory and from its file; extend_h5 then holds all ten."""
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    G = tv.NeighborhoodUpdate(S, interval_phi=0.5, p_n=0.1)
    full = tsv.Ensemble(S).generate(10, G, seed=7, device='cpu')
    first = tsv.Ensemble(S).generate(5, G, seed=7, device='cpu')
    first.to_h5(h5.create_group('ensemble'))
    for source in (first, h5['ensemble']):
        rest = tsv.Ensemble.continue_from(source, 5, device='cpu')
        np.testing.assert_array_equal(np.concatenate([first.phi, rest.phi]), full.phi)
        np.testing.assert_array_equal(np.concatenate([first.n, rest.n]), full.n)
        np.testing.assert_array_equal(rest.index, full.index[5:])
        assert rest.stats == full.stats
    rest.extend_h5(h5['ensemble'])
    merged = tsv.Ensemble.from_h5(h5['ensemble'], device='cpu')
    np.testing.assert_array_equal(merged.phi, full.phi)
    np.testing.assert_array_equal(merged.index, full.index)
    assert_agree(merged.ActionDensity, full.ActionDensity)
    assert merged.stats == full.stats
    assert tsv.Ensemble.continue_from(merged.cut(2), 1, device='cpu').index[0] == 10


def test_continuing_a_jax_chain_starts_from_its_final_configuration(h5):
    """The JAX package's PRNG key cannot seed a torch stream: the port ignores
    it and continues from the stored final fields."""
    J, T = _actions('Villain', N=4, W=1)
    ref = jsv.Ensemble(J).generate(3, jsv.generators.villain.NeighborhoodUpdate(J), seed=1)
    ref.to_h5(h5.create_group('ensemble'))
    assert 'next_key' in h5['ensemble']
    rest = tsv.Ensemble.continue_from(h5['ensemble'], 2, device='cpu')
    assert len(rest) == 2 and rest.index[0] == ref.index[-1] + 1
    assert isinstance(rest.generator, tv.NeighborhoodUpdate)
    with pytest.raises(ValueError, match='random stream'):
        gpu_chain = tsv.Ensemble(T).generate(1, rest.generator, seed=0, device='cpu')
        gpu_chain._generator_state = ('cuda', gpu_chain._generator_state[1])
        tsv.Ensemble.continue_from(gpu_chain, 1, device='cpu')
    # A strided chain continues strided: every() wraps the generator in KeepEvery.
    strided = tsv.Ensemble.continue_from(rest.every(2), 1, device='cpu')
    assert isinstance(strided.generator, tsv.KeepEvery) and strided.generator.n == 2
    assert strided.index[0] == rest.every(2).index[-1] + 2


def test_generator_specs_round_trip_and_read_in_jax():
    SV = tsv.Villain(tsv.Lattice2D(4), 0.5, W=2)
    SVI = tsv.Villain(tsv.Lattice2D(4), 0.5, W=float('inf'))
    SW = tsv.Worldline(tsv.Lattice2D(4), 0.5, W=2)
    generators = [
        tv.NeighborhoodUpdate(SV, interval_phi=2.5, interval_n=2, p_n=0.0625),
        tv.ExactNeighborhoodUpdate(SVI, interval_phi=1.5, interval_z=2, p_z=0.125),
        tv.ClassicWorm(SV, max_moves=64),
        tvf.FusedNeighborhoodUpdate(SV, interval_phi=2.0, interval_n=2, sweeps_per_step=5,
                                    p_n=0.125),
        tvf.FusedExactNeighborhoodUpdate(SVI, interval_phi=1.0, interval_z=2, sweeps_per_step=3,
                                         p_z=0.25),
        tvf.FusedHammer(SV, sweeps_per_step=2, worms=3, p_n=0.5, max_worm_moves=99),
        tvf.FusedClassicWorm(SV, worms=2, max_worm_moves=17),
        tw.VortexUpdate(SW, interval_v=2), tw.CoexactUpdate(SW, interval_t=2),
        tw.WrappingUpdate(SW, interval_w=2), tw.ClassicWorm(SW, max_moves=30),
        twf.FusedWorldlineUpdate(SW, interval_v=2, interval_t=3, interval_w=2, sweeps_per_step=4),
        twf.FusedWorldlineWorm(SW, worms=2, max_worm_moves=40),
        twf.FusedWorldlineHammer(SW, interval_t=2, sweeps_per_step=3, worms=2, max_worm_moves=50),
    ]
    jax_actions = {SV: jsv.Villain(jsv.Lattice2D(4), 0.5, W=2),
                   SVI: jsv.Villain(jsv.Lattice2D(4), 0.5, W=float('inf')),
                   SW: jsv.Worldline(jsv.Lattice2D(4), 0.5, W=2)}
    for G in generators:
        spec = PORT_IO.generator_spec(G)
        assert PORT_IO.generator_spec(PORT_IO.generator_from_spec(spec, G.Action)) == spec
        theirs = JAX_IO.generator_from_spec(spec, jax_actions[G.Action])
        assert type(theirs).__name__ == type(G).__name__
        for k, v in spec['args'].items():
            assert getattr(theirs, k) == v, (type(G).__name__, k)
    exact = tv.ExactNeighborhoodUpdate(SVI, interval_z=3, p_z=0.5)
    assert (exact.interval_z, exact.p_z) == (exact.interval_n, exact.p_n) == (3, 0.5)


@pytest.mark.parametrize('spec', [
    {'cls': 'NeighborhoodUpdateSlow', 'family': 'reference_implementation', 'args': {}},
    {'cls': 'Hammer', 'family': 'villain', 'args': {}},
    {'cls': 'Sequentially', 'generators': [{'cls': 'VillainClassicWormSlow',
                                            'family': 'reference_implementation',
                                            'args': {}}], 'tags': ['ClassicWorm']}])
def test_a_generator_the_port_lacks_raises_naming_it(spec):
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    name = spec['generators'][0]['cls'] if spec['cls'] == 'Sequentially' else spec['cls']
    with pytest.raises(NotImplementedError, match=name):
        PORT_IO.generator_from_spec(spec, S)


def test_version_check_is_strict_both_ways(h5):
    assert tsv.meta.version == jsv.meta.version
    _, T = _actions('Villain', N=4)
    e = tsv.Ensemble(T).from_configurations(
        tsv.Configurations(configurations('Villain', 4, 2, count=3)), device='cpu')
    e.to_h5(h5.create_group('ensemble'))
    JAX_IO.ensemble_from_h5(h5['ensemble'], strict=True)
    h5['ensemble'].attrs['version'] = 'another'
    with pytest.raises(ValueError, match='Version mismatch'):
        PORT_IO.ensemble_from_h5(h5['ensemble'], strict=True)
    assert len(PORT_IO.ensemble_from_h5(h5['ensemble'], strict=False)) == 3


def test_configurations_round_trip_and_extend(h5):
    c = tsv.Configurations(configurations('Worldline', 4, 2, count=3))
    c.to_h5(h5.create_group('c'))
    c.extend_h5(h5['c'])
    back = tsv.Configurations.from_h5(h5['c'])
    assert len(back) == 6
    np.testing.assert_array_equal(back.m, np.concatenate([c.m, c.m]))


def test_generic_store_reads_in_either_package(h5):
    """Nested payloads with framework objects and tensors, written by the port
    and read by both; a JAX-written Blocking read by the port."""
    J, T = _actions('Villain', N=4)
    cfgs = configurations('Villain', 4, 2, count=8)
    e = tsv.Ensemble(T).from_configurations(tsv.Configurations(cfgs), device='cpu')
    payload = {'action': T, 'lattice': T.Lattice, 'ensemble': e, 'x': torch.arange(3.0),
               'tags': ['a', ('b', 2)], 'none': None, 7: 1.5 + 2j}
    PORT_IO.write(h5, 'payload', payload)
    for io, action in ((PORT_IO, T), (JAX_IO, J)):
        got = io.read(h5['payload'])
        assert got['action'] == action and got['lattice'] == action.Lattice
        np.testing.assert_array_equal(np.asarray(got['ensemble'].phi), cfgs['phi'])
        np.testing.assert_array_equal(got['x'], [0.0, 1.0, 2.0])
        assert got['tags'] == ['a', ('b', 2)] and got['none'] is None and got[7] == 1.5 + 2j

    ref = jsv.Ensemble(J).from_configurations(jsv.Configurations(cfgs))
    blocked = jsv.Blocking(ref, width=2)
    expect = np.asarray(blocked.ActionDensity)
    JAX_IO.write(h5, 'blocking', blocked)
    ours = PORT_IO.read(h5['blocking'])
    assert isinstance(ours, tsv.Blocking) and ours.width == 2
    np.testing.assert_array_equal(ours.__dict__['ActionDensity'], expect)
    ours.Ensemble.device = 'cpu'
    assert_agree(ours.Spin_Spin, np.asarray(blocked.Spin_Spin))
