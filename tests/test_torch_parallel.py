"""The port's chain mesh on the CPU: the chain-mesh cases of
tests/test_parallel.py (shapes and validity, stats aggregated over chains,
pooled ensemble views with a Bootstrap, the h5 round trip of a sharded fleet),
and what the port adds to them: a sharded ``sample_fleet`` or
``sample_fused_fleet`` returns the unsharded fleet bit for bit, at every mesh
size (uneven splits included for ``sample_fleet``), because every draw is
keyed by the chain's global index (the Philox draw sources by ``chain0``, the
generator-backed ones by keeping a shard's rows of the fleet's draw).

Against the JAX package: its ``chain_mesh()`` and the port's
``chain_mesh(['cpu'] * 8)`` split 16 chains into the same contiguous blocks,
and both audits count no collective inside the sharded fleet's records.  The
two packages draw differently, so sameness of results across layouts is a
property of the port alone, held here against its own unsharded run."""

import numpy as np
import pytest
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.parallel import chain_mesh as jax_chain_mesh
from supervillain_tpu_torch.generators import villain as tv, worldline as tw
from supervillain_tpu_torch.ops import kernels, shard
from supervillain_tpu_torch.ops.sweep import KernelSweepDraws, neighborhood_sweeps
from supervillain_tpu_torch.ops.worldline import KernelWorldlineSweepDraws, passes
from supervillain_tpu_torch.ops.worldline_worm import KernelWorldlineWormDraws
from supervillain_tpu_torch.ops.worm import KernelWormDraws
from supervillain_tpu_torch.parallel import (ChainMesh, Fleet, chain_mesh, fleet_sharding,
                                             sample_fleet, sample_fused_fleet)


def cpu_mesh(size):
    return chain_mesh(['cpu'] * size)


def assert_same_fleet(got, want):
    """Columns, final configurations and stats equal bit for bit."""
    assert sorted(got.columns) == sorted(want.columns)
    for k, v in want.columns.items():
        assert got.columns[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got.columns[k], v, err_msg=k)
    assert sorted(got.final) == sorted(want.final)
    for k, v in want.final.items():
        np.testing.assert_array_equal(got.final[k], v, err_msg=k)
    assert got.stats == want.stats
    np.testing.assert_array_equal(got.index, want.index)


FLEETS = {
    'site-update': (lambda: tsv.Villain(tsv.Lattice2D(4), 0.5, W=1), tv.SiteUpdate),
    'villain-hammer-w2': (lambda: tsv.Villain(tsv.Lattice2D(6), 0.5, W=2),
                          lambda S: tv.Hammer(S, fleet=True)),
    'villain-hammer-w1-chunked': (lambda: tsv.Villain(tsv.Lattice2D(5), 0.5, W=1),
                                  lambda S: tv.Hammer(S, fleet=True)),
    'worldline-hammer-w2': (lambda: tsv.Worldline(tsv.Lattice2D(6), 0.5, W=2),
                            lambda S: tw.Hammer(S, fleet=True)),
    'villain-hammer-d3': (lambda: tsv.Villain(tsv.Lattice(3, 4), 0.5, W=2),
                          lambda S: tv.Hammer(S, fleet=True)),
    'worldline-hammer-d3': (lambda: tsv.Worldline(tsv.Lattice(3, 4), 0.3, W=1),
                            lambda S: tw.Hammer(S, fleet=True)),
}
_unsharded = {}


def run_fleet(case, mesh, chains=10):
    build, generator = FLEETS[case]
    S = build()
    return sample_fleet(S, generator(S), chains=chains, steps=3, thin=2, seed=7, mesh=mesh,
                        device='cpu')


def unsharded(case):
    if case not in _unsharded:
        _unsharded[case] = run_fleet(case, None)
    return _unsharded[case]


@pytest.mark.parametrize('size', [1, 2, 3, 4, 8])
@pytest.mark.parametrize('case', sorted(FLEETS))
def test_fleet_results_independent_of_mesh(case, size):
    """10 chains over 1, 2, 3, 4 and 8 shards (uneven blocks from 3 on, and
    empty-free: 8 shards of 1 or 2) give the unsharded fleet bit for bit."""
    fleet = run_fleet(case, cpu_mesh(size))
    assert_same_fleet(fleet, unsharded(case))
    assert fleet.mesh == {'size': size, 'kinds': ['cpu'] * size}


FUSED = {
    'villain-hammer': lambda: tsv.Villain(tsv.Lattice2D(8), 0.5, W=2),
    'worldline-hammer': lambda: tsv.Worldline(tsv.Lattice2D(6), 0.5, W=2),
}
_fused = {}


def run_fused(case, mesh):
    return sample_fused_fleet(FUSED[case](), chains=16, steps=3, thin=2, worms=1,
                              keep_fields=True, seed=3, mesh=mesh, device='cpu')


@pytest.mark.parametrize('size', [1, 2, 4, 8])
@pytest.mark.parametrize('case', sorted(FUSED))
def test_fused_fleet_results_independent_of_mesh(case, size):
    if case not in _fused:
        _fused[case] = run_fused(case, None)
    fleet = run_fused(case, cpu_mesh(size))
    assert_same_fleet(fleet, _fused[case])
    # Shards never replay each other's chains: each shard's first chain's
    # records (fields, worm histograms and lengths) differ.
    first = [b''.join(v[:, c].tobytes() for v in fleet.columns.values())
             for c in range(0, 16, 16 // size)]
    assert len(set(first)) == size


def test_fused_fleet_chains_must_divide_the_mesh():
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    with pytest.raises(ValueError, match='not divisible by 3 mesh devices'):
        sample_fused_fleet(S, chains=16, steps=1, thin=1, mesh=cpu_mesh(3), device='cpu')


def test_fleet_shapes_and_validity():
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    fleet = sample_fleet(S, tv.Hammer(S, fleet=True), chains=16, steps=5, thin=2, seed=3,
                         mesh=cpu_mesh(8), device='cpu')
    assert fleet.columns['phi'].shape == (5, 16, 1, 4, 4)
    assert fleet.chains == 16
    for c in range(0, 16, 5):
        for i in range(5):
            assert S.valid({'n': torch.as_tensor(fleet.columns['n'][i, c])})


def test_fleet_stats_aggregate_over_chains():
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    fleet = sample_fleet(S, tv.SiteUpdate(S), chains=8, steps=3, seed=1, mesh=cpu_mesh(8),
                         device='cpu')
    assert fleet.stats['SiteUpdate']['proposed'] == 8 * 3 * 16
    assert 0 < fleet.stats['SiteUpdate']['accepted'] <= 8 * 3 * 16


def test_fleet_ensemble_views_and_pooling():
    S = tsv.Worldline(tsv.Lattice2D(4), 0.5, W=2)
    fleet = sample_fleet(S, tw.Hammer(S, fleet=True), chains=8, steps=6, seed=9,
                         mesh=cpu_mesh(8), device='cpu')
    e0 = fleet.ensemble(0)
    assert len(e0) == 6
    assert np.isfinite(np.asarray(e0.ActionDensity)).all()
    pooled = fleet.pooled_ensemble(cut=2)
    assert len(pooled) == 4 * 8
    mean, err = tsv.Bootstrap(pooled, draws=20, seed=2).estimate('ActionDensity')
    assert np.isfinite(mean) and err > 0


def test_sharded_fleet_h5_roundtrip(tmp_path):
    h5py = pytest.importorskip('h5py')
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    fleet = sample_fleet(S, tv.SiteUpdate(S), chains=6, steps=3, seed=2, mesh=cpu_mesh(4),
                         device='cpu')
    with h5py.File(tmp_path / 'fleet.h5', 'w') as f:
        fleet.to_h5(f.create_group('fleet'))
        back = Fleet.from_h5(f['fleet'], device='cpu')
    assert_same_fleet(back, fleet)
    assert back.Action == S


def test_a_generator_seed_gives_what_its_state_gives():
    """A torch.Generator as the seed serves the first shard and seeds the
    others' copies from its state: the same fleet as the int seed, and the
    generator advances as an unsharded run advances it."""
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=2)
    by_int = sample_fleet(S, tv.Hammer(S, fleet=True), chains=6, steps=2, seed=11,
                          mesh=cpu_mesh(3), device='cpu')
    g, h = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    by_generator = sample_fleet(S, tv.Hammer(S, fleet=True), chains=6, steps=2, seed=g,
                                mesh=cpu_mesh(3), device='cpu')
    sample_fleet(S, tv.Hammer(S, fleet=True), chains=6, steps=2, seed=h, device='cpu')
    assert_same_fleet(by_generator, by_int)
    assert torch.equal(g.get_state(), h.get_state())


def test_fleet_sharding_is_contiguous_blocks():
    assert fleet_sharding(cpu_mesh(3), 8) == [range(0, 3), range(3, 6), range(6, 8)]
    assert fleet_sharding(cpu_mesh(4), 2) == [range(0, 1), range(1, 2), range(2, 2),
                                              range(2, 2)]
    mesh = ChainMesh(['cpu', 'cpu'], rank=1, world=3)
    assert mesh.size == 6
    assert [b for _, b in mesh.shards(12)] == [range(4, 6), range(6, 8)]


def test_port_and_jax_split_chains_into_the_same_blocks():
    """16 chains over the JAX package's 8 virtual CPU devices and over the
    port's chain_mesh(['cpu'] * 8): the same contiguous block per device."""
    import jax
    from supervillain_tpu.parallel.mesh import fleet_sharding as jax_fleet_sharding

    mesh = jax_chain_mesh()
    assert mesh.devices.size == 8
    x = jax.device_put(np.zeros((16, 1, 4, 4)), jax_fleet_sharding(mesh, 2))
    jax_blocks = sorted((s.index[0].start, s.index[0].stop) for s in x.addressable_shards)
    ours = [(b.start, b.stop) for b in fleet_sharding(cpu_mesh(8), 16)]
    assert ours == jax_blocks


def test_no_collective_inside_records_here_or_in_jax():
    from supervillain_tpu.benchmark.scaling import audit_collectives as jax_audit
    from supervillain_tpu_torch.benchmark.scaling import audit_collectives

    assert all(v == 0 for v in jax_audit(N=8, chains=8, steps=2).values())
    ours = audit_collectives(N=8, chains=8, steps=2, mesh=cpu_mesh(8), device='cpu')
    assert ours == {'inside_records': 0, 'after_records': 0, 'records': 2, 'shards': 8,
                    'processes': 1}


def _draws(source, chain0, B):
    """Every draw of a Philox draw source built for ``B`` chains from ``chain0``."""
    N = 6
    if source == 'sweep':
        d = KernelSweepDraws(99, B=B, N=N, interval_phi=1.0, interval_n=2, p_n=0.3, zmode=False,
                             fdt=torch.float32, idt=torch.int32, device='cpu', chain0=chain0)
        return [v for c in (0, 1, 0) for v in d(c).values()]
    if source == 'worldline_sweep':
        d = KernelWorldlineSweepDraws(99, B=B, N=N, interval_v=1, interval_t=1, interval_w=1,
                                      winf=False, fdt=torch.float32, idt=torch.int32,
                                      device='cpu', chain0=chain0)
        return [v for kind, index, _ in passes(tsv.Lattice2D(N))
                for v in d(kind, index).values()]
    cls = KernelWormDraws if source == 'worm' else KernelWorldlineWormDraws
    d = cls(99, B=B, N=N, device='cpu', chain0=chain0)
    out = []
    for _ in range(2):
        out += list(d.start())
        for _ in range(300):
            out += list(d.move())
    return out


@pytest.mark.parametrize('source', ['sweep', 'worm', 'worldline_sweep', 'worldline_worm'])
def test_philox_draws_of_a_shard_are_rows_of_the_batch(source):
    whole = _draws(source, 0, 8)
    part = _draws(source, 3, 5)
    assert len(whole) == len(part)
    for a, b in zip(whole, part):
        torch.testing.assert_close(b, a[3:], rtol=0, atol=0)


def test_worldline_worm_draws_at_d3_to_d5_extend_the_d2_stream():
    """At D >= 3 the Philox worm draws keep the D=2 stream's orientation and
    first two tail coordinates, and choose among the 2D moves."""
    o2, tail2 = KernelWorldlineWormDraws(5, B=4, N=6, device='cpu').start()
    for D in (3, 4, 5):
        d = KernelWorldlineWormDraws(5, B=4, N=6, device='cpu', D=D)
        o, tail = d.start()
        assert torch.equal(o, o2) and torch.equal(tail[:, :2], tail2) and tail.shape == (4, D)
        choice = d.move()[1]
        assert bool(((choice >= 0) & (choice < 2 * D)).all())


@pytest.mark.parametrize('axis', [0, 1])
def test_shard_generator_keeps_its_rows_of_the_fleet(axis):
    shape = [3, 3]
    shape[axis] = 10
    g = torch.Generator().manual_seed(4)
    whole = (torch.rand(shape, generator=g), torch.randint(-3, 4, shape, generator=g))
    part = list(shape)
    part[axis] = 4
    s = shard.ShardGenerator(torch.Generator().manual_seed(4), 5, 10)
    got = (shard.rand(s, part, device='cpu', axis=axis),
           shard.randint(s, -3, 4, part, device='cpu', axis=axis))
    for w, h in zip(whole, got):
        assert torch.equal(h, w.narrow(axis, 5, 4))
    assert torch.equal(s.generator.get_state(), g.get_state())
    with pytest.raises(ValueError, match='exceed'):
        shard.rand(s, [6, 3], device='cpu')


def test_a_cpu_batch_refuses_a_chain0_its_generator_does_not_have():
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    cold = {k: v.expand(2, *v.shape).contiguous() for k, v in S.initial('cpu').items()}
    args = dict(kappa=0.5, W=1, interval_phi=1.0, interval_n=1, sweeps=1)
    with pytest.raises(ValueError, match='ShardGenerator'):
        neighborhood_sweeps(cold['phi'], cold['n'], generator=torch.Generator(), chain0=3,
                            **args)
    g = shard.ShardGenerator(torch.Generator(), 3, 5)
    assert neighborhood_sweeps(cold['phi'], cold['n'], generator=g, chain0=3, **args)[0].shape \
        == cold['phi'].shape
    with pytest.raises(ValueError, match='32-bit'):
        kernels.chain_word(2 ** 32 - 1, 2)


def test_chain_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="chain_mesh\\(\\['cpu'\\]\\)"):
        chain_mesh()
