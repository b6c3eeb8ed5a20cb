"""The port's space axis on the CPU: one chain's lattice split into slabs.

``chain_space_mesh(c, s, ['cpu'] * (c·s))`` meshes of CPU shards, (c, s) ∈
{(1, 2), (2, 2), (1, 4)}: the W=2, W=1 and W=∞ Villain ``Hammer(fleet=True)``,
Site and Cohomology updates where windings move, and the W=2 Worldline
``Hammer`` at N=8, and ``NeighborhoodUpdate`` at N=16, each equal
over 3 records to the unsharded fleet bit for bit on every field (the stats,
sums over slabs, to 1e-12 relative), with dn ≡ 0 (mod W), dn = 0 at W=∞ and
δm = 0 held on every record; halo exchanges counted.  B1's slab entry on its
plain path: each slab's pass equals the whole torus's pass on the slab's own
columns.  ``sample_fused_fleet`` refuses a space mesh, and an N that does not
split into slabs of even width is refused.  Against the JAX package: its
``chain_space_mesh`` refuses a device count as the port's does, and the
sharded W=2 Villain fleet's ⟨ActionDensity⟩ lies within 4σ of its
``Hammer(S, fleet=True)`` fleet's.  Two gloo ranks holding one slab each
return the single-process fleet bit for bit, under a time limit."""

import os
import pickle
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.generators import villain as jv
from supervillain_tpu.parallel import sample_fleet as jax_sample_fleet
from supervillain_tpu.parallel.mesh import chain_space_mesh as jax_chain_space_mesh
from supervillain_tpu_torch.generators import villain as tv, worldline as tw
from supervillain_tpu_torch.ops import calculus as tcalc
from supervillain_tpu_torch import tracing
from supervillain_tpu_torch.ops import shard
from supervillain_tpu_torch.ops.sweep import (KernelSweepDraws, SweepDraws, color_pass,
                                              plain_slab_pass, slab_pass, slab_residual)
from supervillain_tpu_torch.parallel import (chain_mesh, chain_space_mesh, fleet_sharding,
                                             sample_fleet, sample_fused_fleet, space)

MESHES = [(1, 2), (2, 2), (1, 4)]


def calls(name):
    """The calls counted in ``name`` by the port's registry."""
    return tracing.counters().get(name, 0)


CASES = {
    # κ = 0.1: the links' n move (at κ = 0.5 and W=2 they stay 0 over 3 records).
    'villain-hammer-w2': (lambda: tsv.Villain(tsv.Lattice2D(8), 0.1, W=2),
                          lambda S: tv.Hammer(S, fleet=True)),
    'villain-hammer-w2-kappa0.5': (lambda: tsv.Villain(tsv.Lattice2D(8), 0.5, W=2),
                                   lambda S: tv.Hammer(S, fleet=True)),
    'villain-hammer-w1': (lambda: tsv.Villain(tsv.Lattice2D(8), 0.1, W=1),
                          lambda S: tv.Hammer(S, fleet=True)),
    'villain-hammer-winf': (lambda: tsv.Villain(tsv.Lattice2D(8), 0.5, W=float('inf')),
                            lambda S: tv.Hammer(S, fleet=True)),
    # κ = 0.01: the winding moves of CohomologyUpdate are accepted.
    'villain-cohomology': (lambda: tsv.Villain(tsv.Lattice2D(8), 0.01, W=1),
                           lambda S: tsv.Sequentially([tv.SiteUpdate(S),
                                                       tv.CohomologyUpdate(S)])),
    'worldline-hammer-w2': (lambda: tsv.Worldline(tsv.Lattice2D(8), 0.5, W=2),
                            lambda S: tw.Hammer(S, fleet=True)),
    'neighborhood-n16': (lambda: tsv.Villain(tsv.Lattice2D(16), 0.5, W=2),
                         tv.NeighborhoodUpdate),
}
#: Seconds the two ranks may take (about 10 s on a CPU host).
LIMIT = 120


def cpu_space_mesh(c, s):
    return chain_space_mesh(c, s, ['cpu'] * (c * s))


def run(case, mesh, chains=4, steps=3, seed=11):
    build, generator = CASES[case]
    S = build()
    return S, sample_fleet(S, generator(S), chains=chains, steps=steps, thin=1, seed=seed,
                           mesh=mesh, device='cpu')


_unsharded = {}


def unsharded(case):
    if case not in _unsharded:
        _unsharded[case] = run(case, None)[1]
    return _unsharded[case]


def assert_same_fields(got, want):
    """Columns and final fields bit for bit; stats to 1e-12 relative."""
    assert sorted(got.columns) == sorted(want.columns)
    for k, v in want.columns.items():
        assert got.columns[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got.columns[k], v, err_msg=k)
    assert sorted(got.final) == sorted(want.final)
    for k, v in want.final.items():
        np.testing.assert_array_equal(got.final[k], v, err_msg=k)
    assert sorted(got.stats) == sorted(want.stats)
    for tag, s in want.stats.items():
        for k, v in s.items():
            assert got.stats[tag][k] == pytest.approx(v, rel=1e-12, abs=1e-300), (tag, k)
    np.testing.assert_array_equal(got.index, want.index)


def assert_invariants(S, fleet):
    """dn ≡ 0 (mod W), dn = 0 at W=∞ (Villain), δm = 0 (Worldline), on every record."""
    L = S.Lattice
    if isinstance(S, tsv.Worldline):
        m = torch.as_tensor(fleet.columns['m'])
        assert torch.all(tcalc.delta(L, 1, m) == 0)
        return
    dn = tcalc.d(L, 1, torch.as_tensor(fleet.columns['n']))
    if S.W == float('inf'):
        assert torch.all(dn == 0)
    else:
        assert torch.all(torch.remainder(dn, int(S.W)) == 0)


@pytest.mark.parametrize('mesh', MESHES, ids=lambda m: f'{m[0]}x{m[1]}')
@pytest.mark.parametrize('case', sorted(CASES))
def test_space_sharded_fleet_is_the_unsharded_one(case, mesh):
    before = calls('space.halo_exchange')
    S, fleet = run(case, cpu_space_mesh(*mesh))
    assert_same_fields(fleet, unsharded(case))
    assert_invariants(S, fleet)
    assert calls('space.halo_exchange') > before
    assert fleet.mesh == {'size': mesh[0] * mesh[1], 'kinds': ['cpu'] * (mesh[0] * mesh[1]),
                          'shape': mesh}


def test_fields_move_and_the_worms_run_gathered():
    """The records change the fields (not a cold start carried through), the
    Hammer's worm runs on the gathered chain (a gather and a scatter a step)
    and CohomologyUpdate gathers its slices (one gather a step)."""
    gathers, scatters = calls('space.gather_chain'), calls('space.scatter_chain')
    slices = calls('space.gather_slices')
    S, fleet = run('villain-hammer-w2', cpu_space_mesh(1, 2))
    assert np.any(fleet.columns['n'] != 0) and np.any(fleet.columns['phi'] != 0)
    assert fleet.stats['ClassicWorm']['accepted'] > 0
    assert fleet.stats['CohomologyUpdate']['proposed'] > 0
    assert calls('space.gather_chain') - gathers == 3
    assert calls('space.scatter_chain') - scatters == 3
    assert calls('space.gather_slices') - slices == 3
    _, fleet = run('villain-cohomology', cpu_space_mesh(1, 2))
    assert fleet.stats['CohomologyUpdate']['accepted'] > 0


@pytest.mark.parametrize('N,space_,ok', [(8, 2, True), (8, 4, True), (12, 4, False),
                                        (10, 4, False), (6, 2, False), (12, 3, True)])
def test_a_torus_that_does_not_split_into_even_slabs_is_refused(N, space_, ok):
    S = tsv.Villain(tsv.Lattice2D(N), 0.5, W=1)
    mesh = cpu_space_mesh(1, space_)

    def go():
        return sample_fleet(S, tv.SiteUpdate(S), chains=2, steps=1, mesh=mesh, device='cpu')

    if ok:
        assert go().final['phi'].shape == (2, 1, N, N)
    else:
        with pytest.raises(ValueError, match='slabs of even width'):
            go()


def test_fused_fleet_refuses_a_space_mesh():
    S = tsv.Villain(tsv.Lattice2D(8), 0.5, W=1)
    with pytest.raises(ValueError, match='space axis'):
        sample_fused_fleet(S, chains=2, steps=1, mesh=cpu_space_mesh(1, 2), device='cpu')


def test_mesh_shape_and_sharding_match_jax():
    with pytest.raises(ValueError, match=r'chains\*space = 4 != 3 devices') as ours:
        chain_space_mesh(2, 2, ['cpu'] * 3)
    with pytest.raises(ValueError) as theirs:
        jax_chain_space_mesh(2, 2, [jax.devices()[0]] * 3)
    assert str(ours.value) == str(theirs.value)
    mesh = cpu_space_mesh(2, 2)
    assert mesh.axis_names == ('chains', 'space') and mesh.size == 4
    assert fleet_sharding(mesh, 5) == [range(0, 3), range(0, 3), range(3, 5), range(3, 5)]
    assert fleet_sharding(mesh, 5, spatial=True, N=8) == [
        (range(0, 3), range(0, 4)), (range(0, 3), range(4, 8)),
        (range(3, 5), range(0, 4)), (range(3, 5), range(4, 8))]


@pytest.mark.parametrize('W', [2, float('inf')])
@pytest.mark.parametrize('space_', [2, 4])
def test_slab_pass_is_the_torus_pass_on_its_columns(W, space_):
    """B1's slab entry on its plain path: two color passes on padded slabs,
    with the ghosts refilled from the torus before the second, equal on each
    slab's own columns to the whole torus's passes on the same draws."""
    N, B = 16, 3
    rng = np.random.default_rng(4)
    phi = torch.as_tensor(rng.normal(size=(B, 1, N, N)) * 2)
    n = torch.as_tensor(rng.integers(-1, 2, size=(B, 2, N, N)))
    draws = KernelSweepDraws(99, B=B, N=N, interval_phi=np.pi, interval_n=1, p_n=None,
                             zmode=W == float('inf'), fdt=phi.dtype, idt=n.dtype, device='cpu')
    passes = [draws(0), draws(1)]
    r = tcalc.d(tsv.Lattice2D(N), 0, phi) - 2 * np.pi * n.double()
    whole = [(phi, n, r)]
    for color in (0, 1):
        p, m, rr, _ = color_pass(*whole[-1], color, passes[color], kappa=0.5, W=W)
        whole.append((p, m, rr))
    width = N // space_
    for s in range(space_):
        slab = shard.Slab(N, s * width, width, space.GHOST)
        fields = [slab.cut(x) for x in (phi, n)]
        state = (*fields, slab_residual(*fields))
        accepted = 0
        for color in (0, 1):
            if color:   # the halo exchange: the ghosts refilled with the torus's values
                state = tuple(torch.cat([slab.cut(w)[..., :space.GHOST], slab.own(x),
                                         slab.cut(w)[..., -space.GHOST:]], dim=-1)
                              for x, w in zip(state, whole[1]))
            cut = {k: slab.cut(v) for k, v in passes[color].items()}
            *state, acc = plain_slab_pass(*state, color, cut, slab, kappa=0.5, W=W)
            accepted = accepted + acc
        for got, want in zip(state, whole[2]):
            assert torch.equal(slab.own(got), slab.own(slab.cut(want)))


def test_slab_pass_on_the_cpu_draws_from_the_slab_generator():
    """The CPU path of slab_pass draws the torus's numbers through a
    SlabGenerator and cuts them: the same pass as plain_slab_pass on
    SweepDraws of a whole-torus generator seeded alike."""
    N, B = 8, 2
    slab = shard.Slab(N, 4, 4, space.GHOST)
    phi = torch.zeros((B, 1, N, slab.padded), dtype=torch.float64)
    n = torch.zeros((B, 2, N, slab.padded), dtype=torch.int64)
    r = slab_residual(phi, n)
    g = shard.SlabGenerator(torch.Generator().manual_seed(5), 0, B, slab)
    got = slab_pass(phi, n, r, 1, kappa=0.5, W=2, interval_phi=np.pi, interval_n=1, p_n=None,
                    generator=g)
    draws = SweepDraws(torch.Generator().manual_seed(5), B=B, N=N, interval_phi=np.pi,
                       interval_n=1, p_n=None, zmode=False, fdt=phi.dtype, idt=n.dtype,
                       device='cpu')(1)
    want = plain_slab_pass(phi, n, r, 1, {k: slab.cut(v) for k, v in draws.items()}, slab,
                           kappa=0.5, W=2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match='chains_view'):
        shard.rand(g, (B, 5), device='cpu')


def test_sharded_action_density_agrees_with_jax():
    """The space-sharded W=2 Villain Hammer(fleet=True) at N=8 (mesh 1×2, 32
    chains × 40 records): the mean of per-chain means of ActionDensity after
    a cut of 10 lies within 4 combined standard errors of the JAX package's
    Hammer(S, fleet=True) fleet of the same shape."""
    args = dict(chains=32, steps=40, thin=1)
    cut = 10
    T = tsv.Villain(tsv.Lattice2D(8), 0.5, W=2)
    J = jsv.Villain(jsv.Lattice2D(8), 0.5, W=2)
    ours = sample_fleet(T, tv.Hammer(T, fleet=True), seed=2, mesh=cpu_space_mesh(1, 2),
                        device='cpu', **args)
    theirs = jax_sample_fleet(J, jv.Hammer(J, fleet=True), seed=2, **args)

    def per_chain(module, S, fleet):
        fields = {k: fleet.columns[k][cut:] for k in S.fields}
        records, chains = fields['phi'].shape[:2]
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in fields.items()}
        where = {'device': 'cpu'} if module is tsv else {}
        e = module.Ensemble(S).from_configurations(module.Configurations(flat), **where)
        return np.asarray(e.ActionDensity).reshape(records, chains).mean(axis=0)

    a, b = per_chain(tsv, T, ours), per_chain(jsv, J, theirs)
    se = np.hypot(a.std(ddof=1), b.std(ddof=1)) / np.sqrt(args['chains'])
    assert abs(a.mean() - b.mean()) < 4 * se, (a.mean(), b.mean(), se)


# -- two processes, one slab each -----------------------------------------------------

def _two_rank_runs(mesh):
    out = {}
    for case in ('villain-hammer-w2', 'worldline-hammer-w2', 'neighborhood-n16'):
        _, fleet = run(case, mesh)
        out[case] = {'columns': fleet.columns, 'final': fleet.final, 'stats': fleet.stats,
                     'mesh': fleet.mesh}
    return out


def _rank(rank, init, out):
    os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    torch.set_num_threads(1)
    from supervillain_tpu_torch.parallel import distributed

    distributed.initialize(init, 2, rank)
    mesh = chain_space_mesh(1, 2, ['cpu'])
    result = _two_rank_runs(mesh)
    result['halo exchanges'] = calls('space.halo_exchange')
    with open(os.path.join(out, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(result, f)
    torch.distributed.destroy_process_group()


def test_two_ranks_with_a_slab_each_return_the_unsharded_fleet(tmp_path):
    context = mp.start_processes(_rank, args=('file://' + str(tmp_path / 'init'),
                                              str(tmp_path)),
                                 nprocs=2, join=False, start_method='spawn')
    deadline = time.monotonic() + LIMIT
    try:
        while not context.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f'the two ranks did not finish within {LIMIT} s')
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    for rank in range(2):
        with open(tmp_path / f'rank{rank}.pkl', 'rb') as f:
            got = pickle.load(f)
        assert got['halo exchanges'] > 0
        for case in ('villain-hammer-w2', 'worldline-hammer-w2', 'neighborhood-n16'):
            want = unsharded(case)
            mine = got[case]
            assert mine['mesh'] == {'size': 2, 'kinds': ['cpu', 'cpu'], 'shape': (1, 2)}
            for part in ('columns', 'final'):
                assert sorted(mine[part]) == sorted(getattr(want, part))
                for k, v in getattr(want, part).items():
                    np.testing.assert_array_equal(mine[part][k], v, err_msg=f'{case} {k}')
            for tag, s in want.stats.items():
                for k, v in s.items():
                    assert mine['stats'][tag][k] == pytest.approx(v, rel=1e-12, abs=1e-300)


@pytest.mark.cuda
def test_slab_kernel_is_the_whole_torus_kernel_on_its_columns():
    """On the card: NeighborhoodUpdate over cuda:0 listed twice as a 1×2 mesh
    launches B1's slab entry and gives the unsharded fleet's fields bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from supervillain_tpu_torch.ops.sweep import slab_pass as entry
    S = tsv.Villain(tsv.Lattice2D(64), 0.5, W=2)
    want = sample_fleet(S, tv.NeighborhoodUpdate(S), chains=4, steps=3, seed=1, device='cuda')
    before = entry.launches
    got = sample_fleet(S, tv.NeighborhoodUpdate(S), chains=4, steps=3, seed=1,
                       mesh=chain_space_mesh(1, 2, ['cuda:0'] * 2))
    assert entry.launches > before
    assert_same_fields(got, want)


def test_space_audit_counts_halo_exchanges_and_the_chain_audit_none():
    """benchmark/scaling.py's space audit on the CPU: one record of the W=2
    Hammer on a 1×4 mesh makes halo exchanges (two a local update's step, one
    more a later pass) and a gather and a scatter per update that is not
    local, and no cross-process call; the chain-only audit counts no
    collective inside the records."""
    from supervillain_tpu_torch.benchmark.scaling import (audit_collectives,
                                                          audit_space_collectives)
    got = audit_space_collectives(N=8, space=4, device='cpu')
    # Site (2 passes), Link (1), Exact (2): 2 + 1 + 2 halo exchanges;
    # Cohomology's slices gathered, the worm's chain gathered and scattered.
    assert got == {'halo_exchanges': 5, 'slice_gathers': 1, 'chain_gathers': 1,
                   'chain_scatters': 1, 'cross_process_calls': 0, 'N': 8, 'space': 4,
                   'steps': 1}
    chain = audit_collectives(N=4, chains=4, steps=2, mesh=chain_mesh(['cpu'] * 2), device='cpu')
    assert chain['inside_records'] == 0


def test_the_space_axis_is_d2_only():
    S = tsv.Villain(tsv.Lattice(3, 4), 0.5, W=1)
    with pytest.raises(NotImplementedError, match='D=2'):
        sample_fleet(S, tv.SiteUpdate(S), chains=2, steps=1, mesh=cpu_space_mesh(1, 2),
                     device='cpu')
