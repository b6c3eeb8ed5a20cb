"""Two processes on the CPU: a fleet whose chain mesh spans two gloo ranks.

Each rank of a ``torch.multiprocessing`` group (file ``init_method`` under the
test's temporary directory) runs ``sample_fleet`` and ``sample_fused_fleet``
at N=4 with 8 chains over ``chain_mesh(['cpu'])``, and 7 chains over two
shards a rank (uneven blocks across processes), one chain (a rank with
none), the collective audit, and the weak-scaling table with rank 1 slowed.
Both ranks must return the single-process unsharded fleet bit for bit, and
count no collective inside the records (one gather after them); the scaling
table must time the group by its slowest rank.  The group is spawned once for
the module and joined under a time limit: a rank that fails or hangs fails
the tests."""

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import supervillain_tpu_torch as tsv
from supervillain_tpu_torch.generators import villain as tv, worldline as tw

#: Seconds a group of two ranks may take (the whole test takes about 15 s on
#: a CPU host).
LIMIT = 120

#: Seconds by which rank 1 ends each record of the scaling table late.
SLOW = 0.5


def _fleet(S, G, mesh, chains=8):
    return tsv.sample_fleet(S, G, chains=chains, steps=3, thin=2, seed=5, mesh=mesh,
                            device='cpu')


def _fused(mesh):
    return tsv.sample_fused_fleet(tsv.Villain(tsv.Lattice2D(4), 0.5, W=2), chains=8, steps=3,
                                  thin=2, worms=1, keep_fields=True, seed=6, mesh=mesh,
                                  device='cpu')


def _actions():
    return tsv.Villain(tsv.Lattice2D(4), 0.5, W=2), tsv.Worldline(tsv.Lattice2D(4), 0.5, W=2)


def _runs(mesh, wide_mesh):
    V, Wl = _actions()
    return {'villain': _fleet(V, tv.Hammer(V, fleet=True), mesh),
            'worldline': _fleet(Wl, tw.Hammer(Wl, fleet=True), mesh),
            'uneven': _fleet(V, tv.SiteUpdate(V), wide_mesh, chains=7),
            'one chain': _fleet(V, tv.SiteUpdate(V), mesh, chains=1),
            'fused': _fused(mesh)}


def _payload(fleet):
    return {'columns': fleet.columns, 'final': fleet.final, 'stats': fleet.stats,
            'mesh': fleet.mesh}


def _rank(rank, init, out):
    os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    torch.set_num_threads(1)
    from supervillain_tpu_torch.benchmark import scaling
    from supervillain_tpu_torch.benchmark.scaling import audit_collectives
    from supervillain_tpu_torch.parallel import chain_mesh, distributed

    assert distributed.initialize(init, 2, rank)[:2] == (rank, 2)
    mesh = chain_mesh(['cpu'])
    result = {k: _payload(f) for k, f in _runs(mesh, chain_mesh(['cpu', 'cpu'])).items()}
    # With no mesh, a group of processes shards the fleet over its ranks.
    V, _ = _actions()
    result['default'] = _payload(_fleet(V, tv.SiteUpdate(V), None))
    result['audit'] = audit_collectives(N=4, chains=8, steps=3, mesh=mesh, device='cpu')
    if rank == 1:
        # Rank 1 ends each record SLOW seconds late: the group's row must show it.
        scaling._synchronize = lambda mesh: time.sleep(SLOW)
    result['scaling'] = scaling.scaling_efficiency(N=4, chains_per_device=2, steps=2,
                                                   device='cpu')
    with open(os.path.join(out, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(result, f)
    torch.distributed.destroy_process_group()


def _spawn(tmp_path):
    """Run both ranks under LIMIT seconds; return what each wrote."""
    context = mp.start_processes(_rank, args=('file://' + str(tmp_path / 'init'), str(tmp_path)),
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
    assert not any(p.is_alive() for p in context.processes)
    out = []
    for rank in range(2):
        with open(tmp_path / f'rank{rank}.pkl', 'rb') as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """What each of the two ranks wrote (spawned once for the module)."""
    return _spawn(tmp_path_factory.mktemp('ranks'))


def test_two_ranks_return_the_unsharded_fleet(ranks):
    want = _runs(None, None)
    V, _ = _actions()
    want['default'] = _fleet(V, tv.SiteUpdate(V), None)
    for got in ranks:
        for name, fleet in want.items():
            have = got[name]
            for part in ('columns', 'final'):
                assert sorted(have[part]) == sorted(getattr(fleet, part)), (name, part)
                for k, v in getattr(fleet, part).items():
                    np.testing.assert_array_equal(have[part][k], v, err_msg=f'{name} {k}')
            assert have['stats'] == fleet.stats, name
        assert got['villain']['mesh'] == {'size': 2, 'kinds': ['cpu', 'cpu']}
        assert got['uneven']['mesh']['size'] == 4
        assert got['default']['mesh']['size'] == 2
        # No collective inside the records; the one gather after them.
        assert got['audit'] == {'inside_records': 0, 'after_records': 1, 'records': 3,
                                'shards': 2, 'processes': 2}


def test_scaling_times_the_group_by_its_slowest_rank(ranks):
    """The one-card row is rank 0 alone; the group's row starts both ranks at
    a barrier and ends with the slower, rank 1, whose records end SLOW late."""
    tables = [got['scaling'] for got in ranks]
    for table in tables:
        assert [row['devices'] for row in table] == [1, 2]
        assert [row['chains'] for row in table] == [2, 4]
    alone, group = tables[0]
    assert alone['efficiency'] is None
    # Rank 0 alone never waits for rank 1's delay; the group cannot be faster
    # than 4 chains x 2 sweeps in SLOW seconds.
    assert alone['sweeps_per_s'] > 2 * 2 / SLOW
    assert group['sweeps_per_s'] <= 4 * 2 / SLOW
    assert group['efficiency'] == group['sweeps_per_s'] / 2 / alone['sweeps_per_s']
    assert len(alone['record_seconds_by_process']) == 1
    slow = group['record_seconds_by_process']
    assert len(slow) == 2 and slow[1] >= SLOW and group['sweeps_per_s'] == 4 * 2 / max(slow)
    for key in ('sweeps_per_s', 'seconds_with_gather'):
        assert tables[1][0][key] == alone[key] and tables[1][1][key] == group[key], key
