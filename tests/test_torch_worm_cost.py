"""The port's benchmark/worm_cost.py against the JAX package's, on the CPU.

``worm_share`` at N = 4 and 8, W = 1 and 2: the JAX function's keys, a worm
share in [0, 1] and ``worm_length_max`` at least ``worm_length_mean``; at W=2
(N=8, 64 chains × 5 steps) the mean worm length within 4 combined standard
errors of the JAX function's with the same arguments (the two packages draw
differently); the CLI prints one JSON line per (L, W), and with
``--chunked`` only W=1's."""

import json

import numpy as np
import pytest

from supervillain_tpu.benchmark import worm_cost as jwc
from supervillain_tpu_torch.benchmark import worm_cost as twc


@pytest.mark.parametrize('W', [1, 2])
@pytest.mark.parametrize('N', [4, 8])
def test_worm_share_has_the_jax_keys(N, W):
    ours = twc.worm_share(N, 8, steps=3, W=W, reps=1, device='cpu')
    theirs = jwc.worm_share(N, 8, steps=3, W=W, reps=1)
    assert list(ours) == list(theirs)
    for k in ('N', 'chains', 'steps', 'kappa', 'W', 'worm'):
        assert ours[k] == theirs[k]
    assert 0.0 <= ours['worm_share'] <= 1.0
    assert ours['worm_length_max'] >= ours['worm_length_mean'] > 0
    assert ours['t_full_s'] > 0 and ours['t_local_s'] > 0


def test_chunked_worm_share():
    ours = twc.worm_share(8, 4, steps=2, W=1, reps=1, worm_moves=8, device='cpu')
    assert ours['worm'] == 'chunked(8)' and 0.0 <= ours['worm_share'] <= 1.0
    assert ours['worm_length_max'] <= 8


def test_w2_mean_worm_length_agrees_with_jax():
    import supervillain_tpu_torch as tsv
    from supervillain_tpu_torch.generators import villain as tv

    chains, steps = 64, 5
    ours = twc.worm_share(8, chains, steps=steps, W=2, reps=1, device='cpu')
    theirs = jwc.worm_share(8, chains, steps=steps, W=2, reps=1)
    S = tsv.Villain(tsv.Lattice2D(8), 0.5, 2)
    _, keeps = twc._timed_fleet(tv.Hammer(S), S, chains, steps, reps=1,
                                collect_inline=('Worm_Length',), device='cpu')
    lengths = keeps['Worm_Length']
    se = lengths.std(ddof=1) * np.sqrt(2 / lengths.size)
    assert abs(ours['worm_length_mean'] - theirs['worm_length_mean']) < 4 * se


def test_cli_prints_a_json_line_per_size_and_w(capsys):
    twc.main(['--L', '4', '6', '--W', '1', '2', '--chains', '4', '--steps', '2', '--reps', '1',
              '--device', 'cpu'])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r['N'], r['W']) for r in lines] == [(4, 1), (4, 2), (6, 1), (6, 2)]
    assert all(r['device'] == 'cpu' and 'synchronise' in r['timed'] for r in lines)
    twc.main(['--L', '4', '--W', '1', '2', '--chains', '4', '--steps', '2', '--reps', '1',
              '--chunked', '4', '--device', 'cpu'])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r['N'], r['W'], r['worm']) for r in lines] == [(4, 1, 'chunked(4)')]
