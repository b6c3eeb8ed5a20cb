"""A run with the timed path broken underneath comes out not correct, once for
each fault a cell can have.  The run skips its look for a card and drives the
program's plain path on the CPU as the card runs it (``card_on_cpu``)."""

import numpy as np
import pytest

from perfbench import run
from perfbench.tests.conftest import TINY
from supervillain_tpu_torch.parallel import fused_fleet

ONE_CARD = ['villain-l256-w1', 'worldline-l256-w2', 'villain-l1024-w2']


def broken_launch(monkeypatch, fault):
    """Wrap both actions' record launch with ``fault(launch, fields, rng)``."""
    for name in ('_villain_launch', '_worldline_launch'):
        make = getattr(fused_fleet, name)

        def wrapped(action, *, _make=make, **options):
            launch = _make(action, **options)
            return lambda a, b, rng: fault(launch, a, b, rng)
        monkeypatch.setattr(fused_fleet, name, wrapped)


def unchanged(launch, a, b, rng):
    """The step returns its state unchanged (its inline columns as computed)."""
    _, _, accepted, inline = launch(a, b, rng)
    return a, b, accepted, inline


def half_left_out(launch, a, b, rng):
    """Half of the batch left out: the first half steps, and the rest keep
    their state and take the first half's inline columns."""
    half = a.shape[0] // 2
    a1, b1, accepted, inline = launch(a[:half], b[:half], rng)
    rest = a.shape[0] - half
    a, b = a.clone(), b.clone()
    a[:half], b[:half] = a1, b1
    pad = {k: v[np.arange(rest) % half] for k, v in inline.items()}
    inline = {k: fused_fleet.torch.cat([v, pad[k]]) for k, v in inline.items()}
    return a, b, fused_fleet.torch.cat([accepted, accepted[:rest]]), inline


def altered(launch, a, b, rng):
    """An answer altered where it is produced: every record's first column off
    by one part in a thousand (a worm length by one)."""
    a, b, accepted, inline = launch(a, b, rng)
    inline = dict(inline)
    if 'Worm_Length' in inline:
        inline['Worm_Length'] = inline['Worm_Length'] + 1
    else:
        inline['ActionDensity'] = inline['ActionDensity'] * 1.001
    return a, b, accepted, inline


def judged(cell, seed=2 ** 31 + 99):
    return run.run(cell, seed, 3.0, False, device='cpu', overrides=TINY[cell])


@pytest.mark.parametrize('fault', [unchanged, half_left_out, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize('cell', ONE_CARD + ['villain-pod-l64-4card'])
def test_a_broken_step_is_not_correct(cell, fault, card_on_cpu, monkeypatch):
    broken_launch(monkeypatch, fault)
    result = judged(cell)
    assert result['correct'] is False, result['checked']


def test_the_exchange_between_cards_left_out_is_not_correct(card_on_cpu, monkeypatch):
    """The chain mesh's gather of its shards' records left out: every shard's
    rows are the first shard's."""
    join = fused_fleet.join
    monkeypatch.setattr(fused_fleet, 'join', lambda parts, axis=0: join([parts[0]] * len(parts),
                                                                          axis=axis))
    result = judged('villain-pod-l64-4card')
    assert result['correct'] is False, result['checked']


def last_shard_rows_stale(monkeypatch):
    """The gather takes the last shard's rows from the first shard."""
    join = fused_fleet.join
    monkeypatch.setattr(fused_fleet, 'join',
                        lambda parts, axis=0: join(parts[:-1] + parts[:1], axis=axis))


def last_shard_chain0_wrong(monkeypatch):
    """The last shard draws from the first chain's streams: a wrong chain0."""
    made = []

    def shard_generator(generator, chain0, chains):
        made.append(chain0)
        return Shard(generator, 0 if len(made) % SHARDS == 0 else chain0, chains)
    Shard = fused_fleet.ShardGenerator
    monkeypatch.setattr(fused_fleet, 'ShardGenerator', shard_generator)


SHARDS = TINY['villain-pod-l64-4card']['shards']


@pytest.mark.parametrize('fault', [last_shard_rows_stale, last_shard_chain0_wrong],
                         ids=lambda f: f.__name__)
def test_a_fault_on_one_card_alone_is_not_correct(fault, card_on_cpu, monkeypatch):
    """One card's shard at fault parts one card's share of the checked chains
    at once, which the early limit does not pass."""
    fault(monkeypatch)
    result = judged('villain-pod-l64-4card')
    assert result['correct'] is False, result['checked']
    assert result['checked']['early_parted_share']['value'] == 1 / SHARDS, result['checked']


def test_without_a_card_a_run_prints_nothing_and_fails(capsys):
    with pytest.raises(SystemExit) as stop:
        run.main(['--workload', 'villain-l256-w1', '--seed', '1', '--seconds', '1'])
    assert stop.value.code == 2
    assert capsys.readouterr().out == ''
