"""The generic Worldline fleet's worms and the generic step's tracing, on the CPU.

``Hammer(S, fleet=True)`` caps its worm at 8 moves a site in D=2, as the JAX
package does, and at ``FLEET_CAP_PER_SITE`` a site at D >= 3, where worms are
longer in sites; an explicit ``max_worm_moves`` wins.  ``sample_fleet``
checks its capped worms' truncated share against ``TRUNCATION_BUDGET`` after
a call and warns above it; ``bound_worms='auto'`` gives an unbounded worm the
same cap.  While a profiler records, the worm counts its calls, worms, moves,
longest worms and truncations on the device, and those counters agree with
the fleet's stats and its ``Worm_Length`` column; without one it counts
nothing.  ``Sequentially`` runs each
sub-step in an ``update.<name>`` span while a profiler records, and makes none
otherwise.
"""

import contextlib
import json
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import supervillain_tpu_torch as tsv
from supervillain_tpu_torch import tracing
from supervillain_tpu_torch.generators import worldline as tw
from supervillain_tpu_torch.parallel import TRUNCATION_BUDGET
from supervillain_tpu_torch.parallel import fleet as fleet_module

UPDATES = ('update.VortexUpdate', 'update.CoexactUpdate', 'update.WrappingUpdate',
           'update.ClassicWorm')


@pytest.fixture(autouse=True)
def fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


def worldline(D, N=3, kappa=0.5, W=1):
    return tsv.Worldline(tsv.Lattice2D(N) if D == 2 else tsv.Lattice(D, N), kappa, W=W)


def worm_of(hammer):
    return hammer.generators[-1]


@pytest.mark.parametrize('D', [2, 3, 4])
def test_the_fleet_cap_is_8_a_site_in_d2_and_the_d3_rule_above(D):
    S = worldline(D)
    per_site = 8 if D == 2 else tw.FLEET_CAP_PER_SITE
    assert worm_of(tw.Hammer(S, fleet=True)).max_moves == per_site * S.Lattice.sites
    assert tw.fleet_worm_cap(S.Lattice) == per_site * S.Lattice.sites
    assert worm_of(tw.Hammer(S)).max_moves is None


@pytest.mark.parametrize('D', [2, 3, 4])
def test_an_explicit_cap_wins_over_the_fleets(D):
    S = worldline(D)
    assert worm_of(tw.Hammer(S, fleet=True, max_worm_moves=8 * S.Lattice.sites)).max_moves \
        == 8 * S.Lattice.sites
    assert worm_of(tw.Hammer(S, fleet=True, max_worm_moves=5)).max_moves == 5
    assert worm_of(tw.Hammer(S, max_worm_moves=5)).max_moves == 5


@pytest.mark.parametrize('D', [2, 3, 4])
def test_auto_bounding_substitutes_the_fleets_cap(D, caplog):
    S = worldline(D)
    with caplog.at_level('WARNING'):
        bounded = fleet_module._bounded_worms(tw.Hammer(S), S, 8, 'auto')
    assert worm_of(bounded).max_moves == tw.fleet_worm_cap(S.Lattice) \
        == worm_of(tw.Hammer(S, fleet=True)).max_moves
    assert f'substituting ClassicWorm(max_moves={tw.fleet_worm_cap(S.Lattice)})' in caplog.text
    with pytest.raises(ValueError, match=f'max_moves={tw.fleet_worm_cap(S.Lattice)}'):
        fleet_module._bounded_worms(tw.Hammer(S), S, 8, 'raise')


def test_the_d3_rule_is_wider_than_the_d2_cap():
    assert tw.FLEET_CAP_PER_SITE > 8


def d3_fleet(cap, chains=4, steps=3, thin=2, seed=3):
    S = worldline(3)
    return S, tsv.sample_fleet(S, tw.Hammer(S, fleet=True, max_worm_moves=cap), chains=chains,
                               steps=steps, thin=thin, seed=seed, keep_fields=False,
                               device='cpu')


def test_a_fleet_whose_cap_truncates_warns_through_the_budget_check(monkeypatch):
    checked = []
    check = fleet_module.check_truncation_budget

    def spy(truncated, total, **kwargs):
        checked.append((truncated, total))
        return check(truncated, total, **kwargs)
    monkeypatch.setattr(fleet_module, 'check_truncation_budget', spy)
    with pytest.warns(UserWarning, match='sample_fleet ClassicWorm: .* worms truncated'):
        _, fleet = d3_fleet(cap=2)
    s = fleet.stats['ClassicWorm']
    assert checked == [(s['sweeps'] - s['acceptance'], s['sweeps'])]
    assert s['sweeps'] == 4 * 3 * 2 and checked[0][0] / checked[0][1] > TRUNCATION_BUDGET


@pytest.mark.parametrize('cap', [None, 10 ** 6])
def test_a_fleet_within_the_budget_does_not_warn(cap):
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        if cap is None:
            S = worldline(3)
            fleet = tsv.sample_fleet(S, tw.Hammer(S), chains=4, steps=3, thin=2, seed=3,
                                     keep_fields=False, device='cpu')
        else:
            _, fleet = d3_fleet(cap)
    s = fleet.stats['ClassicWorm']
    assert s['sweeps'] == s['acceptance'] == 4 * 3 * 2


def test_the_worm_counters_equal_the_fleets_stats_and_worm_lengths(monkeypatch):
    longest = []
    worms = tw.worldline_worms_general

    def spy(*args, **kwargs):
        out = worms(*args, **kwargs)
        longest.append(int(out[2].max()))
        return out
    monkeypatch.setattr(tw, 'worldline_worms_general', spy)
    chains, steps, thin = 5, 3, 2
    with warnings.catch_warnings(), profile(activities=[ProfilerActivity.CPU]):
        warnings.simplefilter('ignore')
        _, fleet = d3_fleet(cap=12, chains=chains, steps=steps, thin=thin)
    counted = tracing.counters()
    s = fleet.stats['ClassicWorm']
    calls = steps * thin
    assert counted['worm.worldline.calls'] == len(longest) == calls
    assert counted['worm.worldline.worms'] == s['sweeps'] == chains * calls
    assert counted['worm.worldline.moves'] == s['accepted'] \
        == thin * fleet.columns['Worm_Length'].sum()
    assert counted['worm.worldline.longest'] == sum(longest)
    assert counted['worm.worldline.truncated'] == s['sweeps'] - s['acceptance'] > 0


def test_without_a_profiler_the_worm_counts_nothing():
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        _, fleet = d3_fleet(cap=12)
    assert fleet.stats['ClassicWorm']['sweeps'] > 0
    assert not any(name.startswith('worm.worldline.') for name in tracing.counters())


def update_spans(trace_file):
    """(name, start, end) of the ``update.*`` and ``outer`` spans of a trace."""
    events = json.loads(trace_file.read_text())['traceEvents']
    return [(e['name'], float(e['ts']), float(e['ts']) + float(e['dur'])) for e in events
            if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
            and (e['name'].startswith('update.') or e['name'] == 'outer')]


def hammer_steps(steps=2):
    S = worldline(3)
    G = tw.Hammer(S, fleet=True)
    cfg = {k: v.expand((2,) + v.shape).contiguous() for k, v in S.initial('cpu').items()}
    stats, rng = G.init_stats(), torch.Generator().manual_seed(4)
    for _ in range(steps):
        cfg, stats, _ = G.step(rng, cfg, stats)


def test_each_sub_step_runs_in_an_update_span_inside_the_step(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('outer'):
            hammer_steps()
    prof.export_chrome_trace(str(tmp_path / 'trace.json'))
    spans = update_spans(tmp_path / 'trace.json')
    (outer,) = [s for s in spans if s[0] == 'outer']
    inner = [s for s in spans if s[0] != 'outer']
    assert [s[0] for s in sorted(inner, key=lambda s: s[1])] == list(UPDATES) * 2
    assert all(outer[1] <= s[1] <= s[2] <= outer[2] for s in inner)
    ordered = sorted(inner, key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(ordered, ordered[1:]))      # one after another


def test_without_a_profiler_no_update_span_is_made(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda name: made.append(name) or contextlib.nullcontext())
    assert not tracing.recording()
    hammer_steps(1)
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        hammer_steps(1)
    assert made == list(UPDATES)


def test_the_villain_hammers_sub_steps_are_named_alike(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda name: made.append(name) or contextlib.nullcontext())
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    G = tsv.generators.villain.Hammer(S, fleet=True)
    cfg = G.prepare({k: v.expand((2,) + v.shape).contiguous()
                     for k, v in S.initial('cpu').items()})
    with profile(activities=[ProfilerActivity.CPU]):
        G.step(torch.Generator().manual_seed(5), cfg, G.init_stats())
    assert made == [f'update.{g.name}' for g in G.generators]
    # The chunked worm keeps the classic worm's name, as the JAX package's does.
    assert type(G.generators[-1]).__name__ == 'ChunkedWorm'
    assert made[0] == 'update.SiteUpdate' and made[-1] == 'update.ClassicWorm'
