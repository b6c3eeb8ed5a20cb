"""The port's ``sample_fleet`` against the JAX package's, on the CPU: the worm
bounding policies, the columns (names, shapes, dtypes), the index and the
stats of a fleet, the generic Hammer fleets' ActionDensity in distribution,
and the CPU path counting no kernel launch."""

import logging

import numpy as np
import pytest
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.generators import villain as jv, worldline as jw
from supervillain_tpu.parallel import fleet as jfleet
from supervillain_tpu.parallel import sample_fleet as jax_sample_fleet
from supervillain_tpu_torch.generators import villain as tv, worldline as tw
from supervillain_tpu_torch.ops.sweep import neighborhood_sweeps
from supervillain_tpu_torch.ops.worldline_worm import worldline_worms
from supervillain_tpu_torch.ops.worm import classic_worms
from supervillain_tpu_torch.parallel import fleet as tfleet


def _pair(action, N=4, kappa=0.5, W=2):
    return (getattr(jsv, action)(jsv.Lattice2D(N), kappa, W=W),
            getattr(tsv, action)(tsv.Lattice2D(N), kappa, W=W))


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize('action', ['Villain', 'Worldline'])
def test_bounded_worms_policies_match_jax(action, caplog):
    J, T = _pair(action)
    jg, tg = (jv, tv) if action == 'Villain' else (jw, tw)
    jtree = jsv.generators.KeepEvery(2, jg.Hammer(J, worms=2))
    ttree = tsv.KeepEvery(2, tg.Hammer(T, worms=2))
    # raise: the same error, naming the alternatives.
    assert (_message(lambda: tfleet._bounded_worms(ttree, T, 8, 'raise'))
            == _message(lambda: jfleet._bounded_worms(jtree, J, 8, 'raise')))
    assert (_message(lambda: tfleet._bounded_worms(ttree, T, 8, 'sometimes'))
            == _message(lambda: jfleet._bounded_worms(jtree, J, 8, 'sometimes')))
    # auto: the same rebuilt tree (the worm capped at 8·sites), with a warning.
    with caplog.at_level(logging.WARNING):
        ours = tfleet._bounded_worms(ttree, T, 8, 'auto')
    assert 'substituting ClassicWorm(max_moves=128)' in caplog.text
    assert tsv.io.generator_spec(ours) == jsv.io.generator_spec(
        jfleet._bounded_worms(jtree, J, 8, 'auto'))
    # off, fewer chains than the floor, or an already bounded tree: unchanged.
    assert tfleet._bounded_worms(ttree, T, 8, 'off') is ttree
    assert tfleet._bounded_worms(ttree, T, tfleet._WORM_BOUND_FLOOR - 1, 'raise') is ttree
    bounded = tg.Hammer(T, fleet=True)
    assert tfleet._bounded_worms(bounded, T, 64, 'raise') is bounded
    assert tfleet._WORM_BOUND_FLOOR == jfleet._WORM_BOUND_FLOOR == 8


CASES = {
    'villain-w2-fleet': ('Villain', 2, lambda g, S: g.Hammer(S, fleet=True)),
    'villain-w1-chunked': ('Villain', 1, lambda g, S: g.Hammer(S, fleet=True)),
    'villain-winf-worms2': ('Villain', float('inf'),
                            lambda g, S: g.Hammer(S, worms=2, max_worm_moves=40)),
    'worldline-w2-fleet': ('Worldline', 2, lambda g, S: g.Hammer(S, fleet=True)),
    'worldline-winf-plaquette': ('Worldline', float('inf'), lambda g, S: g.PlaquetteUpdate(S)),
}


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('keep_fields', [True, False])
def test_columns_index_and_stats_match_jax(case, keep_fields):
    action, W, build = CASES[case]
    J, T = _pair(action, W=W)
    jg, tg = (jv, tv) if action == 'Villain' else (jw, tw)
    args = dict(chains=8, steps=3, thin=2, seed=4, keep_fields=keep_fields)
    ours = tsv.sample_fleet(T, build(tg, T), device='cpu', **args)
    theirs = jax_sample_fleet(J, build(jg, J), **args)
    assert sorted(ours.columns) == sorted(theirs.columns)
    for k, v in theirs.columns.items():
        assert (ours.columns[k].shape, ours.columns[k].dtype) == (v.shape, v.dtype), k
    np.testing.assert_array_equal(ours.index, theirs.index)
    assert sorted(ours.final) == sorted(theirs.final)
    for k, v in theirs.final.items():
        assert (ours.final[k].shape, ours.final[k].dtype) == (v.shape, v.dtype), k
    assert sorted(ours.stats) == sorted(theirs.stats)
    for tag, s in theirs.stats.items():
        assert sorted(ours.stats[tag]) == sorted(s)
        if not tag.startswith('ClassicWorm'):
            # Proposals and sweeps do not depend on the draws: summed over chains.
            assert ours.stats[tag]['proposed'] == float(s['proposed']), tag
            assert ours.stats[tag]['sweeps'] == float(s['sweeps']), tag
    assert len(ours) == 3 and all(v.shape[0] == 8 for v in ours.final.values())


def test_inline_is_averaged_over_each_records_steps():
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    G = tv.ClassicWorm(S)
    fleet = tsv.sample_fleet(S, G, chains=3, steps=2, thin=3, seed=2, device='cpu',
                             keep_fields=False)
    g = torch.Generator().manual_seed(2)
    cfg = {k: v[None].expand(3, *v.shape).contiguous() for k, v in S.initial('cpu').items()}
    stats, lengths = G.init_stats(), []
    for _ in range(6):
        cfg, stats, inline = G.step(g, cfg, stats)
        lengths.append(inline['Worm_Length'])
    want = torch.stack(lengths).reshape(2, 3, 3).mean(dim=1).numpy()
    np.testing.assert_allclose(fleet.columns['Worm_Length'], want, rtol=1e-15)
    assert fleet.stats['ClassicWorm']['accepted'] == float(torch.stack(lengths).sum())


def test_mesh_is_not_ported_and_raises():
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    with pytest.raises(NotImplementedError, match='mesh'):
        tsv.sample_fleet(S, tv.SiteUpdate(S), chains=2, steps=1, mesh=object(), device='cpu')


def test_sample_fleet_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsv.sample_fleet(S, tv.SiteUpdate(S), chains=2, steps=1)


def test_cpu_run_never_reports_a_kernel_launch(monkeypatch):
    """With a GPU reported present, the eager steps on CPU tensors take the
    plain twins and count no launch of B1, B2 or B5."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    counters = (neighborhood_sweeps, classic_worms, worldline_worms)
    before = [f.launches for f in counters]
    SV = tsv.Villain(tsv.Lattice2D(4), 0.5, W=2)
    SW = tsv.Worldline(tsv.Lattice2D(4), 0.5, W=2)
    tsv.sample_fleet(SV, tsv.Sequentially([tv.NeighborhoodUpdate(SV), tv.ClassicWorm(SV, 16)]),
                     chains=3, steps=2, device='cpu')
    tsv.sample_fleet(SW, tw.Hammer(SW, max_worm_moves=16), chains=3, steps=2, device='cpu')
    tsv.Ensemble(SV).generate(2, tv.ExactNeighborhoodUpdate(SV), device='cpu')
    assert [f.launches for f in counters] == before


def _per_chain_action_density(module, action, fleet, cut):
    fields = {k: fleet.columns[k][cut:] for k in action.fields}
    records, chains = fields[action.fields[0]].shape[:2]
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in fields.items()}
    where = {'device': 'cpu'} if module is tsv else {}
    e = module.Ensemble(action).from_configurations(module.Configurations(flat), **where)
    return np.asarray(e.ActionDensity).reshape(records, chains).mean(axis=0)


@pytest.mark.parametrize('action', ['Villain', 'Worldline'])
def test_generic_hammer_fleet_agrees_with_jax(action):
    """The generic Hammer(fleet=True) at N=6, W=2, 64 chains: the mean over
    chains of per-chain means of ActionDensity after the cut agrees with the
    JAX package's sample_fleet within 5 combined standard errors (chains are
    independent samples)."""
    J, T = _pair(action, N=6, W=2)
    jg, tg = (jv, tv) if action == 'Villain' else (jw, tw)
    args = dict(chains=64, steps=40, thin=2)
    cut = 10
    ours = _per_chain_action_density(tsv, T, tsv.sample_fleet(T, tg.Hammer(T, fleet=True),
                                                              seed=3, device='cpu', **args), cut)
    theirs = _per_chain_action_density(jsv, J, jax_sample_fleet(J, jg.Hammer(J, fleet=True),
                                                                seed=3, **args), cut)
    se = np.hypot(ours.std(ddof=1), theirs.std(ddof=1)) / np.sqrt(64)
    assert abs(ours.mean() - theirs.mean()) < 5 * se, (ours.mean(), theirs.mean(), se)
