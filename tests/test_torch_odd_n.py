"""Odd N on the port's CPU path: a torus of odd side is not two-colourable, so
the lattice colours it with 2^max(D,2) colours (4 in D=2), and every sweep
must visit all of them.

- The plain Worldline sweep (B4's twin, and the path of the eager Vortex and
  Coexact updates) changes v on plaquettes of every colour.
- ``sweep_plan`` gives every odd N the colour-table plan.
- The kernels' draw sources number a sweep's passes n_colors·sweep + colour
  (Villain) and (2·n_colors + 2)·sweep + pass (Worldline): today's numbering at
  even N.
- The plain twins at odd N sample what the JAX package's eager updates sample:
  ⟨ActionDensity⟩ of independent chains within Monte-Carlo error.

The card's odd-N tests (kernels against their plain twins on the same draws)
are in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.generators import combining as jcombining
from supervillain_tpu.generators import villain as jv, worldline as jw
from supervillain_tpu.parallel import sample_fleet as jax_sample_fleet
from supervillain_tpu_torch.generators import villain as tv, worldline as tw
from supervillain_tpu_torch.interop import worldline_action
from supervillain_tpu_torch.ops import philox
from supervillain_tpu_torch.ops.sweep import (TABLE_PLAN, KernelSweepDraws, color_table,
                                              lattice, plain_sweeps, sweep_plan)
from supervillain_tpu_torch.ops.worldline import (KernelWorldlineSweepDraws,
                                                  plain_worldline_sweeps, worldline_sweeps)

#: Largest |pull| of two Monte-Carlo means of one quantity.
PULL_BOUND = 4.0


def _colors_changed(before, after, N):
    """Per colour, whether any chain changed the field on a site of that colour."""
    changed = (after != before).reshape(after.shape[0], -1, N, N).any(dim=(0, 1))
    masks = lattice(N).checkerboard_masks
    return [bool(changed[torch.as_tensor(mask)].any()) for mask in masks]


@pytest.mark.parametrize('N', [5, 7])
def test_plain_worldline_sweep_changes_v_on_every_color(N):
    """64 chains × 50 sweeps at W=2: v changes on plaquettes of all 4 colours
    (a sweep of colours 0 and 1 alone leaves colours 2 and 3 at 0)."""
    S = worldline_action(N, 0.5, 2)
    cold = S.initial('cpu')
    B = 64
    m, v = (cold[k].expand((B,) + cold[k].shape) for k in ('m', 'v'))
    m2, v2, accepted, _ = worldline_sweeps(m, v, kappa=0.5, W=2, sweeps=50,
                                           generator=torch.Generator().manual_seed(1))
    assert lattice(N).n_colors == 4
    assert _colors_changed(v, v2, N) == [True] * 4
    assert all(S.valid({'m': m2[b]}) for b in range(B))


@pytest.mark.parametrize('update', ['VortexUpdate', 'CoexactUpdate'])
def test_eager_worldline_updates_visit_every_color(update, monkeypatch):
    """The eager VortexUpdate and CoexactUpdate run a pass for each of the 4
    colours of an odd-N lattice (N=5), and the VortexUpdate changes v on the
    plaquettes of each."""
    N, B = 5, 64
    S = worldline_action(N, 0.5, 2)
    cold = S.initial('cpu')
    cfg = {k: v.expand((B,) + v.shape).contiguous() for k, v in cold.items()}
    name = 'vortex_pass' if update == 'VortexUpdate' else 'coexact_pass'
    colors, run = [], getattr(tw, name)

    def recorded(*args, **kwargs):
        colors.append(args[2])
        return run(*args, **kwargs)

    monkeypatch.setattr(tw, name, recorded)
    G = getattr(tw, update)(S)
    g = torch.Generator().manual_seed(2)
    out, stats = cfg, G.init_stats()
    for _ in range(30):
        out, stats, _ = G.step(g, out, stats)
    assert colors == [0, 1, 2, 3] * 30
    if update == 'VortexUpdate':
        assert _colors_changed(cfg['v'], out['v'], N) == [True] * 4
    assert float(stats[update]['accepted']) > 0
    assert float(stats[update]['proposed']) == B * 30 * S.Lattice.cells_of_degree[2]


def test_sweep_plan_gives_every_odd_n_the_table_plan():
    for N in range(3, 1026, 2):
        assert sweep_plan(N) == TABLE_PLAN, N
    assert sweep_plan(256).regime == 'resident' and sweep_plan(512).regime == 'streaming'


@pytest.mark.parametrize('N', [3, 5, 11])
def test_color_table_is_the_checkerboard(N):
    table = color_table(N, torch.device('cpu'))
    assert table.dtype == torch.int8 and table.shape == (N, N)
    masks = lattice(N).checkerboard_masks
    for c, mask in enumerate(masks):
        np.testing.assert_array_equal(table.numpy() == c, mask)
    # No two neighbours alike, through the periodic boundary.
    for axis in (0, 1):
        assert not (table == torch.roll(table, 1, dims=axis)).any()


@pytest.mark.parametrize('N', [5, 6])
def test_kernel_sweep_draws_number_passes_by_color_count(N):
    """Call i of a KernelSweepDraws (sweep i // n_colors, colour i % n_colors)
    draws Philox with pass = i: n_colors·sweep + colour, 2·sweep + colour at
    even N."""
    B, seed = 2, 987654321
    n_colors = lattice(N).n_colors
    assert n_colors == (2 if N % 2 == 0 else 4)
    draws = KernelSweepDraws(seed, B=B, N=N, interval_phi=1.0, interval_n=1, p_n=None,
                             zmode=False, fdt=torch.float64, idt=torch.int64, device='cpu')
    site = torch.arange(N * N).reshape(1, N, N)
    chain = torch.arange(B).reshape(B, 1, 1)
    for sweep in range(2):
        for color in range(n_colors):
            got = draws(color)
            w = philox.philox4x32_10((site, chain, n_colors * sweep + color, 0),
                                     philox.key_of(seed))
            want = ((2 * philox.u24(w[0]) - 1) * 1.0).to(torch.float64)
            torch.testing.assert_close(got['phi'], want, rtol=0, atol=0)
    assert draws.passes == 2 * n_colors


@pytest.mark.parametrize('N', [5, 6])
def test_kernel_worldline_draws_count_passes_by_color_count(N):
    """A Worldline sweep takes 2·n_colors + 2 passes of the kernel's draws: 6
    at even N, 10 at odd N."""
    B, W = 3, 2
    S = worldline_action(N, 0.5, W)
    cold = S.initial('cpu')
    m, v = (cold[k].expand((B,) + cold[k].shape) for k in ('m', 'v'))
    draws = KernelWorldlineSweepDraws(12345, B=B, N=N, interval_v=1, interval_t=1,
                                      interval_w=1, winf=False, fdt=torch.float64,
                                      idt=torch.int64, device='cpu')
    plain_worldline_sweeps(m, v, kappa=0.5, W=W, sweeps=3, draws=draws)
    assert draws.passes == 3 * (2 * lattice(N).n_colors + 2)


def _pull(ours, theirs):
    """Pull of two sets of independent per-chain means."""
    a, b = np.asarray(ours), np.asarray(theirs)
    se = np.hypot(a.std(ddof=1) / np.sqrt(len(a)), b.std(ddof=1) / np.sqrt(len(b)))
    return (a.mean() - b.mean()) / se


def _chain_means(fleet, cut, name='ActionDensity'):
    e = fleet.pooled_ensemble(cut)
    values = np.asarray(getattr(e, name))
    return values.reshape(-1, fleet.chains).mean(axis=0)


VILLAIN_CASES = [(3, 1, 'NeighborhoodUpdate'), (5, 2, 'NeighborhoodUpdate'),
                 (5, float('inf'), 'ExactNeighborhoodUpdate')]


@pytest.mark.parametrize('N,W,update', VILLAIN_CASES)
def test_villain_sweeps_at_odd_n_agree_with_jax_in_distribution(N, W, update):
    """The port's neighborhood sweeps (B1's plain twin, 4 colours) against the
    JAX package's eager update at odd N: per-chain ⟨ActionDensity⟩ of 48
    chains after a cut, within PULL_BOUND."""
    kappa = 0.5
    J = jsv.Villain(jsv.Lattice2D(N), kappa, W=W)
    T = tsv.Villain(tsv.Lattice2D(N), kappa, W=W)
    args = dict(chains=48, steps=40, thin=2)
    ours = tsv.sample_fleet(T, getattr(tv, update)(T), seed=3, device='cpu', **args)
    theirs = jax_sample_fleet(J, getattr(jv, update)(J), seed=4, **args)
    assert abs(_pull(_chain_means(ours, 10), _chain_means(theirs, 10))) < PULL_BOUND


@pytest.mark.parametrize('N,W', [(3, 1), (5, 2), (5, float('inf'))])
def test_worldline_sweeps_at_odd_n_agree_with_jax_in_distribution(N, W):
    """The port's fused Worldline sweeps on the CPU (B4's plain twin, 4 colours)
    against the JAX package's Vortex, Coexact and Wrapping updates at odd N:
    per-chain ⟨ActionDensity⟩ of 48 chains, within PULL_BOUND."""
    kappa = 0.5
    J = jsv.Worldline(jsv.Lattice2D(N), kappa, W=W)
    T = tsv.Worldline(tsv.Lattice2D(N), kappa, W=W)
    args = dict(chains=48, steps=40, thin=2)
    ours = tsv.sample_fleet(T, tsv.FusedWorldlineUpdate(T), seed=5, device='cpu', **args)
    jax_tree = jcombining.Sequentially((jw.VortexUpdate(J), jw.CoexactUpdate(J),
                                        jw.WrappingUpdate(J)))
    theirs = jax_sample_fleet(J, jax_tree, seed=6, **args)
    assert abs(_pull(_chain_means(ours, 10), _chain_means(theirs, 10))) < PULL_BOUND
