"""The port's plot methods against the JAX package's, on the CPU with matplotlib's
Agg backend: the same NumPy configurations and a seeded bootstrap in both
packages put the same x, y and error data on their axes (1e-12), through
``Bootstrap.plot_correlator`` and ``plot_band``, ``Blocking.plot_history``,
``Ensemble.plot_history`` and ``comparison_plot``'s ``setup``, ``histories``
and ``bootstraps``.  ``Ensemble.plot_history`` takes no mutable default: a
second call does not carry the first call's label.

The JAX package measures the Villain WindingSquared and Winding_Winding from a
float32 dn (ROADMAP C5); their data agree to float32 rounding (2e-6), as in
``test_torch_observables``."""

import numpy as np
import pytest

import matplotlib

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

import supervillain_tpu as jsv  # noqa: E402
import supervillain_tpu_torch as tsv  # noqa: E402
from supervillain_tpu.analysis import comparison_plot as jplot  # noqa: E402
from supervillain_tpu_torch.analysis import comparison_plot as tplot  # noqa: E402
from test_torch_observables import FLOAT32_IN_JAX, ensembles  # noqa: E402

TOL = 1e-12
FLOAT32_TOL = 2e-6
OBSERVABLES = ('ActionDensity', 'InternalEnergyDensity', 'WindingSquared')
CASES = [('Villain', 5, 2), ('Worldline', 6, 2)]


def axis_data(ax):
    """Every line's (x, y), every patch's vertices and every collection's
    segments or offsets on ``ax``, in drawing order; and the legend's texts."""
    lines = [np.asarray(line.get_xydata(), dtype=float) for line in ax.get_lines()]
    patches = [np.asarray(p.get_path().transformed(p.get_patch_transform()).vertices, dtype=float)
               for p in ax.patches]
    collections = []
    for c in ax.collections:
        segments = c.get_segments() if hasattr(c, 'get_segments') else []
        collections.append([np.asarray(s, dtype=float) for s in segments]
                           or [np.asarray(c.get_offsets(), dtype=float)])
    legend = ax.get_legend()
    texts = [t.get_text() for t in legend.get_texts()] if legend else []
    return lines, patches, collections, texts, ax.get_xlabel(), ax.get_ylabel()


def tolerance(action, observable):
    return FLOAT32_TOL if (action, observable) in FLOAT32_IN_JAX else TOL


def assert_same_axes(ours, theirs, tol=TOL):
    o_lines, o_patches, o_coll, o_texts, o_x, o_y = axis_data(ours)
    t_lines, t_patches, t_coll, t_texts, t_x, t_y = axis_data(theirs)
    counts = len(o_lines), len(o_patches), len(o_coll)
    assert counts == (len(t_lines), len(t_patches), len(t_coll))
    assert len(o_lines) + len(o_patches) + len(o_coll) > 0
    for a, b in zip(o_lines + o_patches, t_lines + t_patches):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    for a, b in zip(o_coll, t_coll):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=tol, atol=tol)
    assert o_texts == t_texts and (o_x, o_y) == (t_x, t_y)


@pytest.fixture(scope='module', params=CASES, ids=lambda c: f'{c[0]}-N{c[1]}-W{c[2]}')
def pair(request):
    """(JAX, port) ensembles of the same configurations, measured, and seeded
    bootstraps of them."""
    theirs, ours = ensembles(*request.param, count=40)
    for e in (theirs, ours):
        e.measure(OBSERVABLES)
    return (request.param[0], (theirs, jsv.Bootstrap(theirs, draws=30, seed=7)),
            (ours, tsv.Bootstrap(ours, draws=30, seed=7)))


@pytest.fixture
def figures():
    made = []

    def make(*args, **kwargs):
        fig, ax = plt.subplots(*args, **kwargs)
        made.append(fig)
        return ax

    yield make
    for fig in made:
        plt.close(fig)


@pytest.mark.parametrize('correlator,options', [
    ('Spin_Spin', {}), ('Spin_Spin', {'symmetrize': False, 'offset': 0.1, 'multiplier': 2.0}),
    ('Winding_Winding', {'label': 'w', 'marker': 's'})])
def test_plot_correlator_matches_jax(pair, figures, correlator, options):
    action, (_, jboot), (_, tboot) = pair
    jax_ax, port_ax = figures(), figures()
    jboot.plot_correlator(jax_ax, correlator, **options)
    tboot.plot_correlator(port_ax, correlator, **options)
    assert_same_axes(port_ax, jax_ax, tolerance(action, correlator))


@pytest.mark.parametrize('observable', OBSERVABLES)
def test_plot_band_matches_jax(pair, figures, observable):
    action, (jens, jboot), (tens, tboot) = pair
    jax_ax, port_ax = figures(), figures()
    for ax, ens, boot in ((jax_ax, jens, jboot), (port_ax, tens, tboot)):
        ax.plot(ens.index, getattr(ens, observable), color='C3')
        boot.plot_band(ax, observable)
    assert_same_axes(port_ax, jax_ax, tolerance(action, observable))
    with pytest.raises(ValueError, match='shape'):
        tboot.plot_band(port_ax, 'Spin_Spin')


@pytest.mark.parametrize('width', [1, 3])
def test_blocking_plot_history_matches_jax(pair, figures, width):
    _, (jens, _), (tens, _) = pair
    jax_axes, port_axes = figures(1, 2), figures(1, 2)
    # A dict of our own: the JAX method writes the label into its shared default
    # (ROADMAP C6), which tests/test_api_docs.py would then read as stale docs.
    jsv.Blocking(jens, width).plot_history(jax_axes, 'ActionDensity', label='blocked', bins=7,
                                           history_kwargs={})
    tsv.Blocking(tens, width).plot_history(port_axes, 'ActionDensity', label='blocked', bins=7,
                                           history_kwargs={})
    for ours, theirs in zip(port_axes, jax_axes):
        assert_same_axes(ours, theirs)


def test_ensemble_plot_history_matches_jax(pair, figures):
    _, (jens, _), (tens, _) = pair
    jax_axes, port_axes = figures(1, 2), figures(1, 2)
    jens.plot_history(jax_axes, 'InternalEnergyDensity', histogram_label='h', bins=9,
                      history_kwargs={'linewidth': 0.5, 'label': 'e'})
    tens.plot_history(port_axes, 'InternalEnergyDensity', histogram_label='h', bins=9,
                      history_kwargs={'linewidth': 0.5, 'label': 'e'})
    for ours, theirs in zip(port_axes, jax_axes):
        assert_same_axes(ours, theirs)


@pytest.mark.parametrize('owner', ['Ensemble', 'Blocking'])
def test_plot_history_takes_no_mutable_default(pair, figures, owner):
    """Two calls without history_kwargs each label their own line, and a
    caller's dict is left as it was (the JAX package writes the first label
    into its shared default dict)."""
    _, _, (tens, _) = pair
    target = tens if owner == 'Ensemble' else tsv.Blocking(tens, 2)
    axes = figures(1, 2)
    target.plot_history(axes, 'ActionDensity', label='first')
    target.plot_history(axes, 'ActionDensity', label='second')
    assert [line.get_label() for line in axes[0].get_lines()] == ['first', 'second']
    kwargs = {'linewidth': 0.8}
    target.plot_history(axes, 'ActionDensity', label='third', history_kwargs=kwargs)
    assert kwargs == {'linewidth': 0.8}
    assert axes[0].get_lines()[-1].get_label() == 'third'


def test_comparison_plot_matches_jax(pair):
    action, (jens, jboot), (tens, tboot) = pair
    figs = []
    try:
        axes = []
        for plot, ens, boot in ((jplot, jens, jboot), (tplot, tens, tboot)):
            fig, ax = plot.setup(OBSERVABLES)
            figs.append(fig)
            plot.bootstraps(ax, (boot,), ('b',), observables=OBSERVABLES)
            plot.histories(ax, (ens,), ('e',), observables=OBSERVABLES)
            axes.append(ax)
        assert axes[0].shape == axes[1].shape == (len(OBSERVABLES), 3)
        for name, jrow, trow in zip(OBSERVABLES, axes[0], axes[1]):
            for theirs, ours in zip(jrow, trow):
                assert_same_axes(ours, theirs, tolerance(action, name))
    finally:
        for fig in figs:
            plt.close(fig)
