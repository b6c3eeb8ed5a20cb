"""Comparison figures for cross-checking ensembles and bootstraps: a copy of
:mod:`supervillain_tpu.analysis.comparison_plot` for the port.

One row per scalar observable, a Monte Carlo history alongside measurement and
bootstrap distributions, through the three functions ``setup`` /
``histories`` / ``bootstraps``.  The history panel carries a trailing ±1σ
rail, and estimates are annotated with :class:`~.Uncertain` strings.
matplotlib is imported only inside :func:`setup`; the other two draw on the
axes they are given.
"""

from __future__ import annotations

import numpy as np

from .autocorrelation import autocorrelation_time
from .uncertain import Uncertain

_default_observables = ('ActionDensity', 'InternalEnergyDensity',
                        'InternalEnergyDensitySquared', 'WindingSquared')


def setup(observables=_default_observables, panel_height=2.0, width=11.0):
    """Figure with one row per observable: a wide Monte Carlo history panel and
    two narrow distribution panels (raw measurements, bootstrap means) sharing
    the row's y-axis.  Returns ``(fig, ax)`` with ``ax`` always 2-D."""
    import matplotlib.pyplot as plt
    rows = len(observables)
    fig, ax = plt.subplots(
        rows, 3,
        figsize=(width, panel_height * rows),
        gridspec_kw={'width_ratios': (6, 1.5, 1.5), 'wspace': 0.04, 'hspace': 0.25},
        sharey='row', squeeze=False,
    )
    for row, name in zip(ax, observables):
        row[0].set_ylabel(name)
        for panel in row[1:]:
            panel.tick_params(labelleft=False, left=False, bottom=False,
                              labelbottom=False)
    ax[-1, 0].set_xlabel('Monte Carlo time')
    ax[-1, 1].set_xlabel('measured')
    ax[-1, 2].set_xlabel('bootstrap')
    return fig, ax


def histories(ax, ensembles, labels=None, observables=_default_observables):
    """Overlay each ensemble's Monte Carlo history (and measurement histogram)
    per observable row; legend entries carry the integrated autocorrelation
    time."""
    if labels is None:
        labels = [''] * len(ensembles)
    for row, name in zip(ax, observables):
        for ensemble, label in zip(ensembles, labels):
            series = np.asarray(getattr(ensemble, name)).real
            tau = autocorrelation_time(series)
            ensemble.plot_history(row, name, alpha=0.4,
                                  history_kwargs={'linewidth': 0.8,
                                                  'label': f'{label} τ={tau}'})
        row[0].legend(loc='best', fontsize='small', framealpha=0.6)


def bootstraps(ax, boots, labels=None, observables=_default_observables,
               bins=31):
    """Per observable row: each bootstrap's ±1σ band over its history panel and
    its resampled-mean distribution, annotated with the formatted estimate."""
    if labels is None:
        labels = [''] * len(boots)
    for row, name in zip(ax, observables):
        for boot, label in zip(boots, labels):
            boot.Ensemble.plot_history(row, name, alpha=0.4,
                                       history_kwargs={'linewidth': 0.8})
            boot.plot_band(row[0], name)
            row[2].hist(np.asarray(getattr(boot, name)).real,
                        bins=bins, density=True, orientation='horizontal',
                        alpha=0.45, label=f'{label} {Uncertain(*boot.estimate(name))}')
        row[2].legend(loc='best', fontsize='x-small', framealpha=0.6)
