"""Fleets of independent Markov chains.

PyTorch counterpart of :class:`supervillain_tpu.parallel.fleet.Fleet`: the
draws of many chains as NumPy columns of shape (kept, chains, ...), with views
as ensembles.  Multi-device sharding and HDF5 persistence are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..configurations import Configurations
from ..ensemble import Ensemble


class Fleet:
    """Draws from many independent chains: columns of shape (kept, chains, ...),
    per-chain final configurations, pooled statistics."""

    def __init__(self, action, columns, stats, final, index, weight=None):
        self.Action = action
        self.columns = columns          # name -> np.ndarray (kept, chains, ...)
        self.stats = stats              # aggregated over chains
        self.final = final              # name -> np.ndarray (chains, ...)
        self.index = index
        self.weight = weight if weight is not None else np.ones(len(index))

    @property
    def chains(self):
        return next(iter(self.columns.values())).shape[1]

    def __len__(self):
        return len(self.index)

    def ensemble(self, chain):
        """View chain ``chain`` as an :class:`Ensemble`."""
        e = Ensemble(self.Action).from_configurations(
            Configurations({k: v[:, chain] for k, v in self.columns.items()}))
        e.index = self.index
        e.index_stride = int(self.index[1] - self.index[0]) if len(self.index) > 1 else 1
        e.weight = self.weight
        return e

    def pooled_ensemble(self, cut=0):
        """Concatenate all chains (after a per-chain thermalization ``cut``) into one
        ensemble of independent-by-construction draws."""
        cols = {k: v[cut:].reshape((-1,) + v.shape[2:]) for k, v in self.columns.items()}
        e = Ensemble(self.Action).from_configurations(Configurations(cols))
        e.index = np.arange(len(next(iter(cols.values()))))
        e.index_stride = 1
        e.weight = np.ones(len(e.index))
        return e
