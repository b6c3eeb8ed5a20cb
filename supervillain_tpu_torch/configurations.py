"""Host-side containers for Markov-chain draws.

Copy of :class:`supervillain_tpu.configurations.Configurations`: a dict of
per-field NumPy columns with the draw axis first, with its HDF5 methods.
"""

from __future__ import annotations

import numpy as np


_LOSSY = (
    (np.complexfloating, np.floating),
    (np.complexfloating, np.integer),
    (np.complexfloating, np.bool_),
    (np.floating, np.integer),
    (np.floating, np.bool_),
    (np.integer, np.bool_),
)


def _check_dtype(value, target_dtype):
    """Reject lossy dtype coercions (complex→float, float→int, ...)."""
    v = np.asarray(value)
    for src, dst in _LOSSY:
        if np.issubdtype(v.dtype, src) and np.issubdtype(np.dtype(target_dtype), dst):
            raise ValueError(
                f'Storing {v.dtype} data into a {np.dtype(target_dtype)} column would lose information.')
    return v


class Configurations:
    """A draw-major dict of field/inline-observable columns."""

    def __init__(self, fields=None):
        self.fields = dict(fields) if fields else {}

    def __contains__(self, name):
        return name in self.fields

    def keys(self):
        return self.fields.keys()

    def items(self):
        return self.fields.items()

    def __or__(self, other):
        merged = dict(self.fields)
        merged.update(other.fields if isinstance(other, Configurations) else other)
        return Configurations(merged)

    __ior__ = __or__

    def __getattr__(self, name):
        try:
            return self.__dict__['fields'][name]
        except KeyError:
            raise AttributeError(name) from None

    def __len__(self):
        if not self.fields:
            return 0
        return len(next(iter(self.fields.values())))

    def __getitem__(self, index):
        if isinstance(index, str):
            return self.fields[index]
        if isinstance(index, (int, np.integer)):
            return {k: v[index] for k, v in self.fields.items()}
        return Configurations({k: v[index] for k, v in self.fields.items()})

    def __setitem__(self, index, cfg):
        for k, column in self.fields.items():
            if k in cfg:
                column[index] = _check_dtype(cfg[k], column.dtype)

    # -- persistence -------------------------------------------------------

    def to_h5(self, group):
        for k, v in self.fields.items():
            ds = group.create_dataset(k, data=np.asarray(v),
                                      maxshape=(None,) + np.asarray(v).shape[1:])
            ds.attrs['column'] = True

    @classmethod
    def from_h5(cls, group):
        return cls({k: np.asarray(group[k]) for k in group})

    def extend_h5(self, group):
        """Append our draws to existing resizable datasets."""
        for k, v in self.fields.items():
            v = np.asarray(v)
            ds = group[k]
            start = ds.shape[0]
            ds.resize(start + v.shape[0], axis=0)
            ds[start:] = v
