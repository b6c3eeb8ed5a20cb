"""Observable registry.

PyTorch counterpart of the primary-observable machinery of
:mod:`supervillain_tpu.observables.core`: subclassing :class:`Observable`
registers the class and installs a descriptor on
:class:`~supervillain_tpu_torch.ensemble.Ensemble`.  Dependencies are resolved
by argument name against the ensemble (fields or other observables).  A
measurement is a function ``measure(S, *deps)`` on tensors whose leading axis is
the draw axis; it runs once over the whole column on the CPU.  A column the
generator already measured inline is returned as it is.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

registry = {}


class Observable:
    """Per-configuration primary observable; attaches to Ensemble by subclassing."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        registry[cls.__name__] = cls
        from ..ensemble import Ensemble
        setattr(Ensemble, cls.__name__, cls())

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        name = type(self).__name__
        if name in obj.__dict__:
            return obj.__dict__[name]

        cfg = obj.__dict__.get('configuration')
        if cfg is not None and name in cfg:
            return np.asarray(cfg.fields[name])

        class_name = type(obj.Action).__name__
        measure = getattr(self, class_name, None) or getattr(self, 'default', None)
        if measure is None:
            raise NotImplementedError(f'{name} not implemented for {class_name}')

        args = inspect.getfullargspec(measure).args
        deps = [torch.as_tensor(np.asarray(getattr(obj, a))) for a in args[1:]]
        values = measure(obj.Action, *deps).numpy()
        obj.__dict__[name] = values
        return values

    def __set__(self, obj, value):
        obj.__dict__[type(self).__name__] = value

    @classmethod
    def autocorrelation(cls, ensemble):
        """Does this observable take part in the ensemble's autocorrelation time?"""
        return False


class Scalar:
    @classmethod
    def autocorrelation(cls, ensemble):
        return True
