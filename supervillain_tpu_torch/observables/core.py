"""Observable and DerivedQuantity registries.

PyTorch counterpart of :mod:`supervillain_tpu.observables.core`: subclassing
:class:`Observable` registers the class and installs a descriptor on
:class:`~supervillain_tpu_torch.ensemble.Ensemble`; subclassing
:class:`DerivedQuantity` does the same on
:class:`~supervillain_tpu_torch.analysis.Bootstrap`.  Dependencies are resolved
by argument name against the ensemble (fields or other observables) or the
bootstrap (resampled observables or other derived quantities).

A measurement is a function ``measure(S, *deps)`` on tensors whose leading axis
is the draw (or bootstrap-draw) axis.  It runs on the device of the ensemble
(the card unless the ensemble was made with ``device='cpu'``), in that device's
dtypes (f32/complex64 on the card, f64/complex128 on the CPU), and its result
comes back as a NumPy column.  A class that sets ``sequential = True`` is
measured over chunks of ``chunk`` draws, so its memory stays bounded.  A column
the generator already measured inline is returned as it is.
"""

from __future__ import annotations

import inspect
import logging

import numpy as np
import torch

from ..device import resolve_device, to_device

logger = logging.getLogger(__name__)

registry = {}
derived_registry = {}


def progress(iterable, **kwargs):
    """Overridable progress hook."""
    return iterable


def measurement_device(obj):
    """The resolved device an ensemble, blocking or bootstrap measures on; without
    a card a CUDA device raises, naming ``device='cpu'``."""
    return resolve_device(getattr(obj, 'device', 'cuda'))


def measure_columns(measure, action, deps, device, chunk=None):
    """Evaluate a batched measurement over the leading (draw) axis of NumPy
    ``deps`` on ``device``; in chunks of ``chunk`` draws when given.  Returns
    NumPy (complex results as complex arrays)."""
    def run(xs):
        return measure(action, *[to_device(x, device) for x in xs]).detach().cpu().numpy()

    if chunk is None or not deps or len(deps[0]) <= chunk:
        return run(deps)
    return np.concatenate([run([d[start:start + chunk] for d in deps])
                           for start in range(0, len(deps[0]), chunk)])


class _Measured:
    """A descriptor that measures itself on first access and caches the column
    in the owner's ``__dict__``."""

    #: Measure over chunks of ``chunk`` draws (bounded device memory).
    sequential = False
    chunk = 64

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        name = type(self).__name__
        if name in obj.__dict__:
            return obj.__dict__[name]
        inline = self._inline(obj)
        if inline is not None:
            return inline

        class_name = type(obj.Action).__name__
        measure = getattr(self, class_name, None) or getattr(self, 'default', None)
        if measure is None:
            raise NotImplementedError(f'{name} not implemented for {class_name}')

        device = measurement_device(obj)
        args = inspect.getfullargspec(measure).args
        deps = [np.asarray(getattr(obj, a)) for a in args[1:]]  # args[0] is the action
        values = measure_columns(measure, obj.Action, deps, device,
                                 chunk=self.chunk if self.sequential else None)
        obj.__dict__[name] = values
        return values

    def _inline(self, obj):
        return None

    def __set__(self, obj, value):
        obj.__dict__[type(self).__name__] = value

    @classmethod
    def autocorrelation(cls, ensemble):
        """Does this quantity take part in the ensemble's autocorrelation time?
        Overridden by the mixins below."""
        return False


class Observable(_Measured):
    """Per-configuration primary observable; attaches to Ensemble by subclassing."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        registry[cls.__name__] = cls
        from ..ensemble import Ensemble
        setattr(Ensemble, cls.__name__, cls())
        logger.debug(f'Observable registered: {cls.__name__}')

    def _inline(self, obj):
        # The generator already produced this column.
        cfg = obj.__dict__.get('configuration')
        if cfg is not None and type(self).__name__ in cfg:
            return np.asarray(cfg.fields[type(self).__name__])
        return None


class DerivedQuantity(_Measured):
    """Post-bootstrap quantity, nonlinear in expectation values; attaches to
    Bootstrap by subclassing."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        derived_registry[cls.__name__] = cls
        from ..analysis.bootstrap import Bootstrap
        setattr(Bootstrap, cls.__name__, cls())
        logger.debug(f'DerivedQuantity registered: {cls.__name__}')


def per_draw(x, lattice):
    """A per-draw value (draws,) shaped to broadcast against (draws, N, ..., N)."""
    return x.reshape(x.shape + (1,) * lattice.D)


def spatial_sum(x, lattice):
    """Sum over the last D (spatial) axes."""
    return torch.sum(x, dim=tuple(range(-lattice.D, 0)))


def at_origin(x, lattice):
    """The value at the origin of each draw of a (draws, N, ..., N) correlator."""
    return x[(Ellipsis,) + lattice.origin]


# -- autocorrelation-participation mixins ------------------------------------

class Scalar:
    @classmethod
    def autocorrelation(cls, ensemble):
        return True


class Constrained:
    @classmethod
    def autocorrelation(cls, ensemble):
        return (ensemble.Action.W != 1) and super().autocorrelation(ensemble)


class OnlyVillain:
    @classmethod
    def autocorrelation(cls, ensemble):
        from ..models import Villain
        return isinstance(ensemble.Action, Villain) and super().autocorrelation(ensemble)


class OnlyWorldline:
    @classmethod
    def autocorrelation(cls, ensemble):
        from ..models import Worldline
        return isinstance(ensemble.Action, Worldline) and super().autocorrelation(ensemble)


class NotVillain:
    @classmethod
    def autocorrelation(cls, ensemble):
        from ..models import Villain
        return (not isinstance(ensemble.Action, Villain)) and super().autocorrelation(ensemble)


class NotWorldline:
    @classmethod
    def autocorrelation(cls, ensemble):
        from ..models import Worldline
        return (not isinstance(ensemble.Action, Worldline)) and super().autocorrelation(ensemble)
