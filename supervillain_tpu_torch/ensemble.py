"""Markov chains of configurations: a Python loop over generator steps.

PyTorch counterpart of :mod:`supervillain_tpu.ensemble`.  The chain runs on the
device of its fields; each step's fields and inline observables land on the
host as NumPy columns, and observables attach through the registry
descriptors of :mod:`.observables`.  An ensemble measures on its ``device``:
the one it was generated on, or the one given to :meth:`from_configurations`
(the card unless ``device='cpu'``), resolved at the first measurement.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .configurations import Configurations
from .device import resolve_device, to_device
from .generators.base import host_stats
from .utils import Timer

logger = logging.getLogger(__name__)


def _no_op(iterable, **kwargs):
    return iterable


class Ensemble:
    """An ensemble of configurations importance-sampled according to ``action``."""

    #: Where observables are measured; resolved (and checked) at the first measurement.
    device = 'cuda'

    def __init__(self, action):
        self.Action = action

    # -- construction ------------------------------------------------------

    def from_configurations(self, configurations, device='cuda'):
        """Wrap draw-major ``configurations``; observables are measured on ``device``."""
        self.configuration = configurations
        self.device = device
        if not hasattr(self, 'index'):
            self.index = np.arange(len(configurations))
            self.index_stride = 1
            self.weight = np.ones(len(configurations))
        return self

    def generate(self, steps, generator, start='cold', seed=0, device='cuda',
                 progress=_no_op, starting_index=0, index_stride=1):
        """Run the chain for ``steps`` configurations.

        ``generator`` provides ``step(torch_generator, cfg, stats)`` over a
        batch of chains; the chain runs as a batch of one.  ``seed`` is an int
        that seeds a ``torch.Generator`` on ``device``, where the chain runs, or
        such a generator itself.  ``start`` is ``'cold'`` or a configuration
        dict (moved to ``device`` in its dtypes).  Without a card, pass
        ``device='cpu'``."""
        S = self.Action
        device = resolve_device(device)
        if isinstance(seed, torch.Generator):
            rng = seed
        else:
            rng = torch.Generator(device=device).manual_seed(int(seed))
        if start == 'cold':
            cfg = S.initial(device)
        elif isinstance(start, dict):
            cfg = {k: to_device(start[k], device) for k in S.fields}
        else:
            raise ValueError(f'Not sure how to start from a {type(start)}.')

        cfg = generator.prepare({k: v[None] for k, v in cfg.items()})
        stats = generator.init_stats()
        columns = None
        with Timer(logger.info, f'Generation of {steps} configurations', per=steps):
            for i in progress(range(steps), desc='Generation'):
                cfg, stats, inline = generator.step(rng, cfg, stats)
                host = {k: v[0].detach().cpu().numpy() for k, v in (cfg | inline).items()}
                if columns is None:
                    columns = {k: np.empty((steps,) + v.shape, dtype=v.dtype)
                               for k, v in host.items()}
                for k, v in host.items():
                    columns[k][i] = v

        self.configuration = Configurations(columns)
        self.device = device
        self.index_stride = index_stride
        self.index = starting_index + index_stride * np.arange(steps)
        self.weight = np.ones(steps)
        self.start = start
        self.generator = generator
        self.stats = host_stats(stats)
        self._final = {k: cfg[k][0].detach().cpu().numpy() for k in S.fields}
        # The stream goes on where this chain stopped: continue_from (and a
        # file written by to_h5) resumes it instead of reseeding.
        self._generator_state = (rng.device.type, rng.get_state().numpy())
        for line in generator.report(self.stats).split('\n'):
            logger.info(line)
        return self

    @classmethod
    def continue_from(cls, ensemble, steps, progress=_no_op, device=None):
        """Extend a chain: use the last configuration, generator and random stream
        of ``ensemble`` (an Ensemble, or an h5py Group storing one) to generate
        ``steps`` more, on ``device`` (by default the ensemble's; a stored group
        is read for the card unless ``device='cpu'``).  The new ensemble's
        stats cover the whole chain."""
        if isinstance(ensemble, Ensemble):
            e = ensemble
        else:
            import h5py
            if not isinstance(ensemble, h5py.Group):
                raise ValueError('ensemble should be an Ensemble or an h5 group storing one.')
            from .io import ensemble_from_h5
            e = ensemble_from_h5(ensemble, device=device or 'cuda')
        if 'generator' not in e.__dict__:
            raise ValueError('This ensemble carries no generator to continue with.')
        device = resolve_device(device or e.device)
        action = e.Action
        last = e.__dict__.get('_final') or e.configuration[len(e) - 1]
        last = {k: last[k] for k in action.fields}
        state = e.__dict__.get('_generator_state')
        if state is None:
            # A chain written without the port's stream (e.g. by the JAX
            # package, whose key a torch stream cannot continue).
            seed = len(e) + 1
        elif state[0] != device.type:
            raise ValueError(f'The chain\'s random stream lives on a {state[0]} generator; '
                             f'continue it with device={state[0]!r}.')
        else:
            seed = torch.Generator(device=device)
            seed.set_state(torch.as_tensor(np.asarray(state[1], dtype=np.uint8)))
        new = Ensemble(action).generate(steps, e.generator, start=last, seed=seed,
                                        device=device, progress=progress,
                                        starting_index=e.index[-1] + e.index_stride,
                                        index_stride=e.index_stride)
        before = e.__dict__.get('stats', {})
        new.stats = {tag: {k: before.get(tag, {}).get(k, 0.0) + v for k, v in s.items()}
                     for tag, s in new.stats.items()}
        return new

    # -- sizes and access --------------------------------------------------

    def __len__(self):
        return len(self.configuration)

    def __getattr__(self, name):
        # Field columns are exposed as ensemble attributes, unifying observables'
        # access to fields and other observables.
        if name.startswith('__'):
            raise AttributeError(name)
        try:
            return getattr(self.__dict__['configuration'], name)
        except KeyError:
            raise AttributeError(name) from None

    # -- measurement ---------------------------------------------------------

    def measure(self, observables=None):
        """Measure every known primary observable (or the named subset)."""
        from .observables import registry
        if observables is None:
            observables = registry.keys()
        result = {}
        for o in observables:
            try:
                result[o] = getattr(self, o)
            except NotImplementedError:
                logger.info(f'{o} is not implemented for {self.Action}')
        return result

    @property
    def measured(self):
        from .observables import registry
        return self.__dict__.keys() & registry.keys()

    def autocorrelation_time(self, observables=None, every=False):
        """Max integrated autocorrelation time over fluctuating measured observables,
        falling back to half the ensemble length when nothing fluctuates."""
        from .observables import registry
        from .analysis import autocorrelation_time

        if observables is None:
            observables = set(o for o in self.measured if registry[o].autocorrelation(self))
        if len(observables) == 0:
            observables = tuple(registry.keys())

        auto = {}
        for name in observables:
            if not registry[name].autocorrelation(self):
                continue
            try:
                auto[name] = autocorrelation_time(getattr(self, name))
            except NotImplementedError:
                continue
            except AttributeError:
                # A field or column the observable depends on is absent.
                logger.info(f'{name} cannot be measured on this ensemble; excluded from '
                            'the autocorrelation time calculation.')
            except ValueError:
                logger.warning(f'{name} does not fluctuate enough; excluded from '
                               'the autocorrelation time calculation.')

        if every:
            return auto
        if not auto:
            tau = max(1, int(np.ceil(len(self) / 2)))
            logger.warning('No observable fluctuated enough to estimate an '
                           f'autocorrelation time; falling back to τ = {tau}.')
            return tau
        return max(auto.values())

    # -- thinning ------------------------------------------------------------

    def _derive(self, index, carried):
        e = Ensemble(self.Action).from_configurations(self.configuration[index],
                                                      device=self.device)
        e.index = self.index[index]
        e.weight = self.weight[index]
        for o in self.measured:
            setattr(e, o, getattr(self, o)[index])
        for k in carried:
            if k in self.__dict__:
                e.__dict__[k] = self.__dict__[k]
        return e

    def cut(self, start):
        """Drop the first ``start`` configurations (thermalization)."""
        e = self._derive(slice(start, None),
                         ('generator', 'stats', '_final', '_generator_state'))
        e.index_stride = self.index_stride
        return e

    def every(self, stride):
        """Keep every ``stride``-th configuration (decorrelation); the generator
        is wrapped in ``KeepEvery`` so that continuation stays strided."""
        from .generators import KeepEvery
        stride = int(stride)
        if stride < 1:
            raise ValueError(f'every() needs a stride >= 1, got {stride}.')
        e = self._derive(slice(None, None, stride), ('stats', '_final', '_generator_state'))
        e.index_stride = self.index_stride * stride
        if 'generator' in self.__dict__:
            e.generator = KeepEvery(stride, self.generator, blocked_inline=False)
        return e

    # -- plotting ------------------------------------------------------------

    def plot_history(self, axes, observable, label=None, histogram_label=None,
                     bins=31, density=True, alpha=0.5, color=None, history_kwargs=None):
        """History and histogram panels (``axes[0]``, ``axes[1]``) for a scalar
        observable.  ``history_kwargs`` go to the history's ``plot``; the
        caller's dict is not changed."""
        history_kwargs = {'label': label} | dict(history_kwargs or {})
        if histogram_label is None:
            histogram_label = label
        data = np.asarray(getattr(self, observable))
        axes[0].plot(self.index, data, color=color, **history_kwargs)
        axes[1].hist(data, label=histogram_label, orientation='horizontal',
                     bins=bins, density=density, color=color, alpha=alpha)

    # -- persistence -----------------------------------------------------------

    def to_h5(self, group):
        from .io import ensemble_to_h5
        ensemble_to_h5(self, group)

    @classmethod
    def from_h5(cls, group, strict=True, device='cuda'):
        from .io import ensemble_from_h5
        return ensemble_from_h5(group, strict=strict, device=device)

    def extend_h5(self, group):
        from .io import ensemble_extend_h5
        return ensemble_extend_h5(self, group)
