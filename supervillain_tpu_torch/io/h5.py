"""HDF5 persistence: ensembles, actions, generators.

The schema of :mod:`supervillain_tpu.io.h5`, so that a file written by either
package reads in the other:

    ensemble/
      @type = 'Ensemble', @version
      action/            (@type Villain|Worldline, lattice/{D,N}, kappa, W)
      configurations/    (one resizable draw-major dataset per field/inline column)
      index, weight      (resizable)
      @index_stride
      final/             (the chain's last field configuration, for continuation)
      @generator         (JSON spec; reconstructed against the action)
      @generator_stats   (JSON acceptance tallies)
      measured/          (cached observable columns; complex stored as real+imag)

The JAX package also stores ``next_key``, a JAX PRNG key that a torch stream
cannot continue: the port ignores it on read.  The port stores its own
``torch.Generator`` state as ``torch_generator_state`` (with the generator's
device type in ``@device``), which the JAX package ignores.  ``h5py`` is
imported only by the functions that need it.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from .. import meta

logger = logging.getLogger(__name__)

#: The dataset under which the port keeps its torch.Generator state.
GENERATOR_STATE = 'torch_generator_state'


def check_version(group, strict=True):
    """Compare a group's stored ``@version`` against the running package version:
    a mismatch raises ``ValueError`` when ``strict`` and logs a warning otherwise.
    Groups written before versioning (no ``@version``) pass silently."""
    stored = group.attrs.get('version')
    if stored is None:
        return
    if stored != meta.version:
        message = (f'Version mismatch for {group.name}: stored with '
                   f'{stored!r} but currently use {meta.version!r}')
        if strict:
            raise ValueError(message)
        logger.warning(message)


# -- actions ---------------------------------------------------------------

def action_from_h5(group):
    from ..models import Villain, Worldline
    kind = group.attrs['type']
    if kind == 'Villain':
        return Villain.from_h5(group)
    if kind == 'Worldline':
        return Worldline.from_h5(group)
    raise ValueError(f'Unknown action type {kind!r}')


# -- generators ------------------------------------------------------------

#: Constructor arguments a generator spec records, by class.  The JAX package's
#: table, plus the worm caps and the worldline Hammer's arguments, which its
#: constructors take but its table leaves out.
_SPEC_ARGS = {
    'SiteUpdate': ('interval_phi',),
    'LinkUpdate': ('interval_n',),
    'ExactUpdate': ('interval_z',),
    'CohomologyUpdate': ('interval_h',),
    'NeighborhoodUpdate': ('interval_phi', 'interval_n', 'p_n'),
    'ExactNeighborhoodUpdate': ('interval_phi', 'interval_z', 'p_z'),
    'FusedNeighborhoodUpdate': ('interval_phi', 'interval_n', 'sweeps_per_step', 'p_n'),
    'FusedExactNeighborhoodUpdate': ('interval_phi', 'interval_z', 'sweeps_per_step', 'p_z'),
    'VortexUpdate': ('interval_v',),
    'CoexactUpdate': ('interval_t',),
    'WrappingUpdate': ('interval_w',),
    'PlaquetteUpdate': (),
    'FusedWorldlineUpdate': ('interval_v', 'interval_t', 'interval_w', 'sweeps_per_step'),
    'FusedHammer': ('interval_phi', 'interval_n', 'sweeps_per_step', 'worms', 'p_n',
                    'max_worm_moves'),
    'FusedClassicWorm': ('worms', 'max_worm_moves'),
    'FusedWorldlineWorm': ('worms', 'max_worm_moves'),
    'FusedWorldlineHammer': ('interval_v', 'interval_t', 'interval_w', 'sweeps_per_step',
                             'worms', 'max_worm_moves'),
    'ClassicWorm': ('max_moves',),
    'ChunkedWorm': ('moves_per_step',),
    'DoNothing': (),
}


def generator_spec(g):
    """JSON-serializable description of a generator tree."""
    from ..generators import KeepEvery, Logger, Sequentially
    if isinstance(g, Sequentially):
        # The de-duplicated stats tags, so that stats kept under suffixed tags
        # (two same-named sub-generators) reconcile on reload.
        return {'cls': 'Sequentially', 'generators': [generator_spec(x) for x in g.generators],
                'tags': list(g._tags)}
    if isinstance(g, KeepEvery):
        return {'cls': 'KeepEvery', 'n': g.n, 'blocked_inline': g.blocked_inline,
                'generator': generator_spec(g.generator)}
    if isinstance(g, Logger):
        return generator_spec(g.generator)
    cls = type(g).__name__
    family = type(g).__module__.rsplit('.', 1)[-1]
    args = {k: getattr(g, k) for k in _SPEC_ARGS.get(cls, ())}
    return {'cls': cls, 'family': family, 'args': args}


def generator_from_spec(spec, action):
    """Reconstruct a generator tree against ``action``.  A spec naming a
    generator the port does not have raises ``NotImplementedError``."""
    from ..generators import KeepEvery, Sequentially
    from ..generators import base, villain, villain_fused, worldline, worldline_fused
    cls = spec['cls']
    if cls == 'Sequentially':
        seq = Sequentially([generator_from_spec(s, action) for s in spec['generators']])
        if 'tags' in spec and list(spec['tags']) != seq._tags:
            seq._tags = list(spec['tags'])
            seq.name = 'Sequentially(' + ', '.join(seq._tags) + ')'
        return seq
    if cls == 'KeepEvery':
        return KeepEvery(spec['n'], generator_from_spec(spec['generator'], action),
                         blocked_inline=spec['blocked_inline'])
    families = {'base': base, 'villain': villain, 'worldline': worldline,
                'villain_fused': villain_fused, 'worldline_fused': worldline_fused}
    klass = getattr(families.get(spec.get('family')), cls, None)
    if not (isinstance(klass, type) and issubclass(klass, base.Generator)):
        raise NotImplementedError(f'The port has no generator {cls!r} '
                                  f'(family {spec.get("family")!r}) to rebuild.')
    if klass is base.DoNothing:
        return klass()
    return klass(action, **spec['args'])


# -- columns ----------------------------------------------------------------

def _write_column(group, name, value):
    value = np.asarray(value)
    if np.iscomplexobj(value):
        g = group.create_group(name)
        g.attrs['complex'] = True
        g.create_dataset('real', data=value.real, maxshape=(None,) + value.shape[1:])
        g.create_dataset('imag', data=value.imag, maxshape=(None,) + value.shape[1:])
    else:
        group.create_dataset(name, data=value, maxshape=(None,) + value.shape[1:])


def _read_column(node):
    import h5py
    if isinstance(node, h5py.Group):
        return np.asarray(node['real']) + 1j * np.asarray(node['imag'])
    return np.asarray(node)


def _extend_column(group, name, value):
    import h5py
    value = np.asarray(value)
    node = group[name]
    parts = (('real', value.real), ('imag', value.imag)) if isinstance(node, h5py.Group) \
        else ((None, value),)
    for part, data in parts:
        ds = node if part is None else node[part]
        if ds.maxshape[0] is not None:
            # Written fixed-size (as the JAX package writes a fleet's index):
            # rewrite it resizable.
            old = np.asarray(ds)
            parent, key = (group, name) if part is None else (node, part)
            del parent[key]
            ds = parent.create_dataset(key, data=old, maxshape=(None,) + old.shape[1:])
        start = ds.shape[0]
        ds.resize(start + data.shape[0], axis=0)
        ds[start:] = data


def _replace_group(group, name, values):
    if name in group:
        del group[name]
    g = group.create_group(name)
    for k, v in values.items():
        g[k] = np.asarray(v)
    return g


def _write_generator_state(ensemble, group):
    state = getattr(ensemble, '_generator_state', None)
    if state is None:
        return
    device_type, data = state
    if GENERATOR_STATE in group:
        del group[GENERATOR_STATE]
    ds = group.create_dataset(GENERATOR_STATE, data=np.asarray(data, dtype=np.uint8))
    ds.attrs['device'] = device_type


def _stats_json(stats):
    return json.dumps({tag: {k: float(v) for k, v in s.items()} for tag, s in stats.items()})


# -- ensembles -------------------------------------------------------------

def ensemble_to_h5(ensemble, group):
    group.attrs['type'] = 'Ensemble'
    group.attrs['version'] = meta.version
    ensemble.Action.to_h5(group.create_group('action'))

    cfgs = group.create_group('configurations')
    for name, column in ensemble.configuration.fields.items():
        _write_column(cfgs, name, column)

    _write_column(group, 'index', np.asarray(ensemble.index))
    _write_column(group, 'weight', np.asarray(ensemble.weight))
    group.attrs['index_stride'] = int(ensemble.index_stride)

    final = ensemble.__dict__.get('_final')
    if final is None and len(ensemble):
        final = {k: ensemble.configuration[len(ensemble) - 1][k] for k in ensemble.Action.fields}
    if final is not None:
        _replace_group(group, 'final', final)

    if 'generator' in ensemble.__dict__:
        group.attrs['generator'] = json.dumps(generator_spec(ensemble.generator))
    if 'stats' in ensemble.__dict__:
        group.attrs['generator_stats'] = _stats_json(ensemble.stats)
    _write_generator_state(ensemble, group)

    measured = group.create_group('measured')
    for name in ensemble.measured:
        _write_column(measured, name, ensemble.__dict__[name])
    return group


def ensemble_from_h5(group, strict=True, device='cuda'):
    """The ensemble stored in ``group`` (by either package), measuring on
    ``device`` (the card unless ``device='cpu'``)."""
    from ..configurations import Configurations
    from ..ensemble import Ensemble

    check_version(group, strict=strict)
    action = action_from_h5(group['action'])
    e = Ensemble(action).from_configurations(
        Configurations({k: _read_column(group['configurations'][k])
                        for k in group['configurations']}), device=device)
    e.index = _read_column(group['index'])
    e.weight = _read_column(group['weight'])
    e.index_stride = int(group.attrs['index_stride'])
    if 'final' in group:
        e._final = {k: np.asarray(group['final'][k]) for k in group['final']}
    if 'generator' in group.attrs:
        e.generator = generator_from_spec(json.loads(group.attrs['generator']), action)
    if 'generator_stats' in group.attrs:
        e.stats = json.loads(group.attrs['generator_stats'])
    if GENERATOR_STATE in group:
        ds = group[GENERATOR_STATE]
        e._generator_state = (str(ds.attrs['device']), np.asarray(ds))
    if 'measured' in group:
        for name in group['measured']:
            e.__dict__[name] = _read_column(group['measured'][name])
    return e


def ensemble_extend_h5(ensemble, group):
    """Append ``ensemble``'s draws to an existing ensemble group."""
    cfgs = group['configurations']
    for name, column in ensemble.configuration.fields.items():
        _extend_column(cfgs, name, column)
    _extend_column(group, 'index', np.asarray(ensemble.index))
    _extend_column(group, 'weight', np.asarray(ensemble.weight))

    final = ensemble.__dict__.get('_final')
    if final is not None:
        _replace_group(group, 'final', final)
    if 'stats' in ensemble.__dict__:
        group.attrs['generator_stats'] = _stats_json(ensemble.stats)
    _write_generator_state(ensemble, group)
    # Drop stale cached measurements: they no longer cover the extended chain.
    if 'measured' in group:
        del group['measured']
        group.create_group('measured')
    return group


# -- fleets ------------------------------------------------------------------

def fleet_to_h5(fleet, group):
    group.attrs['type'] = 'Fleet'
    fleet.Action.to_h5(group.create_group('action'))
    cols = group.create_group('columns')
    for k, v in fleet.columns.items():
        cols.create_dataset(k, data=v, maxshape=(None,) + v.shape[1:])
    group.create_dataset('index', data=np.asarray(fleet.index), maxshape=(None,))
    group.create_dataset('weight', data=np.asarray(fleet.weight), maxshape=(None,))
    _replace_group(group, 'final', fleet.final)
    stats = group.create_group('stats')
    for tag, s in fleet.stats.items():
        _replace_group(stats, tag, s)


def fleet_from_h5(group, device='cuda'):
    from ..parallel.fleet import Fleet
    action = action_from_h5(group['action'])
    columns = {k: np.asarray(group['columns'][k]) for k in group['columns']}
    final = {k: np.asarray(group['final'][k]) for k in group['final']}
    stats = {tag: {k: float(np.asarray(group['stats'][tag][k])) for k in group['stats'][tag]}
             for tag in group['stats']}
    return Fleet(action, columns, stats, final, np.asarray(group['index']),
                 np.asarray(group['weight']), device=device)


def fleet_extend_h5(fleet, group):
    """Append ``fleet``'s records (the same chains, continued) to a fleet group:
    columns, index and weight grow along the record axis; final and stats are
    replaced by ``fleet``'s."""
    for k, v in fleet.columns.items():
        _extend_column(group['columns'], k, v)
    _extend_column(group, 'index', fleet.index)
    _extend_column(group, 'weight', fleet.weight)
    _replace_group(group, 'final', fleet.final)
    for tag, s in fleet.stats.items():
        _replace_group(group['stats'], tag, s)
