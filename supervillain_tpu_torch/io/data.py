"""Generic HDF5 object persistence: a copy of :mod:`supervillain_tpu.io.data`,
writing the same nodes.

Arbitrary nested user payloads (dicts of lists of arrays, framework objects,
...) round-trip through a single ``write(group, name, value)`` /
``read(node)`` pair, with a pickle fallback for anything no strategy claims.
Dispatch is type-driven, and each node records its strategy name in an HDF5
attribute so that ``read`` is self-describing.  Framework classes with their
own typed ``to_h5/from_h5`` schema participate through a small name→class
registry.  Tensors are written as the NumPy arrays of their values.
"""

from __future__ import annotations

import pickle

import numpy as np

from .. import meta

#: Registered classes with a ``to_h5(group)`` method and a ``from_h5(group)``
#: classmethod; ``write`` dispatches instances to their own schema and tags the
#: node so ``read`` can find the class again.
readwriteable_registry = {}


def register(cls, name=None):
    """Register ``cls`` (which provides to_h5/from_h5) for generic dispatch.

    Usable as a decorator.  Subclassing :class:`ReadWriteable` registers
    automatically.
    """
    readwriteable_registry[name or cls.__name__] = cls
    return cls


class ReadWriteable:
    """Mixin giving a class automatic H5 persistence by walking ``__dict__``.

    Subclasses are auto-registered, so ReadWriteable objects can nest inside
    each other and inside lists/dicts handled by :func:`write`.
    """

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        register(cls)

    def to_h5(self, group):
        group.attrs['strategy'] = 'readwriteable'
        group.attrs['class'] = type(self).__name__
        for key, value in self.__dict__.items():
            write(group, key, value)
        return group

    @classmethod
    def from_h5(cls, group):
        obj = cls.__new__(cls)
        for key in group:
            obj.__dict__[key] = read(group[key])
        for key, value in group.attrs.items():
            if key.startswith('attr:'):
                obj.__dict__[key[5:]] = value
        return obj


def write(group, name, value):
    """Write an arbitrary Python object under ``group[name]``.

    Dispatch: registered framework classes → their own to_h5 schema;
    dict/list/tuple → recursive groups; str/bytes/scalars/ndarrays → datasets;
    None → tagged empty group; anything else → pickle fallback.

    Every node is stamped with the running package ``@version`` so a
    cross-version :func:`read` can warn (lenient) or refuse (strict).
    """
    node = _write(group, name, value)
    node.attrs['version'] = meta.version
    return node


def _write(group, name, value):
    cls_name = type(value).__name__
    if cls_name in readwriteable_registry and hasattr(value, 'to_h5'):
        g = group.create_group(name)
        value.to_h5(g)
        g.attrs['strategy'] = 'readwriteable'
        g.attrs['class'] = cls_name
        return g

    if value is None:
        g = group.create_group(name)
        g.attrs['strategy'] = 'none'
        return g

    if isinstance(value, dict):
        if all(isinstance(k, str) for k in value):
            g = group.create_group(name)
            g.attrs['strategy'] = 'dict'
            for k, v in value.items():
                write(g, k, v)
            return g
        # Non-string keys: store (key, value) pairs, each side generic.
        g = group.create_group(name)
        g.attrs['strategy'] = 'dict-items'
        for i, (k, v) in enumerate(value.items()):
            item = g.create_group(str(i))
            write(item, 'key', k)
            write(item, 'value', v)
        g.attrs['length'] = len(value)
        return g

    if isinstance(value, (list, tuple)):
        g = group.create_group(name)
        g.attrs['strategy'] = 'list' if isinstance(value, list) else 'tuple'
        g.attrs['length'] = len(value)
        for i, v in enumerate(value):
            write(g, str(i), v)
        return g

    if isinstance(value, str):
        ds = group.create_dataset(name, data=value)
        ds.attrs['strategy'] = 'str'
        return ds

    if isinstance(value, bytes):
        ds = group.create_dataset(name, data=np.void(value))
        ds.attrs['strategy'] = 'bytes'
        return ds

    if isinstance(value, (bool, np.bool_)):
        ds = group.create_dataset(name, data=bool(value))
        ds.attrs['strategy'] = 'bool'
        return ds

    if isinstance(value, (int, float, complex, np.number)):
        ds = group.create_dataset(name, data=value)
        ds.attrs['strategy'] = 'scalar'
        return ds

    if isinstance(value, np.ndarray) and value.dtype != object:
        ds = group.create_dataset(name, data=value)
        ds.attrs['strategy'] = 'array'
        return ds

    # Tensors and anything else array-like but not ndarray:
    try:
        arr = value.detach().cpu().numpy() if hasattr(value, 'detach') else np.asarray(value)
        if arr.dtype != object:
            ds = group.create_dataset(name, data=arr)
            ds.attrs['strategy'] = 'array'
            return ds
    except Exception:
        pass

    ds = group.create_dataset(name, data=np.void(pickle.dumps(value)))
    ds.attrs['strategy'] = 'pickle'
    return ds


def read(node, strict=True):
    """Inverse of :func:`write`: reconstruct the object stored at ``node``.

    ``strict`` controls the per-payload version check: a payload stamped by a
    different package version raises when strict and logs a warning
    otherwise; payloads written before versioning pass silently.
    """
    from .h5 import check_version
    check_version(node, strict=strict)
    strategy = node.attrs.get('strategy')
    if strategy == 'readwriteable':
        cls = readwriteable_registry[node.attrs['class']]
        return cls.from_h5(node)
    if strategy == 'none':
        return None
    if strategy == 'dict':
        return {k: read(node[k], strict) for k in node}
    if strategy == 'dict-items':
        n = int(node.attrs['length'])
        return {read(node[str(i)]['key'], strict): read(node[str(i)]['value'], strict)
                for i in range(n)}
    if strategy in ('list', 'tuple'):
        n = int(node.attrs['length'])
        seq = [read(node[str(i)], strict) for i in range(n)]
        return seq if strategy == 'list' else tuple(seq)
    if strategy == 'str':
        v = node[()]
        return v.decode() if isinstance(v, bytes) else str(v)
    if strategy == 'bytes':
        return node[()].tobytes()
    if strategy == 'bool':
        return bool(node[()])
    if strategy == 'scalar':
        return node[()].item()
    if strategy == 'array':
        return np.asarray(node)
    if strategy == 'pickle':
        return pickle.loads(node[()].tobytes())
    # Untagged nodes (e.g. hand-written files): best effort.
    import h5py
    if isinstance(node, h5py.Group):
        return {k: read(node[k], strict) for k in node}
    return np.asarray(node)
