"""Command-line tooling: a copy of :mod:`supervillain_tpu.cli` for the port.

:class:`ArgumentParser` with the logging and metadata flags, the :func:`W` type
accepting ``inf``, and :func:`input_file` (script-as-config loading); and the
two helpers the port's example scripts share, :func:`progress` and
:func:`h5py`, which import the optional packages they need only when called.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys

from .. import meta
from .. import license as _license

#: Short banner (parser epilogs); --copyright prints the full document.
COPYRIGHT = f'supervillain-tpu-torch {meta.version} ({meta.nickname})'
#: SPDX tag; --license prints the full text.
LICENSE = 'MIT'


def W(value):
    """Parse the constraint integer, accepting 'inf', '∞', or 'infinity'.

    >>> W('2')
    2
    >>> W('inf')
    inf
    >>> W('∞')
    inf
    >>> W('0')
    Traceback (most recent call last):
        ...
    argparse.ArgumentTypeError: W must be a positive integer or inf, got 0
    """
    if str(value).lower() in ('inf', 'infinity', '∞'):
        return float('inf')
    w = int(value)
    if w < 1:
        raise argparse.ArgumentTypeError(f'W must be a positive integer or inf, got {value}')
    return w


def input_file(path):
    """Load a user python file as a module (script-as-config)."""
    spec = importlib.util.spec_from_file_location('input', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def progress(iterable, **kwargs):
    """``tqdm``'s progress bar over ``iterable`` where tqdm imports, else the
    iterable itself: the bar is optional."""
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, **kwargs)


def h5py():
    """The ``h5py`` module, for a script asked to write an h5 file; raises a
    RuntimeError naming the missing package where it does not import."""
    try:
        import h5py as module
    except ImportError as error:
        raise RuntimeError('writing an h5 file (--h5) needs the h5py package, '
                           'which does not import here') from error
    return module


class _MetadataAction(argparse.Action):
    def __init__(self, option_strings, dest, text='', **kwargs):
        self.text = text
        super().__init__(option_strings, dest, nargs=0, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        print(self.text)
        parser.exit()


from . import log as log  # noqa: E402  (submodule; the JAX package's name)


def _metadata_parent():
    parent = argparse.ArgumentParser(add_help=False)
    parent.add_argument('--version', action=_MetadataAction, text=meta.version)
    parent.add_argument('--copyright', action=_MetadataAction,
                        text=_license.copyright())
    parent.add_argument('--license', action=_MetadataAction,
                        text=_license.license())
    return parent


class ArgumentParser(argparse.ArgumentParser):
    """argparse.ArgumentParser with default --log-level/--log-format and
    --version/--copyright/--license flags; parsing configures logging."""

    def __init__(self, *args, **kwargs):
        parents = list(kwargs.pop('parents', ()))
        parents += [log.defaults(), _metadata_parent()]
        kwargs.setdefault('epilog', COPYRIGHT)
        super().__init__(*args, parents=parents, **kwargs)

    def parse_args(self, *args, **kwargs):
        parsed = super().parse_args(*args, **kwargs)
        if hasattr(parsed, 'log_level'):
            log.configure(level=parsed.log_level, fmt=parsed.log_format,
                          stream=sys.stdout)
        return parsed
