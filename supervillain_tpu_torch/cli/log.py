"""Logging configuration for the command-line tools: a copy of
:mod:`supervillain_tpu.cli.log`.

``--log-level`` and ``--log-format`` flags whose parsing immediately
reconfigures the root logger; ``--log-format`` accepts either a raw
``logging`` format string or one of the preset names in :data:`FORMATS`.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

#: Named format presets accepted by --log-format (a raw %-style format string
#: is accepted too).
FORMATS = {
    'detailed': '%(asctime)s %(name)-30s %(levelname)10s %(message)s',
    'plain': '%(levelname)s: %(message)s',
    'timed': '%(asctime)s %(levelname)s %(message)s',
    'bare': '%(message)s',
    'json': None,  # structured records; see _JsonFormatter
}

DEFAULT_FORMAT = 'detailed'

LEVELS = ('DEBUG', 'INFO', 'WARNING', 'ERROR', 'CRITICAL')


class _JsonFormatter(logging.Formatter):
    """One JSON object per record: machine-readable logs for pipeline tooling."""

    def format(self, record):
        payload = {
            'time': self.formatTime(record),
            'name': record.name,
            'level': record.levelname,
            'message': record.getMessage(),
        }
        if record.exc_info:
            payload['exception'] = self.formatException(record.exc_info)
        return json.dumps(payload)


def formatter(fmt):
    """A logging.Formatter for a preset name or a raw format string."""
    if fmt == 'json':
        return _JsonFormatter()
    return logging.Formatter(FORMATS.get(fmt, fmt))


def configure(level='WARNING', fmt=DEFAULT_FORMAT, stream=sys.stdout, force=False):
    """Configure the root logger; existing handlers get the new formatter."""
    root = logging.getLogger()
    if not root.handlers or force:
        handler = logging.StreamHandler(stream)
        root.handlers = [handler]
    root.setLevel(getattr(logging, level) if isinstance(level, str) else level)
    f = formatter(fmt)
    for handler in root.handlers:
        handler.setFormatter(f)


class _LevelAction(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        logging.getLogger().setLevel(getattr(logging, values))


class _FormatAction(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        f = formatter(values)
        for handler in logging.getLogger().handlers:
            handler.setFormatter(f)


def defaults():
    """An add_help=False parent parser contributing --log-level/--log-format."""
    parent = argparse.ArgumentParser(add_help=False)
    parent.add_argument('--log-level', default='WARNING', choices=list(LEVELS),
                        action=_LevelAction,
                        help='Log level.')
    parent.add_argument('--log-format', default=DEFAULT_FORMAT, action=_FormatAction,
                        help='Log format: a %%-style format string or one of '
                             f'{sorted(FORMATS)}.')
    return parent
