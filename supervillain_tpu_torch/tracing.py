"""Spans and counters of the port's own work.

:func:`span` names a stretch of host time.  While a ``torch.profiler``
records, it is ``torch.profiler.record_function(name)``: the span lands in
the profiler's trace, on one clock with the device's operations there, is
kept in memory by the profiler and written out when its owner exports the
trace.  Spans opened inside one another on the host thread nest in the
trace, so each span's parent is the span that held it (a record's spans lie
inside its ``fleet.record``, a call's inside its ``fleet.call``).  With no
profiler recording, :func:`span` returns one shared no-op context manager:
the cost is one flag check.

:func:`count` adds to process-wide integer counters, always on.
:func:`count_on_device` adds a tensor of counts to accumulators kept on the
tensor's device, so that counting never waits for the device.
:func:`counters` returns a snapshot of both (reading the device accumulators
synchronises their devices) and :func:`reset` clears them.

The spans in use beyond the fleet drivers' (``fleet.*``, see
:mod:`.parallel.fused_fleet`): ``update.<name>`` around each sub-generator's
step inside :class:`.generators.combining.Sequentially` (``update.VortexUpdate``,
``update.CoexactUpdate``, ``update.WrappingUpdate``, ``update.ClassicWorm``;
``update.SiteUpdate`` and the other Villain updates alike).

The counters in use, and what counts them:

- ``fleet.records``, ``fleet.host_bytes``, ``fleet.final_bytes``,
  ``fleet.syncs``: the fleet driver (:mod:`.parallel.fleet`,
  :mod:`.parallel.fused_fleet`);
- ``fleet.pinned_bytes`` (the bytes of ``fleet.host_bytes`` and
  ``fleet.final_bytes`` that landed in page-locked memory),
  ``fleet.pinned_new_bytes`` (page-locked memory the process's pinned cache
  had to pin anew for them) and ``fleet.pinned_fallbacks`` (buffers left
  pageable where pinning failed): the fused fleet on cards
  (:class:`.parallel.fleet.Landing`);
- ``sweep.villain.barrier_cycles``, ``sweep.villain.cycles``: the resident
  Villain sweep's thread 0 of each block, clock cycles waited at cluster
  barriers and in all, counted only while a profiler records
  (:func:`.ops.sweep.kernel_sweeps`);
- ``worm.worldline.calls``, ``worm.worldline.worms``,
  ``worm.worldline.moves``, ``worm.worldline.longest``,
  ``worm.worldline.truncated``: the Worldline worm's calls (B5 in D=2, K2 at
  D >= 3), their chains' worms, the moves of all of them and of each call's
  longest, and the worms truncated, counted on the device only while a
  profiler records (:class:`.generators.worldline.ClassicWorm`);
- ``space.halo_exchange``, ``space.gather_chain``, ``space.scatter_chain``,
  ``space.gather_slices`` (:mod:`.parallel.space`) and
  ``distributed.collective`` (:mod:`.parallel.distributed`): calls.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch

_OFF = contextlib.nullcontext()
_host = Counter()
#: (names, device) -> int64 tensor of one accumulator a name, on the device.
_device = {}


def recording() -> bool:
    """Whether a ``torch.profiler`` records on this thread."""
    return torch._C._autograd._profiler_enabled()


def span(name):
    """A context manager that names the host time inside it ``name`` in the
    trace of a recording profiler, and does nothing otherwise."""
    return torch.profiler.record_function(name) if recording() else _OFF


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    _host[name] += n


def count_on_device(names, values):
    """Add ``values``, a tensor of one integer a name of ``names``, to their
    accumulators on its device, without waiting for it."""
    key = (tuple(names), values.device)
    if key in _device:
        _device[key].add_(values)
    else:
        _device[key] = values.to(torch.int64, copy=True)


def counters():
    """Every counter's value: the host's and, read from their devices, the
    device accumulators', summed by name."""
    out = Counter(_host)
    for (names, _), values in _device.items():
        for name, value in zip(names, values.tolist()):
            out[name] += value
    return dict(out)


def reset():
    """Clear every counter."""
    _host.clear()
    _device.clear()
