"""Reference-compatible namespace alias of :mod:`..observables` (counterpart of
:mod:`supervillain_tpu.observable`)."""

from ..observables import *  # noqa: F401,F403
from ..observables import registry, derived_registry, progress
