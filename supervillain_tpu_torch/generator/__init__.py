"""Reference-compatible namespace alias of :mod:`..generators` (counterpart of
:mod:`supervillain_tpu.generator`)."""

from ..generators.base import Generator, DoNothing
from ..generators.combining import Sequentially, KeepEvery
from ..generators.monitor import Logger
from ..generators import villain
from ..generators import worldline
from ..generators import combining
