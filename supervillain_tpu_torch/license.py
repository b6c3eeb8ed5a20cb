"""The license and copyright texts that ``--license`` and ``--copyright`` print:
a copy of :mod:`supervillain_tpu.license` for the port.

``license()`` prefers the repo-root ``LICENSE`` file when the package runs
from a checkout (so edits to the file win), falling back to the embedded text
when installed without it.
"""

from __future__ import annotations

from pathlib import Path

from . import meta

_MIT = """MIT License

Copyright (c) 2026 supervillain-tpu contributors

Permission is hereby granted, free of charge, to any person obtaining a copy
of this software and associated documentation files (the "Software"), to deal
in the Software without restriction, including without limitation the rights
to use, copy, modify, merge, publish, distribute, sublicense, and/or sell
copies of the Software, and to permit persons to whom the Software is
furnished to do so, subject to the following conditions:

The above copyright notice and this permission notice shall be included in all
copies or substantial portions of the Software.

THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND, EXPRESS OR
IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF MERCHANTABILITY,
FITNESS FOR A PARTICULAR PURPOSE AND NONINFRINGEMENT. IN NO EVENT SHALL THE
AUTHORS OR COPYRIGHT HOLDERS BE LIABLE FOR ANY CLAIM, DAMAGES OR OTHER
LIABILITY, WHETHER IN AN ACTION OF CONTRACT, TORT OR OTHERWISE, ARISING FROM,
OUT OF OR IN CONNECTION WITH THE SOFTWARE OR THE USE OR OTHER DEALINGS IN THE
SOFTWARE.
"""



def license():
    """The full license text."""
    path = Path(__file__).parent.parent / 'LICENSE'
    try:
        return path.read_text()
    except OSError:
        return _MIT


def copyright():
    """Copyright banner plus the full license."""
    return f'supervillain-tpu-torch {meta.version} ({meta.nickname})\n\n{license()}'
