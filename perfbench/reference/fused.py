"""One call of the fused fleet as its references replay it, for any action.

The fused fleet draws each launch's 63-bit kernel seed on the host, from a
``torch.Generator`` seeded with the call's fleet seed, in launch order; an
action's reference replays a record (its sweep call and worm call, each keyed
by the next seed) from the cold start, on the chains it is given.
"""

from __future__ import annotations

import numpy as np
import torch


def kernel_seeds(seed):
    """The fleet's kernel seeds, in the order its launches draw them."""
    host = torch.Generator().manual_seed(int(seed))
    while True:
        yield int(torch.randint(0, 2 ** 63 - 1, (), generator=host))


def replay(cold, record, fields, seed, chains, traffic, device, dtype):
    """The columns (records, chains, ...) and final fields (chains, ...) of the
    fleet's chains ``chains`` in the call with fleet seed ``seed``, as NumPy
    arrays (floats as float32), from the action's ``cold`` start and ``record``."""
    index = torch.tensor(chains, dtype=torch.int64, device=device)
    state = cold(len(chains), traffic['L'], device, dtype)
    stream, columns = kernel_seeds(seed), {}
    for _ in range(traffic['records_per_call']):
        state, inline = record(state, stream, index, traffic, dtype)
        for k, v in inline.items():
            columns.setdefault(k, []).append(v.float().cpu().numpy())
    final = {name: (f.float() if f.is_floating_point() else f).cpu().numpy()
             for name, f in zip(fields, state)}
    return {k: np.stack(v) for k, v in columns.items()}, final
