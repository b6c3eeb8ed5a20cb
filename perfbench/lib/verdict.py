"""The comparison that decides ``correct``: the program's records against the
plain reference's, chain by chain.

The reference replays a sample of the checked call's chains from the same
cold start on the same Philox streams.  Where the two agree a chain's records
agree: its inline columns (the float ones to ``FLOAT_RTOL``, a float32 sum of
the lattice's terms over a call's sweeps, taken in another order), its worm
histogram, length and truncation exactly, and after the call its fields bit
for bit.  A chain *parts* at the first record that disagrees (its final
fields count with the last record).  The kernels and the reference may part
where the rounding of one ΔS flips one Metropolis decision: rarely, and once a
chain has parted it stays parted, since its state differs.  So the number
compared is the share of the checked chains that part anywhere in the call.
The checked chains are drawn one from each of as many equal blocks of the
fleet, so that a fault in any half (or any card's shard) of the fleet parts
that share of them at least.  A program that computes something else parts
every chain, a share of 1.  A fault parts its chains at once, in the call's
first record or its second, where a rounding flip seldom falls in a long call;
so a second number is the share that part within the first ``EARLY_RECORDS``
records, which stays near 0 for a sound run of any length.
"""

from __future__ import annotations

import numpy as np

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-9
EARLY_RECORDS = 2


def agree(name, program, reference):
    """Whether one chain-record's column ``name`` agrees."""
    a = np.asarray(program, dtype=np.float64)
    b = np.asarray(reference, dtype=np.float64)
    if a.shape != b.shape:
        return False
    if name in ('ActionDensity', 'WindingSquared'):
        return bool(np.all(np.abs(a - b) <= FLOAT_ATOL + FLOAT_RTOL * np.abs(b)))
    return bool(np.array_equal(a, b))


def partings(program, reference, program_final, reference_final):
    """Per checked chain, the record at which it parts (None where it never
    does), and the chain-records compared: ``program``/``reference`` map each
    column to an array (records, chains, ...), the ``*_final`` each field to
    (chains, ...)."""
    names = sorted(reference)
    missing = [k for k in names if k not in program]
    records, chains = reference[names[0]].shape[:2]
    parted, observed = [], 0
    for c in range(chains):
        at = 0 if missing else None
        for r in range(records if at is None else 0):
            if not all(agree(k, program[k][r, c], reference[k][r, c]) for k in names):
                at = r
                break
        if at is None and not all(
                k in program_final and np.array_equal(np.asarray(program_final[k][c]),
                                                      np.asarray(reference_final[k][c]))
                for k in reference_final):
            at = records - 1
        parted.append(at)
        observed += records if at is None else at + 1
    return parted, observed


def shares(parted):
    """{'parted_share', 'early_parted_share'} of per-chain parting records."""
    n = max(1, len(parted))
    return {'parted_share': sum(p is not None for p in parted) / n,
            'early_parted_share': sum(p is not None and p < EARLY_RECORDS for p in parted) / n}
