"""Matching the program's kernels by their names in a device trace."""

import re


def signature(name):
    """A kernel's name as a trace gives it, without its namespaces, 'void '
    and its argument list: 'void (anonymous namespace)::worm_kernel<true>(int2*,
    ...)' -> 'worm_kernel<true>'."""
    name = name.replace('(anonymous namespace)::', '')
    name = re.sub(r'\(.*', '', name).strip().removeprefix('void ').strip()
    head, bracket, tail = name.partition('<')
    return head.rsplit('::', 1)[-1] + bracket + tail


def base_name(name):
    """:func:`signature` without template arguments: 'worm_kernel'."""
    return signature(name).partition('<')[0]


def templated(name):
    """Whether a kernel's name carries template arguments."""
    return '<' in signature(name)


#: What names PyTorch's own kernels in a trace: the generic path's updates,
#: draws and sums, none of the program's hand-written kernels.
NATIVE = 'at::native'


def native(name):
    """Whether a kernel is one of PyTorch's own."""
    return NATIVE in name
