"""value(err) uncertainty formatting: a copy of
:mod:`supervillain_tpu.analysis.uncertain`."""

from __future__ import annotations

import math
import re


def _exponent_suffix(exponent, E=False):
    """' × 10^±e' (default) or 'e±e' (E-notation); empty at exponent 0."""
    if exponent == 0:
        return ''
    if E:
        return f'e{int(exponent):+}'
    return f' × 10^{int(exponent):+}'


class Uncertain:
    r"""A central value with a symmetric uncertainty, formatted NIST-style.

    ``str()`` produces signed scientific shorthand with two uncertainty
    digits:

    >>> str(Uncertain(0.51099895000, 0.00000000015))
    '+5.1099895000(15) × 10^-1'

    The format-spec mini-language (order-insensitive flags, matching the
    reference's semantics):

    * ``u<digits>`` — significant digits of the uncertainty shown in
      parentheses (default 2); mutually exclusive with ``.precision``:

      >>> format(Uncertain(0.1179, 0.0010), 'u1')
      '1.18(1) × 10^-1'

    * ``.<precision>`` — fix the decimals of the mantissa instead; an
      uncertainty too small on that scale still shows as ``(0)``:

      >>> format(Uncertain(0.1179, 0.00001), '.2')
      '1.18(0) × 10^-1'

    * ``e`` — scientific E-notation instead of ``× 10^``:

      >>> format(Uncertain(0.1179, 0.0010), 'ue')
      '1.179(10)e-1'

    * ``+`` — force a leading sign (implied by the empty spec, hence ``str``):

      >>> format(Uncertain(0.1179, 0.0010), '+u2')
      '+1.179(10) × 10^-1'

    Exceptional cases, as in the reference:

    >>> str(Uncertain(3.14159, 0))      # zero uncertainty: just the mean
    '+3.14159'
    >>> str(Uncertain(1, 10))           # uncertainty >= |mean|: explicit ±
    '(+1.00 ± 10.00)'
    >>> str(Uncertain(8.5, 3.1))        # one trustworthy digit keeps the point
    '+8.5(3.1)'

    A zero mean with nonzero uncertainty formats as ``(±0.00 ± u)`` instead of
    raising like the reference does (extension).
    """

    def __init__(self, mean, uncertainty):
        self.mean = float(mean)
        self.uncertainty = abs(float(uncertainty))

    def __repr__(self):
        return f'Uncertain({self.mean}, {self.uncertainty})'

    def __str__(self):
        return format(self, '+u2')

    @staticmethod
    def _parse_spec(spec):
        leftover = re.sub(r'u(\d*)|\.(\d+)|[+e]', '', spec)
        if leftover:
            raise ValueError(f'Invalid format spec {spec!r} for Uncertain')
        u = re.search(r'u(\d*)', spec)
        p = re.search(r'\.(\d+)', spec)
        plus = '+' if ('+' in spec or spec == '') else ''
        E = 'e' in spec
        udigits = int(u.group(1) or 0) if u else 0
        precision = int(p.group(1)) if p else 0
        return plus, E, udigits, precision

    def __format__(self, spec):
        plus, E, udigits, precision = self._parse_spec(spec)
        mean, err = self.mean, self.uncertainty

        exponent = math.floor(math.log10(abs(mean))) if mean != 0 else 0

        if err == 0:
            return f'{mean / 10 ** exponent:{plus}}' + _exponent_suffix(exponent, E)

        if exponent != 0:
            scaled = Uncertain(mean / 10 ** exponent, err / 10 ** exponent)
            return format(scaled, spec) + _exponent_suffix(exponent, E)

        # The mantissa's integer part is now a single digit (or the mean is 0).
        if precision and udigits:
            raise ValueError(f'Cannot specify both floating point precision '
                             f'.{precision} and uncertainty specification u{udigits}.')

        if err >= abs(mean):
            p = precision if precision else 2
            return f'({mean:{plus}.{p}f} ± {err:.{p}f})'

        if precision:
            decimals = precision
            shown = int(err / 10 ** (-decimals))  # truncate so (0) can appear
        else:
            decimals = -math.floor(math.log10(err)) + (udigits - 1 if udigits else 1)
            shown = int(math.ceil(err / 10 ** (-decimals)))

        if decimals > 1:
            return f'{mean:{plus}.{decimals}f}({shown})'
        # One trustworthy digit: keep the decimal point, e.g. 8.5(3.1).
        return f'{mean:{plus}.{decimals}f}({shown / 10:.1f})'

    @classmethod
    def from_string(cls, string):
        """Parse ``'1.2346(32)'``, ``'9.109(28)E-31'``, ``'1.672(51) × 10^-27'``,
        ``'8.5(3.1)'`` or ``'(1836.15 ± 0.01)'`` back into an :class:`Uncertain`.
        An uncertainty with a decimal point is in the mean's units, as
        :meth:`__format__` writes it (the JAX package's copy reads it in units
        of the last digit, ten times too small)."""
        string = string.strip()
        if 'E' in string:
            stem, _, exp = string.partition('E')
            scale = 10.0 ** int(exp)
            inner = cls.from_string(stem)
            return cls(inner.mean * scale, inner.uncertainty * scale)
        if '×' in string:
            stem, _, rest = string.partition('×')
            scale = 10.0 ** int(rest.split('^')[1])
            inner = cls.from_string(stem)
            return cls(inner.mean * scale, inner.uncertainty * scale)
        if string.startswith('(') and string.endswith(')'):
            mean, _, err = string[1:-1].partition('±')
            return cls(float(mean), float(err))
        mean, _, err = string.partition('(')
        err = err.rstrip(')')
        if '.' in err:      # one trustworthy digit, '8.5(3.1)': in the mean's units
            return cls(float(mean), float(err))
        decimals = len(mean.partition('.')[2])
        return cls(float(mean), float(err) * 10.0 ** (-decimals))
