"""Timing harnesses of the port: :mod:`.dimension` (D ≥ 3 site-updates/s
against the chain count) and :mod:`.form_kernels` (the incidence operators)."""

from .form_kernels import benchmark_form_kernels
