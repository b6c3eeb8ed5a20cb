"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W) and the
least time a piece of work can take on a number of them.

Integer work (Philox) is counted at the float32 rate of the CUDA cores, which
is twice the card's integer rate, so a share against these peaks only reads
low, never above what the card can do.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12          # float32 outside the tensor cores
#: Operations of one Philox-4x32-10 call: 10 rounds of 4 multiplies, 4 XORs
#: and 2 key additions.
PHILOX_OPS = 100


def least_seconds(nbytes, ops, cards=1):
    """The larger of ``nbytes`` over the memory rate and ``ops`` over the
    operation rate of ``cards`` cards."""
    return max(nbytes / (HBM_BYTES_PER_S * cards), ops / (PEAK_OPS_PER_S * cards))


def bound_by(nbytes, ops):
    """Which of the two rates bounds the work: 'bytes' or 'operations'."""
    return 'bytes' if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S else 'operations'
