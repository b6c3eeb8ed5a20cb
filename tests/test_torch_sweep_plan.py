"""``sweep_plan``: the CUDA sweep kernel's regime and cluster layout, computed
on the host from N alone, for every even N from 2 to 1024."""

import pytest

from supervillain_tpu_torch.ops.sweep import (CLUSTER_SIZES, RESIDENT_BYTES_PER_SITE,
                                              RESIDENT_SHARED_BYTES, RESIDENT_THREADS,
                                              TABLE_PLAN, sweep_plan)

EVEN_N = range(2, 1025, 2)
BLOCK_SHARED_BYTES = 232_448    # shared memory one H100 block may use (dynamic + static)
PORTABLE_CLUSTER = 8


def _fits(N, k):
    return RESIDENT_BYTES_PER_SITE * -(-N // k) * N <= RESIDENT_SHARED_BYTES


def test_bands_cover_each_row_exactly_once():
    for N in EVEN_N:
        plan = sweep_plan(N)
        if plan.regime == 'streaming':
            assert plan.bands(N) == []
            continue
        bands = plan.bands(N)
        assert len(bands) == plan.cluster
        rows = [t for start, h in bands for t in range(start, start + h)]
        assert rows == list(range(N)), N
        heights = {h for _, h in bands}
        assert max(heights) == plan.rows and max(heights) - min(heights) <= 1, N


def test_plans_fit_a_block_and_a_portable_cluster():
    for N in EVEN_N:
        plan = sweep_plan(N)
        if plan.regime == 'streaming':
            assert (plan.cluster, plan.rows, plan.shared_bytes) == (0, 0, 0)
            continue
        assert plan.shared_bytes == RESIDENT_BYTES_PER_SITE * plan.rows * N
        assert plan.shared_bytes + 1024 <= BLOCK_SHARED_BYTES
        assert plan.cluster in CLUSTER_SIZES and plan.cluster <= PORTABLE_CLUSTER
        # The fewest blocks that hold the chain.
        assert not any(_fits(N, k) for k in CLUSTER_SIZES if k < plan.cluster), N
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= RESIDENT_THREADS
        assert plan.threads >= min(RESIDENT_THREADS, plan.rows * N // 2)


def test_regime_switches_where_the_byte_count_says():
    regimes = {N: sweep_plan(N).regime for N in EVEN_N}
    for N, regime in regimes.items():
        # 20 bytes a site in bands of ceil(N / 8) rows against a block's budget.
        resident = 20 * -(-N // 8) * N <= 232_448 - 1024
        assert regime == ('resident' if resident else 'streaming'), N
    assert max(N for N, r in regimes.items() if r == 'resident') == 304
    assert min(N for N, r in regimes.items() if r == 'streaming') == 306
    assert max(N for N in EVEN_N if sweep_plan(N).cluster == 1) == 106
    assert sweep_plan(256)[:3] == ('resident', 8, 32)     # the main path's shape
    assert sweep_plan(512).regime == 'streaming'


@pytest.mark.parametrize('N', [0, 1, -2])
def test_plan_rejects_what_the_kernel_does_not_take(N):
    with pytest.raises(ValueError, match='N >= 2'):
        sweep_plan(N)


@pytest.mark.parametrize('N', [3, 5, 7, 11, 255, 513, 1025])
def test_odd_n_runs_the_table_plan(N):
    """An odd N, whose torus needs four colors, streams one launch a color over
    a color table: no resident band, no cluster."""
    assert sweep_plan(N) == TABLE_PLAN
    assert (TABLE_PLAN.cluster, TABLE_PLAN.rows, TABLE_PLAN.shared_bytes) == (0, 0, 0)
    assert TABLE_PLAN.bands(N) == []
