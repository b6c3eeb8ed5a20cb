"""``sweep_plan``: the CUDA sweep kernel's regime and cluster layout, computed
on the host from N alone, for every even N from 2 to 1024; ``sum_bands``: the
streaming inline sums' blocks a chain, from N alone."""

import pytest

from supervillain_tpu_torch.ops.sweep import (CLUSTER_SIZES, RESIDENT_BYTES_PER_SITE,
                                              RESIDENT_SHARED_BYTES, RESIDENT_THREADS,
                                              STREAMING_THREADS, SUM_SITES, TABLE_PLAN, bands,
                                              sum_bands, sweep_plan)

EVEN_N = range(2, 1025, 2)
BLOCK_SHARED_BYTES = 232_448    # shared memory one H100 block may use (dynamic + static)
PORTABLE_CLUSTER = 8


def _fits(N, k):
    return RESIDENT_BYTES_PER_SITE * -(-N // k) * N <= RESIDENT_SHARED_BYTES


def test_bands_cover_each_row_exactly_once():
    for N in EVEN_N:
        plan = sweep_plan(N)
        if plan.regime == 'streaming':
            assert bands(N, plan.cluster) == []
            continue
        cut = bands(N, plan.cluster)
        assert len(cut) == plan.cluster
        rows = [t for start, h in cut for t in range(start, start + h)]
        assert rows == list(range(N)), N
        heights = {h for _, h in cut}
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
    assert bands(N, TABLE_PLAN.cluster) == []


def test_sum_bands_fill_the_card_at_the_l1024_cell():
    """64 chains of N=1024 (``villain-l1024-w2``): 64 bands of 16 rows a chain,
    4096 blocks, over three times what 132 SMs of 2048 threads hold at once."""
    assert sum_bands(1024) == 64 and bands(1024, 64)[-1] == (1008, 16)
    assert 64 * 64 >= 3 * 132 * 2048 // STREAMING_THREADS


@pytest.mark.parametrize('N, k', [(2, 1), (16, 1), (181, 1), (182, 2), (306, 5), (311, 5),
                                  (1024, 64), (4096, 1024), (16384, 16384)])
def test_sum_bands_are_a_function_of_n_alone(N, k):
    """About :data:`SUM_SITES` sites a band, one band under twice that, and
    never more bands than rows."""
    assert sum_bands(N) == k


def test_sum_bands_cover_each_row_once_in_bands_of_about_sum_sites():
    for N in range(2, 1100):
        k = sum_bands(N)
        assert 1 <= k <= N, N
        cut = bands(N, k)
        rows = [t for start, h in cut for t in range(start, start + h)]
        assert rows == list(range(N)), N
        sites = [h * N for _, h in cut]
        assert max(sites) - min(sites) <= N, N
        if k == 1:
            assert N * N < 2 * SUM_SITES, N
        else:
            assert SUM_SITES - N <= min(sites) and max(sites) < 2 * SUM_SITES, N


def test_bands_split_an_uneven_chain_like_the_resident_clusters():
    assert bands(1024, 33) == [(t * 31 + min(t, 1), 31 + (t < 1)) for t in range(33)]
    assert bands(310, 7)[:3] == [(0, 45), (45, 45), (90, 44)]
    assert bands(8, 0) == []
    assert bands(250, sweep_plan(250).cluster) == bands(250, 8)
