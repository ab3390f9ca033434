"""The gap between consecutive tokens of a request, the 95th percentile
over every gap that ends in the window."""

from kbench import stats


def read(run):
    v = stats.itl_values(run.token_times, run.t0, run.t1)
    return stats.percentile(v, 95) * 1e3 if v else None
