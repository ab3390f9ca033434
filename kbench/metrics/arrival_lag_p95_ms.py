"""Load generator: how late each request of an open arrival law was submitted
after it fell due (the harness submits only between steps), the 95th
percentile over the window's requests."""

from kbench import stats


def read(run):
    if not run.lags:
        return None
    return stats.percentile(run.lags, 95) * 1e3
