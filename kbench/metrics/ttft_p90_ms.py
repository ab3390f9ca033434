"""Time to first token, from the moment a request fell due to its first
token, the 90th percentile over every request due in the window; one still
without a token at the window's close counts its wait so far."""

from kbench import stats


def read(run):
    v = stats.ttft_values(run.due, run.first, run.t0, run.t1)
    return stats.percentile(v, 90) * 1e3 if v else None
