"""Model step: the MoE routing's share of the packed step's device time:
the regions ``moe.route`` (the router), ``moe.dispatch`` (the sort-based
dispatch into capacity slots) and ``moe.combine`` over the time of every
region of the traced steps (``comp_share`` explains how the region times
are read). The expert products are ``moe.experts`` and not counted."""

from kbench.metrics.replays import region_share

ROUTING = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    return region_share(run, ROUTING)
