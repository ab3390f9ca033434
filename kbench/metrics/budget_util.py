"""Scheduler: the share of the packed step's replayed cells that carry a
token (the step ring's ``cells / budget``), over every step of the window."""


def read(run):
    budget = sum(s["budget"] for s in run.steps)
    return 100.0 * sum(s["cells"] for s in run.steps) / budget if budget else None
