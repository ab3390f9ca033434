"""Scheduler: the host's time per packed step (the step ring's ``host_s``:
packing, the copy of the inputs, sampling and bookkeeping), summed over
the window's steps and divided by their count. The traced run fences every
step, so ``host_s`` leaves out the wait for the device."""


def read(run):
    return 1e3 * sum(s["host_s"] for s in run.steps) / len(run.steps) if run.steps else None
