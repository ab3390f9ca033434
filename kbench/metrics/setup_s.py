"""Process start to the window's start: CUDA's start, the weights, the
program's PTQ, the engine and its graph capture (kernel builds on a
checkout's first run), the traffic's ramp."""


def read(run):
    return run.setup_s
