"""Model step: the outlier compensation's share of the packed step's device
time. A fenced step's record carries ``region_marks``, the regions of the
model code in the order of the marker kernels the program records at their
boundaries in the captured step; each traced step's replay splits at its
markers into regions (``replays.step_regions``), or is left out where the
markers are not all there. The share is ``qlinear.residual`` +
``qlinear.comp_dequant`` + ``qlinear.comp_matmul`` over all region time of
the traced steps. None when the steps carry no marks or no replay holds
them."""

from kbench.metrics.replays import region_share

COMPENSATION = ("qlinear.residual", "qlinear.comp_dequant", "qlinear.comp_matmul")


def read(run):
    return region_share(run, COMPENSATION)
