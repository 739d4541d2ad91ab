"""ce_dice_roofline.uamt3d (%): kernel #1's byte bound a step (forward and
backward, each input read once and each output written once, at the cell's
logits) over its device time a step, from the traced window by these
kernel names."""
from benchmark import readers

KERNELS = ("ce_dice_fwd_kernel", "ce_dice_bwd_kernel")


def read(run):
    return readers.roofline(run, KERNELS)
