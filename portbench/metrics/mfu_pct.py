"""The whole step's share of the card's fp32 peak, %: the products'
useful FLOPs (live weights x true stream-frames) served in the window's
untraced part, over its seconds x ``roofline.PEAK_FLOPS``."""
from portbench import roofline


def read(run):
    w = run["window"]
    if not w.true_frames or not w.seconds:
        return None
    if run["device"]["platform"] != "gpu":
        return None
    flops = run["model"].work.flops(w.true_frames)
    return 100.0 * flops / (w.seconds * roofline.PEAK_FLOPS)
