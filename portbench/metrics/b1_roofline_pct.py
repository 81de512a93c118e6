"""Kernel B1's share of its roofline, %: the least time of the profiled
slice's products on one card (``roofline.StepWork.least_s`` over the
slice's frame-steps and true rows) over B1's device time there."""


def read(run):
    sl = run["window"].slice
    if sl is None or not sl.steps:
        return None
    us = sum(o.dur for o in sl.b1_kernels())
    if not us:
        return None
    return 100.0 * run["model"].work.least_s(sl.steps, sl.true_rows) / (
        us / 1e6)
