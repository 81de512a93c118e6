"""Device time of kernel B1 (``csrc/csb_mvm.cu``) per frame-step, ms,
from the profiled slice."""


def read(run):
    sl = run["window"].slice
    if sl is None or not sl.steps:
        return None
    us = sum(o.dur for o in sl.b1_kernels())
    return us / 1e3 / sl.steps if us else None
