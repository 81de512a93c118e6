"""Device time per frame-step, ms, of every operation the program's calls
launched that is not kernel B1: the cell's elementwise, pad and copy
work, from the profiled slice."""
from portbench import devtrace


def read(run):
    sl = run["window"].slice
    if sl is None or not sl.steps:
        return None
    us = sum(o.dur for o in sl.ops
             if o.serve and devtrace.B1_KERNEL not in o.name)
    return us / 1e3 / sl.steps if us else None
