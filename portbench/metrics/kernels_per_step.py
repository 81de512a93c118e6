"""Device kernels the program's calls launched in the profiled slice,
over its frame-steps (one time step of the batch through every layer)."""


def read(run):
    sl = run["window"].slice
    if sl is None or not sl.steps:
        return None
    n = len(sl.serve_kernels())
    return n / sl.steps if n else None
