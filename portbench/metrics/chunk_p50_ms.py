"""The median chunk, ms: the harness's clock over every untraced chunk
of the window, from the call into the first layer to the return of the
last (in an open loop, from the chunk's due time)."""
import numpy as np


def read(run):
    ms = run["window"].chunk_ms
    return float(np.percentile(ms, 50)) if ms else None
