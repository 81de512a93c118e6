"""Progressive lossless-pruning-rate controller (paper Algorithm 1) — a
copy of ``repro.core.progressive``, which has no JAX code.

The outer loop of Algorithm 1: starting from ``init_pr`` (a surely-lossless
compression), the prune rate grows by ``step``; once accuracy drops below
the lossless target the step is halved and the rate backs off — a
binary-search refinement that terminates when
``step <= init_step / 4`` and the last evaluation was lossless.

The controller is deliberately pure-Python state (it is *driven by* train /
eval callbacks), so it composes with any training loop and is trivially
checkpointable.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ProgressiveState:
    prune_rate: float
    step: float
    flag: bool = False          # 'over-pruned seen' flag from Algorithm 1
    done: bool = False
    best_lossless_rate: float = 0.0
    iterations: int = 0


class ProgressivePruner:
    """Drives Algorithm 1's outer loop.

    >>> ctl = ProgressivePruner(init_pr=0.25, init_step=0.25)
    >>> while not ctl.done:
    ...     rate = ctl.prune_rate        # train+ADMM-prune at this rate
    ...     ok = evaluate() >= lossless  # Eval(Z) >= accu
    ...     ctl.update(ok)
    """

    def __init__(self, init_pr: float = 0.25, init_step: float = 0.25,
                 max_rate: float = 0.995):
        if not 0.0 < init_pr < 1.0:
            raise ValueError(f"init_pr must be in (0,1): {init_pr}")
        self.init_step = float(init_step)
        self.max_rate = float(max_rate)
        self.state = ProgressiveState(prune_rate=float(init_pr),
                                      step=float(init_step))

    # -- protocol -----------------------------------------------------------
    @property
    def prune_rate(self) -> float:
        return self.state.prune_rate

    @property
    def done(self) -> bool:
        return self.state.done

    @property
    def best_lossless_rate(self) -> float:
        return self.state.best_lossless_rate

    @property
    def best_compression(self) -> float:
        return 1.0 / max(1.0 - self.state.best_lossless_rate, 1e-12)

    def update(self, lossless: bool) -> None:
        """Feed the result of Eval(Z) >= accu for the current rate."""
        s = self.state
        if s.done:
            return
        s.iterations += 1
        if lossless:
            s.best_lossless_rate = max(s.best_lossless_rate, s.prune_rate)
            # Termination test (paper: step <= init_step/4 and Eval ok).
            if s.step <= self.init_step / 4 + 1e-12:
                s.done = True
                return
            if s.flag:
                s.step = s.step / 2
            s.prune_rate = min(s.prune_rate + s.step, self.max_rate)
        else:
            s.flag = True
            s.step = s.step / 2
            s.prune_rate = max(s.prune_rate - s.step, 0.0)
            if s.step <= self.init_step / 16:
                # Degenerate guard: cannot refine further; settle at the
                # best lossless rate seen.
                s.prune_rate = s.best_lossless_rate
                s.done = s.best_lossless_rate > 0.0

    def __repr__(self) -> str:  # pragma: no cover
        s = self.state
        return (f"ProgressivePruner(rate={s.prune_rate:.4f}, step={s.step:.4f},"
                f" best={s.best_lossless_rate:.4f}, done={s.done})")
