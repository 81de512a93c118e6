"""The rest of a run, on the CPU, with the timed path broken underneath
(in the port's ``rnn_serve_frames`` and ``cell_apply``): ``correct``
comes out false for each fault a frame-serving cell can have. Whole runs
of the sound program come out true."""
import importlib.util
import time
from pathlib import Path

import pytest
import torch

from portbench import spec
from portbench.tests import _tiny

CPU = torch.device("cpu")


def _correct(cfg, seed=13) -> bool:
    driver = spec.module("drivers", cfg["driver"])
    r = driver.run(cfg, _tiny.MIX, seed, 0.02, False, CPU,
                   time.perf_counter())
    s = importlib.util.spec_from_file_location(
        "portbench_run_faults", Path(spec.HERE) / "run.py")
    run = importlib.util.module_from_spec(s)
    s.loader.exec_module(run)
    return run.result_line(spec.benchmark(), "sr1.offline", cfg, r, False,
                           "cpu")["correct"]


def _state_unchanged(apply):
    def f(graph, params, x, state):
        y, _ = apply(graph, params, x, state)
        return y, state
    return f


def _half_batch(apply):
    def f(graph, params, x, state):
        h = x.shape[0] // 2
        y, st = apply(graph, params, x[:h], {k: v[:h] for k, v in
                                             state.items()})
        pad = lambda t: torch.cat([t, torch.zeros_like(t)])[: x.shape[0]]
        return pad(y), {k: pad(v) for k, v in st.items()}
    return f


def _answer_altered(serve):
    def f(*args, **kw):
        ys, st, us = serve(*args, **kw)
        ys = ys.clone()
        ys[0] += 1e-3
        return ys, st, us
    return f


@pytest.mark.parametrize("kind", ["lstmp", "gru"])
def test_sound_program_is_correct(kind):
    assert _correct(_tiny.config(kind)) is True


@pytest.mark.parametrize("fault,target", [
    ("state_unchanged", "cell_apply"), ("half_batch", "cell_apply"),
    ("answer_altered", "rnn_serve_frames")])
@pytest.mark.parametrize("kind", ["lstmp", "gru"])
def test_broken_path_is_not_correct(monkeypatch, kind, fault, target):
    from repro_torch.serve import engine
    wrap = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
            "answer_altered": _answer_altered}[fault]
    monkeypatch.setattr(engine, target, wrap(getattr(engine, target)))
    cfg = _tiny.config(kind)
    # 8 of the 12 slots are compared, so the left-out half holds some
    assert _correct(cfg) is False
