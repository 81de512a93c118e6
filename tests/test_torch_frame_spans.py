"""``tools/frame_spans.py``: its numbers on a made-up profiled trace
whose every value is known by hand, and a CPU run of the benchmark's
tiny GRU whose profiled chunks hold the program's spans."""
import importlib.util
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "frame_spans", ROOT / "tools" / "frame_spans.py")
fs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fs)


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_read_spans_by_hand():
    """Device busy [0, 200], [300, 500] (two overlapping kernels) and
    [700, 900]: the call [100, 650] is busy 100 + 200 us of its 550, so
    idle 250, and the call [800, 1000] idle 100; two steps of 110 and
    100 us."""
    ev = [
        _x("portbench/serve", "user_annotation", 50, 1000),
        _x("serve/frames/call", "user_annotation", 100, 550),
        _x("serve/frames/step", "user_annotation", 150, 110),
        _x("serve/frames/step", "user_annotation", 300, 100),
        _x("serve/frames/call", "user_annotation", 800, 200),
        _x("aten::add", "cpu_op", 310, 50),
        _x("csb_mvm_kernel", "kernel", 0, 200, tid=7),
        _x("add", "kernel", 300, 150, tid=7),
        _x("mul", "kernel", 350, 150, tid=7),
        _x("Memcpy DtoD", "gpu_memcpy", 700, 200, tid=7),
    ]
    got = fs.read_spans(ev, chunks=2, steps=2)
    assert got["call_idle_ms_per_chunk"] == 0.175
    assert got["call_ms_per_chunk"] == 0.375
    assert got["host_ms_per_step"] == 0.105
    assert got["spans"] == {"serve/frames/call": 2, "serve/frames/step": 2}


def test_traced_cpu_run_holds_the_program_spans():
    from portbench.tests import _tiny
    from repro_torch import obs
    cfg = _tiny.config("gru")
    out = fs.measure(cfg, _tiny.MIX, 2**31 + 5, 0.02, torch.device("cpu"))
    assert [r["obs"] for r in out["untraced"]] == list(fs.ORDER)
    for r in out["untraced"]:
        assert ("host_ms_per_step" in r) == r["obs"]
        assert r.get("host_ms_per_step", 1.0) > 0
    assert all(r["correct"] and r["frames_per_s"] > 0
               for r in out["untraced"] + out["traced"])
    assert [r["obs"] for r in out["traced"]] == [False, True]
    got = out["profiled"]
    layers, k = len(cfg["layers"]), _tiny.MIX["chunk_frames"]
    assert got["spans"] == {"serve/frames/call": layers * fs.CHUNKS,
                            "serve/frames/prologue": layers * fs.CHUNKS,
                            "serve/frames/sync": 2 * layers * fs.CHUNKS,
                            "serve/frames/step": layers * fs.CHUNKS * k,
                            "serve/frames/gather": layers * fs.CHUNKS}
    # no device: every moment of a call is idle
    assert got["call_idle_ms_per_chunk"] == got["call_ms_per_chunk"] > 0
    assert 0 < got["host_ms_per_step"] * k < got["call_ms_per_chunk"]
    assert obs.trace.get() is None
