"""The roofline's FLOP and byte counts for one small matrix, counted by
hand, and the metric readers on a made-up profiled slice."""
import types

import pytest
import torch

from portbench import devtrace, roofline, spec


def _masks():
    """A 64 x 64 matrix of 32 x 32 blocks: block (0, 0) keeps rows 0, 3,
    9 and columns 1, 30; block (0, 1) keeps columns but no row; block
    (1, 0) rows but no column (neither stores anything); block (1, 1)
    keeps row 5 and column 7."""
    rm = torch.zeros(2, 2, 32, dtype=torch.bool)
    cm = torch.zeros(2, 2, 32, dtype=torch.bool)
    rm[0, 0, [0, 3, 9]] = True
    cm[0, 0, [1, 30]] = True
    cm[0, 1, :4] = True
    rm[1, 0, :2] = True
    rm[1, 1, 5] = True
    cm[1, 1, 7] = True
    return rm, cm


def test_matrix_counts_by_hand():
    live, idx = roofline.matrix_counts(*_masks())
    assert live == 3 * 2 + 1 * 1
    assert idx == (3 + 2) + (1 + 1)


def test_layer_work_by_hand():
    rm, cm = _masks()
    cell = types.SimpleNamespace(MVM_INPUT={"W": "x"},
                                 OUTPUT_GROUPS=(("W",),))
    w = {"W": {"dense": torch.zeros(64, 60), "row_mask": rm,
               "col_mask": cm}}
    work = roofline.layer_work(cell, w)
    assert work.flops_per_row == 2 * 7
    assert work.bytes_per_step == 4 * (7 + 7)
    assert work.bytes_per_row == 4 * (60 + 64)
    # 3 frame-steps carrying 10 true rows: bytes bound
    want_bytes = 3 * 56 + 10 * 496
    assert work.bytes(3, 10) == want_bytes
    assert work.least_s(3, 10) == pytest.approx(
        max(140 / roofline.PEAK_FLOPS, want_bytes / roofline.PEAK_BYTES))


def test_lstmp_counts_each_input_and_output_once():
    """An LSTMP layer reads x, h and m once a row and writes four gate
    sums and the projection."""
    cell = spec.module("reference", "lstmp")
    layer = {"n_input": 40, "n_hidden": 64, "proj": 32}
    w = {}
    for name, shape in cell.weight_shapes(layer).items():
        if len(shape) == 2:
            rm = torch.ones(-(-shape[0] // 32), -(-shape[1] // 32), 32,
                            dtype=torch.bool)
            w[name] = {"dense": torch.zeros(shape), "row_mask": rm,
                       "col_mask": rm.clone()}
    work = roofline.layer_work(cell, w)
    assert work.bytes_per_row == 4 * ((40 + 32 + 64) + (4 * 64 + 32))


def _slice(ops):
    return devtrace.Slice(window_us=1000.0, busy_us=600.0, ops=ops,
                         idle_by_host={"portbench/serve": 400.0},
                         steps=4, true_rows=40)


def test_readers_on_a_made_up_slice():
    ops = [devtrace.DeviceOp("void csb_mvm_kernel<float, float>", "kernel",
                            0, 100, True),
           devtrace.DeviceOp("elementwise_kernel", "kernel", 100, 60, True),
           devtrace.DeviceOp("gather", "kernel", 160, 40, False),
           devtrace.DeviceOp("Memcpy HtoD", "gpu_memcpy", 200, 8, True)]
    work = roofline.StepWork(flops_per_row=1000, bytes_per_row=100,
                             bytes_per_step=5000)
    w = types.SimpleNamespace(slice=_slice(ops), chunk_ms=[3.0, 1.0, 2.0],
                              true_frames=10**6, seconds=2.0)
    run = {"window": w, "model": types.SimpleNamespace(work=work),
           "device": {"platform": "gpu"}}
    read = {m: spec.module("metrics", m).read(run) for m in (
        "chunk_p50_ms", "kernels_per_step", "b1_ms_per_step",
        "nonmvm_ms_per_step", "b1_roofline_pct", "device_idle_pct",
        "mfu_pct")}
    assert read["chunk_p50_ms"] == 2.0
    assert read["kernels_per_step"] == 2 / 4
    assert read["b1_ms_per_step"] == pytest.approx(100 / 1e3 / 4)
    assert read["nonmvm_ms_per_step"] == pytest.approx(68 / 1e3 / 4)
    least = max(40 * 1000 / roofline.PEAK_FLOPS,
                (4 * 5000 + 40 * 100) / roofline.PEAK_BYTES)
    assert read["b1_roofline_pct"] == pytest.approx(100 * least / 100e-6)
    assert read["device_idle_pct"] == pytest.approx(40.0)
    assert read["mfu_pct"] == pytest.approx(
        100 * 1000 * 10**6 / (2.0 * roofline.PEAK_FLOPS))


def test_readers_return_nothing_without_a_slice():
    w = types.SimpleNamespace(slice=None, chunk_ms=[], true_frames=0,
                              seconds=0.0)
    run = {"window": w, "model": None, "device": {"platform": "cpu"}}
    for m in ("chunk_p50_ms", "kernels_per_step", "b1_ms_per_step",
              "nonmvm_ms_per_step", "b1_roofline_pct", "device_idle_pct",
              "mfu_pct"):
        assert spec.module("metrics", m).read(run) is None


def test_trace_reader_attributes_and_labels():
    """Launch correlation decides what the program launched; an operation
    with no launch in the trace counts by its start; idle gaps are named
    by the innermost host event over them."""
    ev = [
        {"ph": "X", "name": "ProfilerStep#1", "cat": "user_annotation",
         "ts": 0, "dur": 1000, "pid": 1, "tid": 1},
        {"ph": "X", "name": "portbench/serve", "cat": "user_annotation",
         "ts": 100, "dur": 700, "pid": 1, "tid": 1},
        {"ph": "X", "name": "aten::sigmoid", "cat": "cpu_op", "ts": 300,
         "dur": 200, "pid": 1, "tid": 1},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
         "ts": 50, "dur": 5, "pid": 1, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
         "ts": 150, "dur": 5, "pid": 1, "tid": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "name": "gather", "cat": "kernel", "ts": 120, "dur": 80,
         "pid": 0, "tid": 7, "args": {"correlation": 1}},
        {"ph": "X", "name": "csb_mvm_kernel", "cat": "kernel", "ts": 200,
         "dur": 100, "pid": 0, "tid": 7, "args": {"correlation": 2}},
        {"ph": "X", "name": "copy", "cat": "kernel", "ts": 600, "dur": 100,
         "pid": 0, "tid": 7, "args": {}},
        {"ph": "X", "name": "ProfilerStep#1", "cat": "gpu_user_annotation",
         "ts": 0, "dur": 5000, "pid": 0, "tid": 7},
    ]
    sl = devtrace.read(ev)
    assert sl.window_us == 1000
    assert sl.busy_us == 280
    assert [o.serve for o in sl.ops] == [False, True, True]
    # gaps [0, 120], [300, 600], [700, 1000], each named at its middle
    assert sl.idle_by_host == {"(no host event)": 420.0,
                               "aten::sigmoid": 300.0}
    top = sl.top_ops(2)
    assert top[0] == ["csb_mvm_kernel", 100 / 1e6]
