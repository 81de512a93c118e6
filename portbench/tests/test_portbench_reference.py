"""The plain reference against the port's ``rnn_serve_frames`` on the CPU
(B1's plain version), at a small width, for an LSTMP and a GRU stack,
across chunk boundaries and slot refills."""
import time

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.drivers import rnn_frames as d
from portbench.tests import _tiny
from portbench.generator import Traffic

CPU = torch.device("cpu")


@pytest.mark.parametrize("kind", ["lstmp", "gru"])
def test_program_chunks_equal_reference(kind):
    """Three chunks of the program and of the reference from the same
    frames, states zeroed on refill by the harness: outputs and states
    agree to fp32 rounding, and a refill happened inside the run."""
    cfg, mix = _tiny.config(kind), _tiny.MIX
    model = d.make_model(cfg, mix, 5, CPU)
    prog, ref = d.Program(cfg, model, CPU), d.Reference(model, "fp32")
    feeds = [d.Feeder(model, Traffic(mix, 5), CPU, 3) for _ in range(2)]
    refills = 0
    for c in range(3):
        outs = []
        for sut, feed in zip((prog, ref), feeds):
            ch, frames, st = feed.next()
            ys, feed.states[ch.group] = sut.chunk(frames, st)
            outs.append((ys, feed.states[ch.group]))
        refills += int(ch.reset.sum()) if c else 0
        for a, b in zip(outs[0][0], outs[1][0]):
            assert torch.allclose(a, b, atol=1e-5, rtol=0)
        for sa, sb in zip(outs[0][1], outs[1][1]):
            for k in sb:
                assert torch.allclose(sa[k], sb[k], atol=1e-5, rtol=0)
    assert refills > 0


@pytest.mark.parametrize("kind", ["lstmp", "gru"])
def test_run_is_correct_and_compares_every_true_frame(kind):
    cfg = _tiny.config(kind)
    r = d.run(cfg, _tiny.MIX, 2**31 + 11, 0.05, False, CPU,
              time.perf_counter())
    w = r["window"]
    c = r["checks"]
    assert c["out_gap"] <= 1e-5 and c["state_gap"] <= 1e-5
    n_layers = len(cfg["layers"])
    want = sum(int(v.sum()) for recs in w.checks.values()
               for _, v, _, _ in recs) * n_layers
    assert c["compared"] == want > 0
    # every compared slot crossed a refill
    resets = np.stack([rs for recs in w.checks.values()
                       for _, _, rs, _ in recs[1:]])
    assert resets.any(axis=0).all()
    assert r["e2e"]["frames_per_s"] > 0 and r["e2e"]["chunk_p95_ms"] > 0


@pytest.mark.parametrize("kind", ["lstmp", "gru"])
def test_tf32_control_fails_where_the_program_passes(kind):
    """The control (the reference in the program's place, its products in
    TF32) reads above the limits the program stays under."""
    cfg = _tiny.config(kind)
    prog = d.run(cfg, _tiny.MIX, 3, 0.05, False, CPU, time.perf_counter())
    ctl = d.run(cfg, _tiny.MIX, 3, 0.05, False, CPU, time.perf_counter(),
                system="tf32")
    lim = cfg["limits"]
    assert all(prog["checks"][k] <= lim[k] for k in lim)
    assert any(ctl["checks"][k] > lim[k] for k in lim)


@pytest.mark.parametrize("kind", ["lstmp", "gru"])
def test_fp64_witness_runs_and_reads_rounding(kind):
    """The witness (the reference in fp64 in the program's place, its
    outputs kept in fp64) reads the fp32 reference's own rounding."""
    cfg = _tiny.config(kind)
    wit = d.run(cfg, _tiny.MIX, 3, 0.05, False, CPU, time.perf_counter(),
                system="fp64")
    assert wit["checks"]["compared"] > 0
    assert all(wit["checks"][k] <= 1e-5 for k in cfg["limits"])


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12,
                      3.14159265])
    y = d.tf32(x)
    assert y.tolist()[:4] == [1.0, 1.0, 1.0 + 4 * 2**-11, -1.0]
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(y[4].item() - 3.14159265) < 2**-10 * 2


def test_every_seed_has_the_same_pattern():
    """The seed draws signs and biases, not the CSB pattern: the masks,
    and so every block's kernel size, are the same for every seed."""
    from portbench import inputs, spec
    cfg = _tiny.config("lstmp")
    cell = spec.module("reference", "lstmp")
    shapes = [cell.weight_shapes(layer) for layer in cfg["layers"]]
    a = inputs.make_weights(shapes, cfg, 1, CPU)
    b = inputs.make_weights(shapes, cfg, 2**31 + 2, CPU)
    for la, lb in zip(a, b):
        for name, ea in la.items():
            eb = lb[name]
            if "row_mask" in ea:
                assert torch.equal(ea["row_mask"], eb["row_mask"])
                assert torch.equal(ea["col_mask"], eb["col_mask"])
                assert torch.equal(ea["dense"].abs(), eb["dense"].abs())
            assert not torch.equal(ea["dense"], eb["dense"])


@pytest.mark.parametrize("compression", [13.0, 20.0])
def test_masks_keep_the_stated_share(compression):
    """The CSB projection keeps at most 1/compression of a matrix, and
    only just; the nominal rate 1 - 1/compression keeps far more, since
    its two passes keep rows and columns that go together."""
    g = torch.Generator().manual_seed(5)
    w = inputs.synthetic_weight(torch.randn(256, 160, generator=g),
                                torch.randn(256, 1, generator=g),
                                torch.randn(1, 160, generator=g))

    def live(masks):
        return int(inputs.element_mask(w.shape, *masks).sum())

    target = w.numel() / compression
    assert 0.98 * target <= live(inputs.csb_masks_at(w, 32, 32,
                                                     compression)) <= target
    assert live(inputs.csb_masks(w, 32, 32, 1 - 1 / compression)) > (
        1.25 * target)


def test_traced_run_profiles_a_slice_and_stays_correct():
    """A traced run profiles a slice of the window (on the CPU it holds no
    device operation) and excludes it from the window's numbers."""
    cfg = _tiny.config("gru")
    r = d.run(cfg, _tiny.MIX, 17, 0.02, True, CPU, time.perf_counter())
    w = r["window"]
    assert w.slice is not None
    assert w.slice.steps == d.PROFILE_ACTIVE * _tiny.MIX["chunk_frames"]
    assert 0 < w.slice.true_rows <= w.slice.steps * _tiny.MIX["slots"]
    assert w.slice.window_us > 0
    # the profiled chunks are checked but not counted in the window
    checked = sum(len(recs) for recs in w.checks.values())
    assert checked == w.chunks + 1 + d.PROFILE_ACTIVE
    assert r["checks"]["out_gap"] <= 1e-5


def test_record_grows_past_its_room():
    """The record keeps every chunk's compared rows when the window runs
    more chunks than it made room for."""
    rec = d.Record([4, 2], 3, 2, 2, CPU)
    sel = torch.tensor([0, 3])
    ys = [[torch.randn(3, 5, 4), torch.randn(3, 5, 2)] for _ in range(5)]
    kept = [rec.add(y, sel) for y in ys]
    assert len(rec.blocks) == 3
    for y, k in zip(ys, kept):
        for a, b in zip(y, k):
            assert torch.equal(a[:, sel], b)
