"""The port's copies of obs/ and serve/config.py behave as the JAX
package's do, and convert.py carries weights across bit for bit."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import padded_csb_from_dense
from repro.obs import summary as j_summary
from repro.serve import EngineConfig as JEngineConfig
from repro_torch.convert import cell_params_from_numpy
from repro_torch.core import PaddedCSB
from repro_torch.obs import metrics, summary, trace
from repro_torch.serve import EngineConfig, resolve_config


@pytest.mark.parametrize("kw,match", [
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(temperature=-0.5), "temperature"),
    (dict(cache_len=0), "cache_len"),
    (dict(n_slots=0), "n_slots"),
    (dict(page_size=0), "page_size"),
    (dict(frame_warmup=-1), "frame_warmup"),
    (dict(use_kernel=True), "use_kernel=True requires paged=True"),
    (dict(prefix_cache=True), "prefix_cache=True requires paged=True"),
    (dict(pool_pages=8), "pool_pages requires paged=True"),
    (dict(paged=True, pool_pages=0), "pool_pages"),
    (dict(spec_k=0), "spec_k"),
    (dict(draft_prune_rate=1.0), "draft_prune_rate"),
    (dict(speculative=True, paged=True, prefix_cache=True), "speculative"),
])
def test_engine_config_rejects_as_jax_does(kw, match):
    with pytest.raises(ValueError, match=match):
        EngineConfig(**kw)
    with pytest.raises(ValueError, match=match):
        JEngineConfig(**kw)


def test_engine_config_fields_and_resolve():
    assert [f.name for f in dataclasses.fields(EngineConfig)] == \
        [f.name for f in dataclasses.fields(JEngineConfig)]
    assert dataclasses.asdict(EngineConfig()) == \
        dataclasses.asdict(JEngineConfig())
    cfg = EngineConfig().replace(frame_warmup=0)
    assert cfg.frame_warmup == 0 and resolve_config(cfg, caller="f") is cfg
    assert resolve_config(None, caller="f") == EngineConfig()
    with pytest.raises(TypeError, match="f\\(\\) expects"):
        resolve_config({"frame_warmup": 1}, caller="f")


def test_tracer_chrome_format_and_ring():
    tr = trace.Tracer(capacity=4)
    with tr.span("a", track="t"):
        pass
    tr.begin("b")
    tr.end(args={"k": 1})
    for i in range(4):
        tr.instant("i", args={"n": i})
    assert tr.dropped == 2
    ev = tr.to_chrome()["traceEvents"]
    body = [e for e in ev if e["ph"] != "M"]
    assert [e["args"]["n"] for e in body] == [0, 1, 2, 3]
    for e in ev:
        assert {"ph", "ts", "pid", "tid", "name"} <= set(e)
    json.dumps(tr.to_chrome())


def test_trace_file_reads_with_the_jax_summary(tmp_path):
    trace.enable()
    try:
        trace.get().complete("serve/frame", 0, 2000, track="frames")
        trace.get().complete("serve/frame", 0, 4000, track="frames")
        path = trace.export_chrome(str(tmp_path / "t.json"))
    finally:
        trace.disable()
    rows = j_summary.summarize(j_summary.load_trace(path))
    assert rows == summary.summarize(summary.load_trace(path))
    assert rows[0]["count"] == 2 and rows[0]["p50_us"] == 2.0


def test_disabled_is_a_no_op():
    assert trace.get() is None and metrics.get() is None
    assert trace.span("x") is trace.span("y")
    assert trace.export_chrome("never-written.json") is None


def test_histogram_percentiles_and_kinds():
    reg = metrics.MetricsRegistry()
    h = reg.histogram("serve/frames/wall_us")
    assert h.percentile(50) is None
    h.observe(1)
    h.observe(2)
    assert h.percentile(50) == 1.0 and h.summary()["p99"] == 2.0
    reg.counter("c").inc()
    reg.gauge("g").set(3)
    assert reg.to_dict()["gauges"]["g"]["series"] == [3.0]
    with pytest.raises(ValueError, match="another kind"):
        reg.gauge("c")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_convert_round_trip(dtype):
    rng = np.random.default_rng(0)
    z = rng.normal(size=(24, 16)).astype(np.float32) * (
        rng.random((24, 16)) < 0.4)
    pj = padded_csb_from_dense(z, 8, 8, dtype=dtype)
    dense = jnp.asarray(rng.normal(size=(24, 16)), dtype)
    host = {
        "W": {**{k: np.asarray(getattr(pj, k))
                 for k in ("vals", "row_idx", "col_idx", "m", "n")},
              "shape": pj.shape, "grid": pj.grid, "block": pj.block},
        "U": np.array(dense),
    }
    out = cell_params_from_numpy(host, device="cpu")
    assert isinstance(out["W"], PaddedCSB)
    for k in ("vals", "row_idx", "col_idx", "m", "n"):
        t = getattr(out["W"], k)
        back = t.view(torch.int16).numpy().view(host["W"][k].dtype) \
            if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(back.view(np.uint8),
                                      host["W"][k].view(np.uint8))
    assert (out["W"].shape, out["W"].grid, out["W"].block) == \
        (pj.shape, pj.grid, pj.block)
    u = out["U"]
    assert u.dtype == {jnp.float32: torch.float32,
                       jnp.bfloat16: torch.bfloat16}[dtype]
    np.testing.assert_array_equal(u.float().numpy(),
                                  np.asarray(dense, np.float32))
    host["U"][...] = 0   # the port owns a copy
    assert u.float().abs().sum() > 0
