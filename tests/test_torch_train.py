"""The port's training loop, checkpoints, data pipeline and one-card
launcher (``repro_torch.train``, ``repro_torch.data.pipeline``,
``repro_torch.launch.train``) on the CPU: the counterparts of
tests/test_train.py, and the loop against the JAX package's ``train``.

The trajectories run tests/test_train.py's tiny ``CFG`` (fp32) from
JAX's ``PRNGKey(0)`` params carried across by ``lm_params_from_numpy``,
on the same numpy batches, for 15 steps. Bounds, per optimizer: SGD's
and Adafactor's losses within 1e-5 and params within 1e-5 (fp32
summation order in the gradients: observed 1e-6 and 2e-7). AdamW's
losses within 1e-5 (observed 1e-6), its params within 5e-4: its first
steps move each element by about lr * sign(g) = 3e-3, so an element
whose gradient is near zero can step another way on a round-off
(observed 7e-5). With int8 compression an element on a grid midpoint can
round to the next code: losses within 5e-4 (observed 5e-5)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import train_microbatches as j_train_microbatches
from repro.models import ModelConfig as JModelConfig
from repro.models import forward_loss as j_forward_loss
from repro.models import init_params as j_init
from repro.train import TrainConfig as JTrainConfig
from repro.train import checkpoint as j_ckpt
from repro.train import train as j_train
from repro_torch import _tree
from repro_torch.configs import train_microbatches
from repro_torch.convert import lm_params_from_numpy, params_to_numpy
from repro_torch.core import CSBSpec, density
from repro_torch.data import CharLMTask, Prefetcher, sharded_batches
from repro_torch.launch import train as launch
from repro_torch.models import ModelConfig, forward_loss
from repro_torch.obs import disable_all, enable_all
from repro_torch.optim import get_optimizer
from repro_torch.train import StepTimer, TrainConfig, train
from repro_torch.train import checkpoint as ckpt

KW = dict(name="tiny", mixer="attn", ffn="swiglu", n_layers=2, d_model=32,
          n_heads=2, n_kv=2, head_dim=16, d_ff=64, vocab=32,
          dtype="float32", logit_chunk=16, remat=False)
CFG, JCFG = ModelConfig(**KW), JModelConfig(**KW)
QUIET = dict(log=lambda *_: None)
# (optimizer, microbatches, compress) -> (loss bound, param bound)
BOUNDS = {("sgd", 1, False): (1e-5, 1e-5),
          ("adamw", 1, False): (1e-5, 5e-4),
          ("adamw", 2, False): (1e-5, 5e-4),
          ("adafactor", 1, False): (1e-5, 1e-5),
          ("adamw", 1, True): (5e-4, None)}



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Models of a few thousand parameters: one intra-op thread. Under
    the suite's parallel workers more threads a process only contend
    (the file took 8x longer with torch's default of one a core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _batches(task, steps, batch=8, seq=32, start=0):
    for step in range(start, steps):
        yield step, task.batch(step, batch, seq)


def _jax_batches(task, steps, **kw):
    for step, b in _batches(task, steps, **kw):
        yield step, {k: jnp.asarray(v) for k, v in b.items()}


def _params(key=0):
    jp = j_init(jax.random.PRNGKey(key), JCFG)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _loss(p, b):
    return forward_loss(p, b, CFG)


def _j_loss(p, b):
    return j_forward_loss(p, b, JCFG)


def _leaves_np(tree):
    return jax.tree.leaves(params_to_numpy(tree))


@pytest.mark.parametrize("opt,mb,comp", list(BOUNDS),
                         ids=[f"{o}-mb{m}{'-int8' if c else ''}"
                              for o, m, c in BOUNDS])
def test_trajectory_matches_jax(opt, mb, comp):
    loss_tol, param_tol = BOUNDS[(opt, mb, comp)]
    kw = dict(lr=3e-3, steps=15, log_every=1000, optimizer=opt,
              microbatches=mb, compress_grads=comp)
    task = CharLMTask(vocab=32, seed=0)
    jp, tp = _params()
    jp, jh = j_train(_j_loss, jp, _jax_batches(task, 15), JTrainConfig(**kw),
                     **QUIET)
    tp, th = train(_loss, tp, _batches(task, 15), TrainConfig(**kw), **QUIET)
    assert [h["step"] for h in th] == list(range(15))
    for a, b in zip(jh, th):
        assert abs(a["loss"] - b["loss"]) <= loss_tol, (a, b)
    if param_tol is not None:
        for a, b in zip(jax.tree.leaves(jp), _leaves_np(tp)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0,
                                       atol=param_tol)


def test_microbatch_grads_accumulate_in_fp32(monkeypatch):
    """One microbatch: gradients in the params' dtype (bf16 here); two:
    accumulated into fp32 zeros, then divided, as JAX does."""
    import repro_torch.train.loop as loop
    seen = []
    real = loop.get_optimizer

    def spying(name):
        opt = real(name)

        def update(grads, *args, **kw):
            seen.append({g.dtype for ps in _tree.leaves(grads) for g in ps})
            return opt.update(grads, *args, **kw)

        return opt._replace(update=update)

    monkeypatch.setattr(loop, "get_optimizer", spying)
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    jp = j_init(jax.random.PRNGKey(0),
                dataclasses.replace(JCFG, dtype="bfloat16"))
    batch = CharLMTask(vocab=32, seed=0).batch(0, 8, 32)
    for mb in (1, 2):
        params = lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
        step_fn, opt = loop.make_train_step(
            lambda p, b: forward_loss(p, b, cfg),
            TrainConfig(microbatches=mb, clip_norm=0.0, optimizer="sgd"))
        step_fn(params, opt.init(params), None, None, batch,
                torch.tensor(0))
    assert seen == [{torch.bfloat16}, {torch.float32}]


def test_loss_goes_down():
    task = CharLMTask(vocab=32, seed=0)
    _, params = _params()
    tcfg = TrainConfig(lr=3e-3, steps=30, log_every=1000, clip_norm=1.0)
    params, hist = train(_loss, params, _batches(task, 30), tcfg, **QUIET)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.1, (first, last)


def test_compressed_grads_loss_parity():
    """tests/test_train.py's bound: after 50 steps the compressed run's
    loss sits within 1e-2 of the uncompressed run's, and it learns."""
    task = CharLMTask(vocab=32, seed=2)
    base = TrainConfig(lr=3e-3, steps=50, log_every=1000, clip_norm=1.0)
    runs = {}
    for compress in (False, True):
        _, params = _params()
        tcfg = dataclasses.replace(base, compress_grads=compress)
        _, runs[compress] = train(_loss, params, _batches(task, 50), tcfg,
                                  **QUIET)
    plain, comp = runs[False][-1]["loss"], runs[True][-1]["loss"]
    assert abs(plain - comp) <= 1e-2, (plain, comp)
    first = np.mean([h["loss"] for h in runs[True][:5]])
    assert comp < first - 0.1, (first, comp)


def _admm_specs(params):
    spec = CSBSpec(bm=8, bn=8, prune_rate=0.5)
    specs = {k: None for k in params if k != "layers"}
    specs["layers"] = [
        {"norm1": None, "norm2": None,
         "mixer": {k: (spec if k in ("wq", "wo") else None)
                   for k in lp["mixer"]},
         "ffn": {k: None for k in lp["ffn"]}}
        for lp in params["layers"]]
    return specs


def test_train_with_admm_prunes():
    """tests/test_train.py's ADMM run: the penalty in the loss, the
    projection every 5 steps, finalized at the end; density <= 0.56 (the
    keep fraction with cross-point rounding) on every layer's wq, and the
    losses within 1e-4 of JAX's same run (the projection picks the same
    rows and columns)."""
    task = CharLMTask(vocab=32, seed=1)
    jp, params = _params(1)
    tcfg = dict(lr=3e-3, steps=20, admm_every=5, admm_rho=0.05,
                log_every=1000)
    params, hist = train(_loss, params, _batches(task, 20),
                         TrainConfig(**tcfg), csb_specs=_admm_specs(params),
                         **QUIET)
    for lp in params["layers"]:
        assert float(density(lp["mixer"]["wq"])) <= 0.56
    from repro.core import CSBSpec as JSpec
    specs = jax.tree.map(lambda _: None, jp)
    specs["layers"]["mixer"]["wq"] = JSpec(bm=8, bn=8, prune_rate=0.5)
    specs["layers"]["mixer"]["wo"] = JSpec(bm=8, bn=8, prune_rate=0.5)
    jp, jh = j_train(_j_loss, jp, _jax_batches(task, 20),
                     JTrainConfig(**tcfg), csb_specs=specs, **QUIET)
    for a, b in zip(jh, hist):
        assert abs(a["loss"] - b["loss"]) <= 1e-4, (a, b)
    np.testing.assert_array_equal(
        params_to_numpy(params)["layers"]["mixer"]["wq"] != 0,
        np.asarray(jp["layers"]["mixer"]["wq"]) != 0)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16)}}
    path = ckpt.save(str(tmp_path), 7, tree, extra={"note": "x"})
    assert os.path.isdir(path)
    restored, extra = ckpt.restore(str(tmp_path), 7, tree)
    assert extra == {"note": "x"}
    assert restored["b"]["c"].dtype == torch.bfloat16
    for a, b in zip(_tree.leaves(tree), _tree.leaves(restored)):
        torch.testing.assert_close(a[0].float(), b[0].float(), rtol=0,
                                   atol=0)


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"a": torch.ones(4, 4)}
    ckpt.save(str(tmp_path), 1, tree)
    f = os.path.join(str(tmp_path), "step_00000001", "arrays.npz")
    data = bytearray(open(f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(f, "wb").write(bytes(data))
    with pytest.raises(Exception):
        ckpt.restore(str(tmp_path), 1, tree)


def test_checkpoint_refuses_another_tree(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="incompatible"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.ones(2),
                                        "b": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.ones(3)})


def test_checkpoint_latest_and_gc(tmp_path):
    tree = {"a": torch.ones(3)}
    for s in (5, 10, 15, 20):
        ckpt.save(str(tmp_path), s, tree)
    assert ckpt.latest_step(str(tmp_path)) == 20
    ckpt.keep_last(str(tmp_path), 2)
    assert ckpt.latest_step(str(tmp_path)) == 20
    assert len(os.listdir(tmp_path)) == 2


def test_auto_resume_identical(tmp_path):
    """Kill after N steps, resume: the final params equal an uninterrupted
    run's (deterministic data + checkpoint restore; the CPU is
    deterministic, so bit-equal)."""
    task = CharLMTask(vocab=32, seed=2)

    def run(steps, ckdir=None):
        _, params = _params(2)
        tcfg = TrainConfig(lr=1e-3, steps=steps, log_every=10**9,
                           ckpt_dir=ckdir, ckpt_every=5, clip_norm=0.0)
        return train(_loss, params, _batches(task, steps), tcfg, **QUIET)

    ref, _ = run(10)
    ck = str(tmp_path / "ck")
    run(5, ckdir=ck)                       # writes step 5, then "crashes"
    resumed, hist = run(10, ckdir=ck)
    assert [h["step"] for h in hist] == list(range(5, 10))
    for a, b in zip(_leaves_np(ref), _leaves_np(resumed)):
        np.testing.assert_array_equal(a, b)


def test_resume_without_the_ef_residual(tmp_path):
    """Checkpoints from before ``compress_grads`` was switched on restore
    params and optimizer state; the compression carry starts at zero."""
    task = CharLMTask(vocab=32, seed=2)
    ck = str(tmp_path / "ck")
    _, params = _params(2)
    train(_loss, params, _batches(task, 4),
          TrainConfig(steps=4, ckpt_dir=ck, ckpt_every=2, log_every=10**9),
          **QUIET)
    logs = []
    _, params = _params(2)
    _, hist = train(_loss, params, _batches(task, 6),
                    TrainConfig(steps=6, ckpt_dir=ck, ckpt_every=2,
                                compress_grads=True, log_every=10**9),
                    log=logs.append)
    assert any("no EF residual" in m for m in logs)
    assert [h["step"] for h in hist] == [4, 5]
    tree = {"opt": get_optimizer("adamw").init(params), "params": params,
            "residual": params}
    restored, _ = ckpt.restore(ck, 6, tree)
    assert all(float(r.abs().max()) > 0 for ps in
               _tree.leaves(restored["residual"]) for r in ps)


def _cross_tree(params, opt_state):
    return {"params": params, "opt": opt_state}


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's train writes step 4 (AdamW, its stacked layout); the port's
    train resumes from it to step 8 and matches JAX's uninterrupted run
    at the trajectory bounds."""
    task = CharLMTask(vocab=32, seed=3)
    ck = str(tmp_path / "ck")
    kw = dict(lr=3e-3, steps=4, ckpt_dir=ck, ckpt_every=4, log_every=10**9)
    jp, _ = _params(3)
    j_train(_j_loss, jp, _jax_batches(task, 4), JTrainConfig(**kw), **QUIET)
    jref, jh = j_train(_j_loss, _params(3)[0], _jax_batches(task, 8),
                       JTrainConfig(**dict(kw, steps=8, ckpt_dir=None)),
                       **QUIET)
    _, tp = _params(3)
    tp, th = train(_loss, tp, _batches(task, 8),
                   TrainConfig(**dict(kw, steps=8)), **QUIET)
    assert [h["step"] for h in th] == [4, 5, 6, 7]
    for a, b in zip(jh[4:], th):
        assert abs(a["loss"] - b["loss"]) <= 1e-5, (a, b)
    for a, b in zip(jax.tree.leaves(jref), _leaves_np(tp)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=5e-4)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's train writes step 4; ``repro.train.checkpoint.restore``
    reads it into JAX's tree with arrays equal to the port's (stacked),
    and JAX's train resumes from it."""
    task = CharLMTask(vocab=32, seed=3)
    ck = str(tmp_path / "ck")
    kw = dict(lr=3e-3, steps=4, ckpt_dir=ck, ckpt_every=4, log_every=10**9)
    _, tp = _params(3)
    tp, _ = train(_loss, tp, _batches(task, 4), TrainConfig(**kw), **QUIET)
    from repro.optim import adamw as j_adamw
    jp0 = _params(3)[0]
    like = _cross_tree(jp0, j_adamw().init(jp0))
    tree, _ = j_ckpt.restore(ck, 4, like)
    for a, b in zip(jax.tree.leaves(tree["params"]), _leaves_np(tp)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(tree["opt"].step) == 4
    _, jh = j_train(_j_loss, _params(3)[0], _jax_batches(task, 6),
                    JTrainConfig(**dict(kw, steps=6)), **QUIET)
    assert [h["step"] for h in jh] == [4, 5]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_files_cross_both_ways(tmp_path, dtype):
    """A tree with stacked layers, an OptState and a bf16 leaf: JAX's save
    restores in the port and the port's save in JAX, arrays equal; the
    manifests agree on leaf count, shapes, dtypes and hashes."""
    rng = np.random.default_rng(4)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    layers = {"norm1": rng.standard_normal((3, 4)).astype(np.float32),
              "w": rng.standard_normal((3, 4, 5)).astype(np.float32)}
    emb = rng.standard_normal((6, 4)).astype(np.float32)
    from repro.optim import sgd as j_sgd
    jparams = {"embed": jnp.asarray(emb, jd),
               "layers": jax.tree.map(lambda a: jnp.asarray(a, jd), layers)}
    jtree = {"params": jparams, "opt": j_sgd().init(jparams)}
    tparams = {"embed": torch.from_numpy(emb).to(td),
               "layers": [{k: torch.from_numpy(v[i].copy()).to(td)
                           for k, v in layers.items()} for i in range(3)]}
    ttree = {"params": tparams, "opt": get_optimizer("sgd").init(tparams)}
    j_ckpt.save(str(tmp_path / "j"), 3, jtree)
    ckpt.save(str(tmp_path / "t"), 3, ttree)
    mans = [json.load(open(tmp_path / d / "step_00000003" / "manifest.json"))
            for d in ("j", "t")]
    for key in ("n_leaves", "shapes", "dtypes", "hashes"):
        assert mans[0][key] == mans[1][key], key
    got, _ = ckpt.restore(str(tmp_path / "j"), 3, ttree)
    assert got["params"]["layers"][2]["w"].dtype == td
    for a, b in zip(jax.tree.leaves(jtree), _tree.stacked(got)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    back, _ = j_ckpt.restore(str(tmp_path / "t"), 3, jtree)
    for a, b in zip(jax.tree.leaves(back), _tree.stacked(ttree)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


def test_prefetcher_order_and_error():
    it = Prefetcher(iter(range(5)), depth=2)
    assert list(it) == [0, 1, 2, 3, 4]

    def bad():
        yield 1
        raise ValueError("boom")

    it = Prefetcher(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError):
        next(it)
        next(it)


def test_sharded_batches_put_each_batch_on_the_device():
    task = CharLMTask(vocab=16, seed=0)
    from repro_torch.data import lm_batch_iterator
    it = sharded_batches(lm_batch_iterator(task, 2, 8), device="cpu")
    step, b = next(it)
    assert step == 0 and isinstance(b["tokens"], torch.Tensor)
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  task.batch(0, 2, 8)["tokens"])
    # on a (2, 2) mesh, as rank 2 (data coordinate 1) of a fake group:
    # each array is a DTensor on its spec's placements, holding this
    # rank's rows and nothing communicated
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.dist import P
    dist.init_process_group("fake", store=FakeStore(), rank=2, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        it = sharded_batches(lm_batch_iterator(task, 4, 8), mesh,
                             {"tokens": P("data", None)}, device="cpu")
        _, b = next(it)
        want = task.batch(0, 4, 8)
        assert isinstance(b["tokens"], DTensor)
        assert b["tokens"].placements == (Shard(0), Replicate())
        assert b["labels"].placements == (Replicate(), Replicate())
        assert tuple(b["tokens"].shape) == want["tokens"].shape
        np.testing.assert_array_equal(b["tokens"].to_local().numpy(),
                                      want["tokens"][2:])
        np.testing.assert_array_equal(b["labels"].to_local().numpy(),
                                      want["labels"])
    finally:
        dist.destroy_process_group()


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")


def test_entry_points_raise_without_cuda_unless_asked(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded_batches(iter([]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "gemma-2b", "--reduced", "--steps", "1"])


def test_train_microbatches_match_jax():
    for arch in ARCH_IDS:
        assert train_microbatches(arch) == j_train_microbatches(arch)


def test_step_timer_and_telemetry():
    """The ``train/step`` span and the ``train/step/wall_us`` and
    ``train/step/loss`` metrics, one a step; the timer's quantiles."""
    tracer, reg = enable_all()
    try:
        task = CharLMTask(vocab=32, seed=0)
        _, params = _params()
        _, hist = train(_loss, params, _batches(task, 3),
                        TrainConfig(steps=3, log_every=1), **QUIET)
        spans = [e for e in tracer.to_chrome()["traceEvents"]
                 if e.get("name") == "train/step"]
        assert len(spans) == 3
        assert reg.histogram("train/step/wall_us").count == 3
        assert reg.gauge("train/step/loss").last == hist[-1]["loss"]
    finally:
        disable_all()
    t = StepTimer(window=3)
    for dt in (1.0, 1.0, 1.0, 10.0):
        t.record(dt)
    assert len(t.times) == 3 and t.is_straggling(100.0)


@pytest.mark.parametrize("arch", ["gemma-2b", "musicgen-medium",
                                  "internvl2-2b"])
def test_launcher_trains_a_reduced_config(arch, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu``: the
    JAX launcher's defaults (its codebook and image-embedding stubs), a
    1x1 mesh; finite losses, one a step."""
    ranks, hist = launch.main(["--arch", arch, "--reduced", "--steps", "3",
                               "--seq", "16", "--device", "cpu"])
    assert len(ranks) == 1 and ranks[0]["history"] is hist
    assert ranks[0]["collectives_step0"] == {} and "params" in ranks[0]
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 1}" in out and "final loss" in out


def _example():
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "train_lm_e2e_torch.py")
    spec = importlib.util.spec_from_file_location("train_lm_e2e_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("prune", [False, True])
def test_example_trains_charlm_on_the_cpu(prune, capsys):
    """examples/train_lm_e2e_torch.py on charlm-2m: unpruned, the loss
    falls over 30 steps; with ``--prune`` (ADMM-CSB on the FFN at 4x, the
    projection at step 25, finalized) every FFN matrix keeps at most
    0.25 + 0.06 (tests/test_train.py:76's cross-point allowance)."""
    argv = ["--device", "cpu", "--steps", "30"] + (["--prune"] if prune
                                                   else [])
    out = _example().main(argv)
    assert out["steps"] == 30
    if prune:
        assert out["density"] <= 0.31
    else:
        assert out["last"] < out["first"] - 0.1
    assert "charlm-2m" in capsys.readouterr().out
