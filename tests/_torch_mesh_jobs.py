"""Rank programs of the mesh training tests (tests/test_torch_train_mesh*.py).

The spawned ranks import this module (torch and repro_torch only: JAX is
imported by the test modules' parents alone). ``train_cases`` trains each
case on the rank's mesh exactly as the launcher does on its mesh (the
activation rules installed, the params placed on ``param_specs``, the
batches on ``batch_specs``) and returns the losses, with rank 0 also
returning the trained params whole in JAX's layout.
"""
import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_numpy, params_to_numpy
from repro_torch.core import CSBSpec
from repro_torch.data import sharded_batches
from repro_torch.dist.api import place_tree, use_rules, whole
from repro_torch.dist.rules import (
    ShardingPolicy, activation_rules, batch_specs, param_specs,
)
from repro_torch.launch.shardspec import to_named
from repro_torch.models import ModelConfig, forward_loss
from repro_torch.train import TrainConfig, train

# tests/test_train.py's tiny CFG
TINY = dict(name="tiny", mixer="attn", ffn="swiglu", n_layers=2, d_model=32,
            n_heads=2, n_kv=2, head_dim=16, d_ff=64, vocab=32,
            dtype="float32", logit_chunk=16, remat=False)


def config(case: dict) -> ModelConfig:
    if case["arch"] == "tiny":
        return ModelConfig(**TINY)
    return get_reduced(case["arch"], **case.get("over", {}))


def admm_specs(params: dict) -> dict:
    """tests/test_torch_train.py's ADMM specs: wq and wo of every layer
    at rate 0.5 in 8x8 blocks."""
    spec = CSBSpec(bm=8, bn=8, prune_rate=0.5)
    specs = {k: None for k in params if k != "layers"}
    specs["layers"] = [
        {"norm1": None, "norm2": None,
         "mixer": {k: (spec if k in ("wq", "wo") else None)
                   for k in lp["mixer"]},
         "ffn": {k: None for k in lp["ffn"]}}
        for lp in params["layers"]]
    return specs


def whole_numpy(params: dict) -> dict:
    """Every rank gathers each tensor (a collective); JAX's layout."""
    def gather(t):
        if isinstance(t, dict):
            return {k: gather(v) for k, v in t.items()}
        if isinstance(t, list):
            return [gather(v) for v in t]
        return whole(t)
    return params_to_numpy(gather(params))


def placed_params(cfg, np_params: dict, mesh, policy):
    params = lm_params_from_numpy(np_params, device="cpu")
    return place_tree(params, to_named(
        mesh, param_specs(cfg, params, mesh, policy)))


def train_case(mesh, case: dict) -> dict:
    cfg = config(case)
    batches = case["batches"]
    policy = ShardingPolicy(fsdp=case.get("fsdp", False))
    rules = activation_rules(cfg, mesh, policy,
                             global_batch=batches[0]["tokens"].shape[0])
    with use_rules(rules):
        params = placed_params(cfg, case["params"], mesh, policy)
        specs = admm_specs(params) if case.get("admm") else None
        it = sharded_batches(
            iter(enumerate(batches)), mesh,
            batch_specs(cfg, "train", mesh,
                        global_batch=batches[0]["tokens"].shape[0]))
        params, hist = train(lambda p, b: forward_loss(p, b, cfg), params,
                             it, TrainConfig(**case["tcfg"]),
                             csb_specs=specs, log=lambda *_: None)
    out = {"losses": [h["loss"] for h in hist]}
    full = whole_numpy(params)
    if mesh.get_rank() == 0:
        out["params"] = full
    return out


def train_cases(mesh, cases: dict, sync: bool = False) -> dict:
    """Each case on this rank: {name: {losses[, params on rank 0]}}.
    ``sync``: DTensor's collectives run as c10d's synchronous ones
    (``dist.gloo_cuda``, registered for the CPU here), as the card's
    gloo ranks run them."""
    torch.set_num_threads(1)      # the test workers share the host's cores
    torch.manual_seed(0)
    if sync:
        from repro_torch.dist.gloo_cuda import use_sync_collectives
        use_sync_collectives("CPU")
    return {name: train_case(mesh, case) for name, case in cases.items()}


def numpy_tree(t):
    if isinstance(t, dict):
        return {k: numpy_tree(v) for k, v in t.items()}
    return np.asarray(t)


def restore_cases(mesh, ckpts, np_params: dict) -> list:
    """:func:`restore_case` for each (directory, step) of ``ckpts``."""
    torch.set_num_threads(1)
    return [restore_case(mesh, d, step, np_params) for d, step in ckpts]


def restore_case(mesh, ckpt_dir: str, step: int, np_params: dict) -> dict:
    """Restore the tiny model's {params, opt} (AdamW), written by another
    mesh or by the JAX package, onto this mesh through ``shardings``
    (FSDP's placements, so that weights split over "data" too); the
    placements of two leaves and every leaf whole (JAX's layout)."""
    from repro_torch.launch.shardspec import opt_state_specs
    from repro_torch.optim import get_optimizer
    from repro_torch.train import checkpoint as ckpt

    cfg, policy = config({"arch": "tiny"}), ShardingPolicy(fsdp=True)
    params = lm_params_from_numpy(np_params, device="cpu")
    opt = get_optimizer("adamw")
    like = {"params": params, "opt": opt.init(params)}
    pspecs = param_specs(cfg, params, mesh, policy)
    shardings = to_named(mesh, {"params": pspecs,
                                "opt": opt_state_specs(opt, pspecs)})
    tree, _ = ckpt.restore(ckpt_dir, step, like, shardings=shardings)
    wq = tree["params"]["layers"][0]["mixer"]["wq"]
    m_wo = tree["opt"].inner["m"]["layers"][1]["mixer"]["wo"]
    return {"placements": (tuple(wq.placements), tuple(m_wo.placements)),
            "params": whole_numpy(tree["params"]),
            "m": whole_numpy(tree["opt"].inner["m"]),
            "v": whole_numpy(tree["opt"].inner["v"]),
            "step": int(whole(tree["opt"].step))}


def traps(mesh) -> dict:
    """``torch.cumsum`` along a split dim (raw and through ``along``),
    and the sites that pin it: MoE's dispatch positions with one token
    group (the batch's split lands on the token dim), SSD's scan on a
    sequence-split input; each against the same function on plain
    tensors. Also ``sharded_batches``' rows per rank on the real mesh."""
    torch.set_num_threads(1)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    import repro_torch.models.layers as L
    from repro_torch.dist.api import NamedSharding, P, along, place
    from repro_torch.models import init_params

    out = {}
    x = torch.arange(4 * 16, dtype=torch.float32).reshape(4, 16) % 7
    split = place(x, NamedSharding(mesh, (Shard(1), Replicate())))
    out["cumsum_split"] = whole(torch.cumsum(split, 1)).numpy()
    out["cumsum_along"] = whole(
        along(split, 1, lambda t: torch.cumsum(t, 1))).numpy()
    out["cumsum"] = torch.cumsum(x, 1).numpy()

    gen = torch.Generator("cpu").manual_seed(0)
    rows = NamedSharding(mesh, (Shard(0), Replicate()))
    for arch, site in (("deepseek-v2-236b", "moe"), ("mamba2-370m", "ssd")):
        cfg = get_reduced(arch)
        params = init_params(cfg, gen, "cpu")
        policy = ShardingPolicy()
        b, s = (4, 16) if site == "moe" else (2, 64)
        h = torch.randn(b, s, cfg.d_model, generator=gen)
        if site == "moe":
            fn, lp = L.moe_apply, params["layers"][0]["ffn"]
            hx = place(h, rows)                       # the batch split
        else:
            fn, lp = L.ssd_block_apply, params["layers"][0]["mixer"]
            hx = place(h, NamedSharding(mesh, (Shard(1), Replicate())))
        plain = fn(lp, h, cfg)
        placed = place_tree(
            {"layers": [params["layers"][0]]},
            to_named(mesh, param_specs(cfg, {"layers": [params["layers"][0]]},
                                       mesh, policy)))["layers"][0]
        lpd = placed["ffn" if site == "moe" else "mixer"]
        rules = activation_rules(cfg, mesh, policy, global_batch=b)
        with use_rules(rules), implicit_replication():
            out[f"{site}_err"] = float((whole(fn(lpd, hx, cfg))
                                        - plain).abs().max())

    batches = [{"tokens": np.arange(8 * 4).reshape(8, 4) + 100 * i,
                "labels": np.zeros((8, 4), np.int64)} for i in range(2)]
    it = sharded_batches(iter(enumerate(batches)), mesh,
                         {"tokens": P("data", None)})
    got = [(step, b["tokens"].to_local().numpy(), tuple(b["tokens"].placements),
            tuple(b["labels"].placements)) for step, b in it]
    out["batches"] = got
    out["coord"] = mesh.get_coordinate()

    # dist.gloo_cuda's kernels, registered for the CPU, against DTensor's
    # own collectives on the same inputs: each mesh dim's group
    from torch.distributed.tensor import Partial
    from repro_torch.dist.gloo_cuda import use_sync_collectives
    y = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6) \
        * (1 + mesh.get_rank())
    moves = {"S0->R": ((Shard(0),), (Replicate(),)),
             "P->R": ((Partial(),), (Replicate(),)),
             "P->S0": ((Partial(),), (Shard(0),)),
             "S0->S1": ((Shard(0),), (Shard(1),)),
             "Pavg->R": ((Partial("avg"),), (Replicate(),))}
    from torch.distributed.tensor import DTensor

    def run():
        res = {}
        for dim in range(mesh.ndim):
            for k, (src, dst) in moves.items():
                pl = lambda p: tuple(p if i == dim else Replicate()
                                     for i in range(mesh.ndim))
                d = DTensor.from_local(y, mesh, [pl(p) for p in src][0],
                                       run_check=False)
                res[(dim, k)] = d.redistribute(
                    mesh, [pl(p) for p in dst][0]).to_local().numpy()
        return res
    native = run()
    use_sync_collectives("CPU")
    synced = run()
    group = mesh.get_group(0)
    name = group.group_name
    direct = {"alltoall": torch.ops._dtensor.shard_dim_alltoall(
        y, 0, 1, name).numpy()}
    out["collectives"] = (native, synced, direct)
    out["opt_placements"] = opt_placements(mesh)
    return out


def opt_placements(mesh) -> dict:
    """Each optimizer's state, made by ``opt.init`` from the tiny model's
    placed params: the leaves whose placements differ from
    ``launch.shardspec.opt_state_specs``' (none expected)."""
    from repro_torch import _tree
    from repro_torch.launch.shardspec import opt_state_specs
    from repro_torch.launch.shardspec import to_placements as tree_pls
    from repro_torch.models import init_params
    from repro_torch.optim import get_optimizer

    cfg, policy = config({"arch": "tiny"}), ShardingPolicy()
    params = init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    pspecs = param_specs(cfg, params, mesh, policy)
    params = place_tree(params, to_named(mesh, pspecs))
    out = {}
    for name in ("sgd", "adamw", "adafactor"):
        opt = get_optimizer(name)
        state = opt.init(params)
        want = tree_pls(mesh, opt_state_specs(opt, pspecs))
        got = [tuple(t.placements) for ps in _tree.leaves(state.inner)
               for t in ps]
        exp = [pl for ps in _tree.leaves(want.inner) for pl in ps]
        out[name] = (len(got), [i for i, (g, e) in enumerate(zip(got, exp))
                                if g != e], len(exp))
    return out
