"""The port's placement rules (``repro_torch.dist.api`` and ``.rules``,
``launch.shardspec``, ``configs.sharding_policy``) against the JAX
package's, on the host alone: no process group, no device mesh.

Both packages read a mesh's axis names and sizes only, so each side gets
a stand-in of JAX's production shapes (16 x 16 and 2 x 16 x 16, as
tests/test_dist.py's ``_FakeMesh``) and of a small (2, 1) and (1, 2).
JAX derives its specs from ``abstract_params`` (stacked ``(L, ...)``
leaves); the port from the same shapes in its own tree (``"layers"`` a
list of per-layer tensors, on the meta device), and drops the layer
entry, which JAX never splits. Every spec must equal JAX's, entry for
entry.
"""
import math

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import sharding_policy as j_sharding_policy
from repro.dist import api as japi
from repro.dist import rules as jrules
from repro.launch.shardspec import opt_state_specs as j_opt_state_specs
from repro.models import abstract_params
from repro.models.lm import abstract_cache, abstract_paged_cache
from repro.optim import get_optimizer as j_get_optimizer
from repro_torch import _tree
from repro_torch.configs import ARCH_IDS, get_config, sharding_policy
from repro_torch.dist import api, rules
from repro_torch.dist.api import P
from repro_torch.launch.shardspec import opt_state_specs, to_placements
from repro_torch.optim import get_optimizer

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x1": {"data": 2, "model": 1},
          "1x2": {"data": 1, "model": 2}}


class _JMesh:
    """What the JAX package's rules read of a Mesh."""

    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


class _TMesh:
    """What the port's rules read of a DeviceMesh."""

    def __init__(self, axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())
        self.ndim = len(axes)


def _meshes(name):
    return _JMesh(MESHES[name]), _TMesh(MESHES[name])


def _port_tree(jtree):
    """JAX's (abstract) parameter tree in the port's structure, on the
    meta device: each stacked ``"layers"`` leaf cut into its layers."""
    def meta(t):
        return torch.empty(t.shape, device="meta")

    def layer(t, i):
        if isinstance(t, dict):
            return {k: layer(v, i) for k, v in t.items()}
        return torch.empty(t.shape[1:], device="meta")

    out = {k: jax.tree.map(meta, v) for k, v in jtree.items()
           if k != "layers"}
    n = jax.tree.leaves(jtree["layers"])[0].shape[0]
    out["layers"] = [layer(jtree["layers"], i) for i in range(n)]
    return out


def _jax_view(tree):
    """A port spec tree in JAX's structure: a per-layer spec list as one
    stacked spec (every layer's alike; the layer entry None)."""
    def one(specs, stacked):
        if not stacked:
            return specs[0]
        assert all(s == specs[0] for s in specs)
        return (None,) + tuple(specs[0])
    return _tree.jax_structure(tree, one)


def _same(port, jax_tree):
    """Equal specs, entry for entry, at the same paths."""
    jl = jax.tree_util.tree_leaves_with_path(
        jax_tree, is_leaf=lambda x: isinstance(x, JP))
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            flat[path] = t
    walk(port, ())
    assert len(flat) == len(jl)
    for path, spec in jl:
        keys = tuple(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in path)
        assert tuple(flat[keys]) == tuple(spec), (keys, flat[keys], spec)


def test_arch_ids_are_jax_s():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    ap = abstract_params(jcfg)
    for fsdp in (False, True):
        jpol = jrules.ShardingPolicy(fsdp=fsdp)
        pol = rules.ShardingPolicy(fsdp=fsdp)
        jspecs = jrules.param_specs(jcfg, ap, jm, jpol)
        specs = rules.param_specs(cfg, _port_tree(ap), tm, pol)
        assert all(isinstance(s, P) for s in
                   (x for ps in _tree.leaves(specs) for x in ps))
        _same(_jax_view(specs), jspecs)
        # dense leaves of csb_shard_specs: the same spec, as placements
        place = rules.csb_shard_specs(_port_tree(ap), tm, policy=pol)
        assert place["layers"][0]["norm1"] == api.to_placements(
            specs["layers"][0]["norm1"], tm)
        assert place["embed"] == api.to_placements(specs["embed"], tm)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_specs_and_policy_match_jax(arch):
    jm, tm = _meshes("16x16")
    jcfg, cfg = j_get_config(arch), get_config(arch)
    ap = abstract_params(jcfg)
    jspecs = jrules.param_specs(jcfg, ap, jm, jrules.ShardingPolicy())
    specs = rules.param_specs(cfg, _port_tree(ap), tm,
                              rules.ShardingPolicy())
    for name in ("sgd", "adamw", "adafactor"):
        js = j_opt_state_specs(j_get_optimizer(name), jspecs)
        ts = opt_state_specs(get_optimizer(name), specs)
        assert tuple(ts.step) == tuple(js.step) == ()
        inner = ts.inner if name == "adafactor" else _jax_view(ts.inner)
        _same(inner, js.inner)
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert sharding_policy(arch, shape).__dict__ == \
            j_sharding_policy(arch, shape).__dict__


@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_and_batch_specs_match_jax(mesh):
    jm, tm = _meshes(mesh)
    for arch in ARCH_IDS:
        jcfg, cfg = j_get_config(arch), get_config(arch)
        for seq in (False, True):
            jpol = jrules.ShardingPolicy(seq_shard=seq)
            pol = rules.ShardingPolicy(seq_shard=seq)
            for gb in (None, 8, 7, 32):
                jr = jrules.activation_rules(jcfg, jm, jpol, global_batch=gb)
                tr = rules.activation_rules(cfg, tm, pol, global_batch=gb)
                assert tr.mesh is tm
                assert {k: tuple(v) for k, v in tr.items()} == \
                    {k: tuple(v) for k, v in jr.items()}
                for kind in ("train", "prefill", "decode"):
                    jb = jrules.batch_specs(jcfg, kind, jm, global_batch=gb)
                    tb = rules.batch_specs(cfg, kind, tm, global_batch=gb)
                    assert {k: tuple(v) for k, v in tb.items()} == \
                        {k: tuple(v) for k, v in jb.items()}


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-236b",
                                  "mamba2-370m", "hymba-1.5b"])
def test_cache_specs_match_jax(arch):
    """The port's caches are stacked as JAX's are: both packages get
    JAX's abstract caches (contiguous and paged)."""
    import jax.numpy as jnp
    jcfg, cfg = j_get_config(arch), get_config(arch)
    caches = [(abstract_cache(jcfg, 32, 64, jnp.bfloat16), False),
              (abstract_paged_cache(jcfg, 64, 16, 32, jnp.bfloat16), True)]
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for cs in (False, True):
            jpol = jrules.ShardingPolicy(shard_cache_seq=cs)
            pol = rules.ShardingPolicy(shard_cache_seq=cs)
            for cache, paged in caches:
                _same(rules.cache_specs(cfg, cache, tm, pol, paged=paged),
                      jrules.cache_specs(jcfg, cache, jm, jpol, paged=paged))


def test_fit_spec_matches_jax():
    cases = [(("data", "model"), (32, 40)), (("model",), (7, 7)),
             (("expert", "model"), (16, 16)), ((("pod", "data"), None),
                                               (64, 3)),
             ((("pod", "data"), "model"), (6, 32)), ((), (4,)),
             ((None, "model", None), (2, 32, 5))]
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for spec, shape in cases:
            j = japi.fit_spec(JP(*spec), shape, jm)
            t = api.fit_spec(P(*spec), shape, tm)
            assert (t is None) == (j is None), (mesh, spec, shape)
            if j is not None:
                assert tuple(t) == tuple(j)


def test_to_placements_round_trips():
    tm = _TMesh({"pod": 2, "data": 4, "model": 2})
    cases = {P("data", None): (Replicate(), Shard(0), Replicate()),
             P(None, "model"): (Replicate(), Replicate(), Shard(1)),
             P(("pod", "data"), "model"): (Shard(0), Shard(0), Shard(1)),
             P(None, None): (Replicate(),) * 3,
             P(("pod", "data", "model")): (Shard(0),) * 3}
    for spec, pls in cases.items():
        assert api.to_placements(spec, tm) == pls
        assert tuple(api.spec_of(pls, len(spec), tm)) == tuple(spec)
    # an axis of one device is no split; a misordered tuple, an unknown
    # axis and an axis named twice raise
    small = _TMesh({"data": 1, "model": 2})
    assert api.to_placements(P("data", "model"), small) == \
        (Replicate(), Shard(1))
    for bad in (P(("data", "pod")), P("expert"), P("data", "data")):
        with pytest.raises(ValueError):
            api.to_placements(bad, tm)
    # over a tree (OptState included), as launch.shardspec does it
    tree = {"a": P("data"), "b": [P(None, "model"), P()]}
    assert to_placements(tm, tree) == {
        "a": (Replicate(), Shard(0), Replicate()),
        "b": [(Replicate(), Replicate(), Shard(1)), (Replicate(),) * 3]}
    # P is a tuple of JAX's entries
    assert P("a", None) == ("a", None) and len(P()) == 0
    assert tuple(P(("a", "b"), None)) == tuple(JP(("a", "b"), None))
    assert repr(P("data", None)) == "P('data', None)"


def test_shard_is_the_identity_off_a_mesh():
    """No rules, a mesh of one device, an unknown name, or a plain tensor:
    ``shard`` and ``replicated`` return their argument itself."""
    x = torch.ones(4, 2)
    r = api.Rules({"residual": P("data", None)}, mesh=_TMesh(
        {"data": 2, "model": 1}))
    assert api.shard(x, "residual") is x and api.replicated(x) is x
    with api.use_rules(r):
        assert api.shard(x, "residual") is x          # not a DTensor
        assert api.shard(x, "nothing") is x
        assert api.replicated(x) is x
        assert api.along(x, 0, lambda t: t) is x
    one = api.Rules({"residual": P("data", None)}, mesh=_TMesh(
        {"data": 1, "model": 1}))
    with api.use_rules(one):
        assert api.shard(x, "residual", fallback="replicate") is x
    assert api.whole(x) is x and api.like(x, x) is x


def test_rules_scope_nests_and_survives_an_error():
    outer = api.Rules({"a": P("data")}, mesh="outer")
    inner = outer.updated(a=P(None), b=P("model"))
    assert api.current_rules() is None
    with api.use_rules(outer):
        with pytest.raises(KeyError):
            with api.use_rules(inner):
                assert api.current_rules() is inner
                assert inner.mesh == "outer" and inner.get("b") == P("model")
                raise KeyError("inside")
        assert api.current_rules() is outer
        assert outer.get("a") == P("data") and "b" not in outer
        with api.use_rules(None):
            assert api.current_rules() is outer
    assert api.current_rules() is None


def test_production_mesh_refuses_a_small_world():
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 devices"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="need 4 devices for test mesh"):
        make_test_mesh(device="cpu")
    assert math.prod((2, 16, 16)) == 512
