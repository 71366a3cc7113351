"""The port's sharding rules (``repro_torch.distributed.sharding`` and
``.params``) against the JAX package's, mirroring ``tests/test_sharding.py``
without its ``hlo_cost`` tests and without a process group: every port
config's parameter tree (shapes only: the ``meta`` device against
``jax.eval_shape``) gets each leaf's spec equal to JAX's ``param_specs``
under the "2d", "zero2" and "dp_only" policies on a shape-only
(data 16, model 16) mesh, ``sharded_bytes`` equal to JAX's, every spec'd
dim divisible, the MoE experts on "model", and the logical-rule machinery
(missing axes dropped, ``constrain`` a no-op outside a context,
``divisible``) as JAX's."""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.distributed import params as jparams
from repro.distributed import sharding as jshd
from repro.models import registry as jregistry
from repro_torch.common.tree import tree_paths
from repro_torch.configs import CONFIGS, REDUCED, get_config
from repro_torch.distributed import params, sharding
from repro_torch.models import registry


class FakeMesh:
    """Shape-only stand-in so tests don't allocate 256 devices."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = [FakeMesh({"data": 16, "model": 16}), FakeMesh({"data": 4,
                                                         "model": 1}),
          FakeMesh({"pod": 2, "data": 8, "model": 4})]


def _port_shapes(cfg):
    if cfg.family == "gcn":
        return registry.init_params(cfg, seed=0, device="cpu")
    return registry.init_params(cfg, device="meta")


def _jax_shapes(cfg):
    return jax.eval_shape(lambda: jregistry.init_params(
        cfg, jax.random.PRNGKey(0)))


def _jax_paths(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_param_specs_and_bytes_match_jax(arch, reduced):
    cfg = get_config(arch, reduced=reduced)
    jcfg = jax_get_config(arch, reduced=reduced)
    tp, jp = _port_shapes(cfg), _jax_shapes(jcfg)
    tpaths, jpaths = tree_paths(tp), _jax_paths(jp)
    assert [n for n, _ in tpaths] == [n for n, _ in jpaths]
    for (n, t), (_, j) in zip(tpaths, jpaths):
        assert tuple(t.shape) == tuple(j.shape), n
    ed = cfg.padded_experts or None
    for mesh in MESHES:
        for policy in ("2d", "zero2", "dp_only"):
            ts = params.param_specs(tp, mesh, expert_dim=ed, policy=policy)
            js = jparams.param_specs(jp, mesh, expert_dim=ed, policy=policy)
            for (n, a), (_, b) in zip(tree_paths(ts), _jax_paths(js)):
                assert a == tuple(b), (n, policy, a, b)
                assert isinstance(a, sharding.PartitionSpec)
            assert params.sharded_bytes(tp, ts, mesh) == \
                jparams.sharded_bytes(jp, js, mesh), policy
            for (n, leaf), (_, spec) in zip(tree_paths(tp), tree_paths(ts)):
                for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * 10):
                    if ax is not None:
                        assert dim % mesh.shape[ax] == 0, (n, spec)


@pytest.mark.parametrize("arch", sorted(REDUCED))
def test_leaf_spec_matches_jax_on_odd_shapes(arch):
    """leaf_spec on every leaf's path with its dims scaled up, so the
    128-element floor and the divisibility checks both bite."""
    cfg = get_config(arch, reduced=True)
    mesh = FakeMesh({"data": 8, "model": 4})
    for n, leaf in tree_paths(_port_shapes(cfg)):
        for scale in (1, 3, 8, 12):
            shape = tuple(int(d) * scale for d in leaf.shape)
            for ed in (None, 16 * scale, shape[0] if shape else None):
                assert params.leaf_spec(n, shape, mesh, ed) == tuple(
                    jparams.leaf_spec(n, shape, mesh, ed)), (n, shape, ed)


def test_moe_experts_sharded_on_model():
    cfg = get_config("qwen3-moe-30b-a3b")
    tp = registry.init_params(cfg, device="meta")
    specs = params.param_specs(tp, MESHES[0], expert_dim=cfg.padded_experts)
    assert "model" in tuple(specs["layers"]["moe"]["wi"])
    assert specs["layers"]["moe"]["wi"] == (None, None, "model", "data", None)


def test_meta_init_draws_nothing():
    cfg = get_config("qwen3-moe-30b-a3b")
    tp = registry.init_params(cfg, device="meta")
    assert tp["layers"]["moe"]["wi"].device.type == "meta"
    assert sum(t.numel() for _, t in tree_paths(tp)) > 30e9


def test_logical_spec_drops_missing_axes():
    mesh = FakeMesh({"data": 1, "model": 1})
    with sharding.axis_rules(mesh):
        spec = sharding.logical_spec("batch", None, "ffn")
        assert spec == ("data", None, "model")          # 'pod' dropped
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with jshd.axis_rules(jmesh):
        assert tuple(jshd.logical_spec("batch", None, "ffn")) == tuple(spec)
    pod = FakeMesh({"pod": 2, "data": 2, "model": 1})
    with sharding.axis_rules(pod):
        assert sharding.logical_spec("batch", "vocab") == (("pod", "data"),
                                                           "model")
        assert sharding.named_sharding("batch").spec == (("pod", "data"),)
    assert sharding.named_sharding("batch") is None
    assert sharding.current_mesh() is None


def test_constrain_noop_outside_context():
    x = torch.ones((4, 4))
    assert sharding.constrain(x, "batch", None) is x
    with sharding.axis_rules(FakeMesh({"data": 1, "model": 1})):
        assert sharding.constrain(x, "batch", None) is x
        with pytest.raises(ValueError, match="rank-2"):
            sharding.constrain(x, "batch")
    assert sharding.batch_mean(x) is x


def test_divisible_helper():
    with sharding.axis_rules(FakeMesh({"data": 1, "model": 1})):
        assert sharding.divisible(17, "ffn")      # 1-device mesh divides all
    with sharding.axis_rules(FakeMesh({"pod": 2, "data": 4, "model": 8})):
        assert sharding.divisible(16, "ffn") and not sharding.divisible(
            12, "ffn")
        assert sharding.divisible(8, "batch") and not sharding.divisible(
            12, "batch")
        assert sharding.divisible(3, "embed")
        assert sharding.batch_ranks() == 8
    assert sharding.divisible(17, "ffn")


def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh({"data": 4, "model": 2})
    assert sharding.spec_placements(mesh, sharding.PartitionSpec(
        None, "model", "data")) == (Shard(2), Shard(1))
    assert sharding.spec_placements(mesh, sharding.PartitionSpec()) == (
        Replicate(), Replicate())
    ns = sharding.NamedSharding(mesh, sharding.PartitionSpec("data", None))
    assert ns.placements == (Shard(0), Replicate())
