"""The port's sharding rules and meshes against the JAX package's, on the CPU.

``repro_torch.dist.sharding``'s ``param_specs`` against
``repro.dist.sharding.param_specs`` for every leaf of the ten
configurations at full size on the two production meshes (the JAX tree
from ``jax.eval_shape``, the port's from its field tables, nothing
allocated), ``batch_specs`` and ``cache_specs`` (the JAX package's
[B, S, K, hd] specs carried to the port's [B, K, S, hd]), ``placements``'
local shards on a gloo (2, 2) data x model mesh of 4 processes, and the
mesh builders of ``repro_torch.launch.mesh``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.dist import sharding as jshard  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from test_torch_collectives import run_ranks  # noqa: E402

MESHES = {"single_pod_16x16": False, "multi_pod_2x16x16": True}
# the configurations whose stacked [n_super] axis the rule gives "data" at
# 16 x 16, and on how many leaves
STACKED_DATA = {"qwen3-32b": 4, "nemotron-4-15b": 5, "internvl2-26b": 4,
                "granite-moe-3b-a800m": 8, "whisper-large-v3": 13}


def abstract(multi_pod: bool):
    if multi_pod:
        return jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return jax.sharding.AbstractMesh((16, 16), ("data", "model"))


def jax_specs(tree, specs) -> dict:
    """leaf name -> (shape, spec entries) of a JAX tree and its specs."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sflat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat) == len(sflat)
    return {jckpt._leaf_id(path): (tuple(leaf.shape), tuple(s))
            for (path, leaf), s in zip(flat, sflat)}


@pytest.fixture(scope="module")
def jax_params():
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    return {a: jax.eval_shape(lambda k, c=jreg.get_config(a): jmodel.init_params(k, c), key)
            for a in jreg.ARCHS}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_param_specs_equal_the_jax_packages(jax_params, arch, mesh_name):
    multi = MESHES[mesh_name]
    want = jax_specs(jax_params[arch], jshard.param_specs(jax_params[arch], abstract(multi)))
    cfg = treg.get_config(arch)
    shapes = sharding.param_shapes(cfg)
    got = sharding.param_specs(cfg, mesh.make_production_mesh(multi_pod=multi))
    assert set(got) == set(want) == set(shapes)
    for name, (shape, spec) in want.items():
        assert shapes[name] == shape, name
        assert isinstance(got[name], sharding.Spec) and tuple(got[name]) == spec, (name, got[name],
                                                                                   spec)
    stacked = sum(1 for n, s in got.items() if n.startswith(("main.", "encoder."))
                  and s and s[0] == "data")
    assert stacked == STACKED_DATA.get(arch, 0), stacked


def test_the_rule_on_a_stacked_leaf_is_not_the_rule_on_its_superblocks():
    """qwen3-32b's main.0.ln is (64, 5120) in the JAX layout: "data" on the
    stacked axis; the port's own [5120] tensor of one superblock would be
    replicated."""
    cfg = treg.get_config("qwen3-32b")
    specs = sharding.param_specs(cfg, mesh.make_production_mesh())
    assert sharding.param_shapes(cfg)["main.0.ln"] == (64, 5120)
    assert specs["main.0.ln"] == sharding.Spec("data", "model")
    assert sharding._matrix_spec((5120,), 16, 16) == sharding.Spec()


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_cache_specs_equal_the_jax_packages_carried_to_the_port(arch, mesh_name):
    multi = MESHES[mesh_name]
    jcfg, cfg = jreg.get_config(arch), treg.get_config(arch)
    B, L = 64, 4096
    cache = jax.eval_shape(lambda: jmodel.init_cache(None, jcfg, B, L))
    want = jax_specs(cache, jshard.cache_specs(cache, abstract(multi)))
    shapes = sharding.cache_shapes(cfg, B, L)
    got = sharding.cache_specs(cfg, mesh.make_production_mesh(multi_pod=multi), B, L)
    assert set(got) == set(want) == set(shapes)
    for name, (jshape, jspec) in want.items():
        shape, perm = shapes[name]
        assert tuple(shape[d] for d in perm) == jshape, name
        carried = [None] * len(shape)
        for j, entry in enumerate(jspec):
            carried[perm[j]] = entry
        while carried and carried[-1] is None:
            carried.pop()
        assert tuple(got[name]) == tuple(carried), (name, got[name], jspec)


def test_cache_spec_puts_model_on_the_sequence_as_the_jax_layout_does():
    """A KV leaf: the JAX package's [B, S, K, hd] puts "model" on its first
    later dim the axis divides, S; carried to the port's [B, K, S, hd] that
    is dim 2 (here behind the stacked [n_super]).  The rule applied to the
    port's own order would have chosen K."""
    cfg = treg.get_config("qwen3-32b").replace(n_layers=1)
    m = mesh.make_mesh_like((2, 8), device="cpu")
    specs = sharding.cache_specs(cfg, m, 4, 4096)
    shape, _ = sharding.cache_shapes(cfg, 4, 4096)["main.0.k"]
    assert shape == (1, 4, cfg.n_kv_heads, 4096, cfg.hd) and cfg.n_kv_heads % 8 == 0
    assert specs["main.0.k"] == sharding.Spec(None, None, None, "model")
    own_order = sharding._carry(sharding.Spec(None, None, "model"), tuple(range(5)))
    assert own_order != specs["main.0.k"]


@pytest.mark.parametrize("mesh_name", MESHES)
def test_batch_specs_equal_the_jax_packages(mesh_name):
    multi = MESHES[mesh_name]
    shapes = {"tokens": (256, 4096), "labels": (256, 4096), "frames": (64, 3000, 128),
              "odd": (3, 5), "small": (16, 2), "scalar": ()}
    batch = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}
    want = jshard.batch_specs(batch, abstract(multi))
    got = sharding.batch_specs(shapes, mesh.make_production_mesh(multi_pod=multi))
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    tensors = {k: torch.zeros(s) for k, s in shapes.items() if k != "frames"}
    assert sharding.batch_specs(tensors, mesh.make_production_mesh(multi_pod=multi)) == {
        k: got[k] for k in tensors}


def test_mesh_builders_mirror_the_jax_packages():
    for multi in (False, True):
        m = mesh.make_production_mesh(multi_pod=multi)
        assert m.transport is None and m.shape == dict(abstract(multi).shape)
        assert mesh.dp_axes(m) == (("pod", "data") if multi else ("data",))
        with pytest.raises(ValueError, match="abstract"):
            m.axis("data")
    m = mesh.make_mesh_like((2, 2, 2), device="cpu")
    assert m.axis_names == ("pod", "data", "model") and m.transport == "local"
    assert mesh.make_mesh_like((4,), device="cpu").axis_names == ("model",)
    assert mesh.dp_axes(mesh.make_mesh_like((2, 4), device="cpu")) == ("data",)
    pod = mesh.make_pod_mesh(4, device="cpu")
    assert pod.shape == {"pod": 4} and pod.transport == "local" and pod.size == 4
    assert mesh.dp_axes(pod) == ("pod",)
    axis = pod.axis("pod")
    assert axis.size == 4 and axis.device == torch.device("cpu")
    with pytest.raises(ValueError, match="1-D"):
        m.axis("pod")
    with pytest.raises(ValueError, match="device mesh"):
        pod.to_device_mesh()
    # the JAX package's own builders name the same axes
    assert jmesh.dp_axes(jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))) == \
        mesh.dp_axes(mesh.make_production_mesh(multi_pod=True))


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    m = mesh.make_production_mesh(multi_pod=True)
    assert sharding.placements(sharding.Spec(("pod", "data"), "model"), m) == (
        Shard(0), Shard(0), Shard(1))
    assert sharding.placements(sharding.Spec(None, "data"), m) == (
        Replicate(), Shard(1), Replicate())
    assert sharding.placements(sharding.Spec(), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sharding.placements(sharding.Spec(("data", "pod")), m)


GLOO_MESH = """
    init()
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.dist import sharding
    from repro_torch.launch import mesh

    m = mesh.make_mesh_like((2, 2))
    assert m.transport == "process" and m.axis_names == ("data", "model")
    local = mesh.make_pod_mesh(2, device="cpu")
    assert local.transport == "local"
    dm = m.to_device_mesh()
    out = {"coords": np.array(dm.get_coordinate())}
    full = torch.arange(8 * 12 * 6, dtype=torch.float32).reshape(8, 12, 6)
    specs = {"dm": sharding.Spec("data", "model"), "md": sharding.Spec(None, "model", "data"),
             "both": sharding.Spec(("data", "model")), "rep": sharding.Spec(),
             "data": sharding.Spec("data")}
    for k, spec in specs.items():
        out[k] = distribute_tensor(full, dm, sharding.placements(spec, m)).to_local().numpy()
    axis = mesh.make_pod_mesh(4).axis("pod")
    out["ring"] = axis.size * np.ones(1) + axis.rank
    np.savez(OUT, **out)
    dist.destroy_process_group()
"""


def test_placements_give_the_jax_shards_on_a_gloo_mesh(tmp_path):
    """Each rank's local shard is the block that ``NamedSharding`` gives the
    device at its (data, model) coordinate: a dim over ("data", "model")
    split data-major."""
    ranks = run_ranks(GLOO_MESH, 4, tmp_path)
    full = np.arange(8 * 12 * 6, dtype=np.float32).reshape(8, 12, 6)
    for r, out in enumerate(ranks):
        d, mo = (int(c) for c in out["coords"])
        assert (d, mo) == divmod(r, 2)
        np.testing.assert_array_equal(out["dm"], full[4 * d:4 * d + 4, 6 * mo:6 * mo + 6])
        np.testing.assert_array_equal(out["md"], full[:, 6 * mo:6 * mo + 6, 3 * d:3 * d + 3])
        np.testing.assert_array_equal(out["both"], full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["rep"], full)
        np.testing.assert_array_equal(out["data"], full[4 * d:4 * d + 4])
        assert out["ring"][0] == 4 + r  # make_pod_mesh over the group: process
