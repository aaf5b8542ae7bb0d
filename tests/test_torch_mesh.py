"""The port's named mesh and in-step collectives against the JAX package's.

One gloo world of 4 spawned ranks builds every mesh constructor's mesh and
runs the tree collectives (`torch_mesh_helpers.mesh_layouts`,
`tree_collectives`); the JAX side runs the same constructors over the first
4 of the test mesh's virtual CPU devices and the same collectives under
``shard_map``, on the same numpy inputs.

* Layout: rank ``r`` holds the coordinate device ``r`` holds in the JAX
  mesh (``jax.make_mesh`` lays out ``devices[:n]`` row-major), every
  axis and tuple of axes has the JAX index and size, and its process
  group ranks equal that index; `describe_mesh` and `world_size` are
  equal; each constructor's refusal is the JAX package's, word for word.
* Collectives: bitwise where they only move data (gathers, all-to-all,
  permutations, the masked-sum broadcast: every other addend is 0);
  ``rtol=1e-5, atol=1e-6`` where they sum (gloo and XLA may add 4
  addends in other orders).  The gradients of psum (a psum of the
  cotangent), ppermute (the inverse permutation) and all_to_all (the
  inverse all-to-all) equal JAX's transposes under ``shard_map`` at world
  2, and a 4-rank ring's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from pytorch_ps_mpi_tpu.parallel import collectives as JC
from pytorch_ps_mpi_tpu.parallel import mesh as JM

from torch_dist_helpers import run_world
from torch_mesh_helpers import MESHES, REFUSALS

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
DEV4 = jax.devices()[:4]


def _jax_mesh(fn, args, kw):
    return getattr(JM, fn)(*args, devices=DEV4, **kw)


def _inputs():
    rng = np.random.RandomState(7)
    inp = {"a": rng.randn(4, 4, 6).astype(np.float32),
           "b": rng.randn(4, 4, 3).astype(np.float32),
           "w": rng.randn(4, 4, 6).astype(np.float32)}
    for name, shape in (("psum", (4, 6)), ("ppermute", (4, 6)),
                        ("all_to_all", (2, 12)), ("pmean", (4, 6))):
        inp["w_" + name] = rng.randn(4, *shape).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    inputs = _inputs()
    layouts = run_world("torch_mesh_helpers:mesh_layouts", 4,
                        tmp_path_factory.mktemp("layouts"), timeout=180)
    colls = run_world("torch_mesh_helpers:tree_collectives", 4,
                      tmp_path_factory.mktemp("colls"), inputs, timeout=180)
    return inputs, layouts, colls


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_layout_matches_jax(world4, name):
    _, layouts, _ = world4
    jmesh = _jax_mesh(*MESHES[name])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r, out in enumerate(layouts):
        rec = out["layouts"][name]
        assert rec["describe"] == JM.describe_mesh(jmesh)
        assert rec["world_size"] == JM.world_size(jmesh,
                                                  jmesh.axis_names[0])
        where = np.argwhere(ids == r)
        if not len(where):
            assert rec["coords"] is None
            continue
        coord = dict(zip(jmesh.axis_names, map(int, where[0])))
        assert rec["coords"] == coord, (r, name)
        for axes, got in rec["axes"].items():
            index, size = 0, 1
            for a in axes:
                index = index * jmesh.shape[a] + coord[a]
                size *= jmesh.shape[a]
            assert got == {"index": index, "size": size,
                           "group_rank": index, "group_size": size}, axes


@pytest.mark.parametrize("name", list(REFUSALS))
def test_mesh_refusals_match_jax(world4, name):
    _, layouts, _ = world4
    with pytest.raises(ValueError) as e:
        _jax_mesh(*REFUSALS[name])
    for out in layouts:
        assert out["refusals"][name] == str(e.value)


def _spmd(fn, mesh, axis, *arrays):
    """``fn`` on each rank's row of the stacked ``arrays`` under
    ``shard_map``; its outputs (a tree) stacked back by rank."""
    spec = P(axis)

    def body(*xs):
        return jax.tree.map(lambda y: y[None], fn(*[x[0] for x in xs]))

    out = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(spec,) * len(arrays), out_specs=spec,
        check_vma=False))(*arrays)
    return jax.tree.map(np.asarray, out)


def _jax_collectives(inp):
    ps4 = JM.make_ps_mesh(4, devices=DEV4)
    dp_tp = JM.make_dp_tp_mesh(2, 2, devices=DEV4)
    ps2 = JM.make_ps_mesh(2, devices=DEV4)
    a, b = jnp.asarray(inp["a"]), jnp.asarray(inp["b"])
    ring = [(i, (i + 1) % 4) for i in range(4)]
    want = {}

    def tree_op(name, op, mesh=ps4, axis="ps"):
        want[name] = _spmd(lambda x, y: op({"a": x, "b": y}), mesh, axis,
                           a, b)

    tree_op("psum", lambda t: JC.psum_tree(t, "ps"))
    tree_op("pmean", lambda t: JC.pmean_tree(t, "ps"))
    tree_op("allgather", lambda t: JC.allgather_tree(t, "ps"))
    tree_op("allgather_tiled", lambda t: JC.allgather_tree(t, "ps",
                                                           tiled=True))
    tree_op("bcast", lambda t: JC.bcast_tree(t, "ps", root=1))
    tree_op("reduce_scatter", lambda t: JC.reduce_scatter_tree(t, "ps"))
    tree_op("alltoall", lambda t: JC.alltoall_tree(t, "ps"))
    tree_op("ppermute", lambda t: JC.ppermute_tree(
        t, "ps", [(0, 2), (2, 1), (1, 0)]))
    tree_op("ring_shift", lambda t: JC.ring_shift_tree(t, "ps", shift=3))
    tree_op("psum_tuple", lambda t: JC.psum_tree(t, ("ps", "tp")), dp_tp,
            ("ps", "tp"))
    tree_op("pmean_tp", lambda t: JC.pmean_tree(t, "tp"), dp_tp,
            ("ps", "tp"))
    tree_op("allgather_tuple", lambda t: JC.allgather_tree(t, ("ps", "tp")),
            dp_tp, ("ps", "tp"))
    want["bcast_bool"] = _spmd(
        lambda x: JC.bcast_tree({"f": x > 0}, "ps", root=2), ps4, "ps", a)
    want["rank"] = _spmd(lambda x: JC.rank("ps"), ps4, "ps", a)
    want["rank_tuple"] = _spmd(lambda x: JC.rank(("ps", "tp")), dp_tp,
                               ("ps", "tp"), a)

    def grad_of(op, mesh):
        def f(x, w):
            return op(x), jax.grad(lambda x: jnp.sum(op(x) * w))(x)
        return f

    w = jnp.asarray(inp["w"])
    want["grad_ring"] = _spmd(
        grad_of(lambda x: lax.ppermute(x, "ps", ring), ps4), ps4, "ps",
        a, w)[1]
    ops = {"psum": lambda x: lax.psum(x, "ps"),
           "ppermute": lambda x: lax.ppermute(x, "ps", [(0, 1)]),
           "all_to_all": lambda x: lax.all_to_all(x, "ps", 0, 1, tiled=True),
           "pmean": lambda x: lax.pmean(x, "ps")}
    want["grads"] = {
        name: _spmd(grad_of(op, ps2), ps2, "ps", a[:2],
                    jnp.asarray(inp["w_" + name][:2]))
        for name, op in ops.items()}
    return want


@pytest.fixture(scope="module")
def jax_colls(world4):
    return _jax_collectives(world4[0])


MOVES = ["allgather", "allgather_tiled", "bcast", "alltoall", "ppermute",
         "ring_shift", "allgather_tuple"]
SUMS = ["psum", "pmean", "reduce_scatter", "psum_tuple", "pmean_tp"]


@pytest.mark.parametrize("op", MOVES + SUMS)
def test_tree_collective_matches_jax(world4, jax_colls, op):
    _, _, colls = world4
    for r, out in enumerate(colls):
        for leaf in ("a", "b"):
            got, want = out[op][leaf], np.asarray(jax_colls[op][leaf][r])
            if op in MOVES:
                np.testing.assert_array_equal(got, want, err_msg=(op, r))
            else:
                np.testing.assert_allclose(got, want, err_msg=(op, r),
                                           **SUM_TOL)


def test_bcast_of_bools_and_rank_match_jax(world4, jax_colls):
    _, _, colls = world4
    for r, out in enumerate(colls):
        want = np.asarray(jax_colls["bcast_bool"]["f"][r])
        assert out["bcast_bool"]["dtype"] == "torch.bool"
        np.testing.assert_array_equal(out["bcast_bool"]["f"], want)
        assert out["rank"] == int(jax_colls["rank"][r]) == r
        assert out["rank_tuple"] == int(jax_colls["rank_tuple"][r]) == r


@pytest.mark.parametrize("op", ["psum", "ppermute", "all_to_all", "pmean"])
def test_collective_gradient_is_the_jax_transpose(world4, jax_colls, op):
    """World 2: the values and the gradients of ``sum(op(x) * w)``; psum's
    gradient is a psum of the cotangent, ppermute's the inverse pair (rank
    0 gets rank 1's cotangent), all_to_all's the inverse all-to-all."""
    _, _, colls = world4
    y_want, g_want = jax_colls["grads"][op]
    for r in range(2):
        got = colls[r]["grads"][op]
        np.testing.assert_allclose(got["y"], np.asarray(y_want[r]),
                                   **SUM_TOL)
        np.testing.assert_allclose(got["grad"], np.asarray(g_want[r]),
                                   **SUM_TOL)
    assert colls[2].get("grads") is None  # ranks 2, 3 are not in the mesh
    if op == "psum":  # not the identity: each rank gets the summed w
        assert not np.allclose(colls[0]["grads"][op]["grad"],
                               _inputs()["w_psum"][0])


def test_ring_gradient_is_the_reverse_ring(world4, jax_colls):
    _, _, colls = world4
    for r, out in enumerate(colls):
        np.testing.assert_array_equal(out["grad_ring"],
                                      np.asarray(jax_colls["grad_ring"][r]))
