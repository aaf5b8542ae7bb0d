"""Bucketed collectives of the port.

* The bucket plans (`_plan_buckets`, `_solo_default`) equal the JAX
  package's on the same leaf lists — exactly: they decide which leaves
  share a collective.
* A world-2 gloo run of `psum_tree_bucketed`, `allgather_tree_bucketed`
  and `pmean_tree`, bucketed and per-leaf, against numpy; and of
  `psum_tree_bucketed(decompose=True)` (reduce-scatter + all-gather, with
  the padding of sizes that are not a multiple of the world).  Tolerance:
  none — a sum of two float32 values is exact in either order, and a
  gather moves bytes.
* The reference's nonblocking layer (`iallgather`, `igather` with and
  without ``root_only``, `ibroadcast`, `ialltoall`, `ireduce` and
  `PendingTree`) at gloo world 2 against the JAX package's on a 2-device
  CPU mesh, each rank's payload slice ``r`` of the JAX global array:
  bitwise, with the same timing keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.parallel import collectives as jcoll
from pytorch_ps_mpi_tpu_torch.models import build_model, resnet18
from pytorch_ps_mpi_tpu_torch.ops.codecs import BlockQuantizeCodec
from pytorch_ps_mpi_tpu_torch.parallel import collectives as tcoll
from pytorch_ps_mpi_tpu_torch.utils.flatten import tree_leaves

from torch_dist_helpers import rank_tree, run_world


@pytest.fixture(scope="module")
def leaf_lists():
    params, _ = build_model(resnet18())
    grads = list(params.values())
    codec = BlockQuantizeCodec()
    codes = tree_leaves({n: codec.encode(torch.zeros(p.shape))
                         for n, p in params.items()})
    mixed = [torch.zeros(s, dtype=d) for s, d in [
        ((10,), torch.float32), ((3000, 40), torch.float32),
        ((7,), torch.bfloat16), ((5, 5), torch.int8), ((70000,), torch.float32),
        ((2,), torch.int16), ((), torch.float32), ((90000,), torch.bfloat16)]]
    return {"resnet18_grads": grads, "resnet18_blockq_codes": codes,
            "mixed": mixed}


_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.int8: jnp.int8, torch.int16: jnp.int16}


@pytest.mark.parametrize("bucket_bytes", [4 << 20, 1 << 20, 64 << 10, 4096])
@pytest.mark.parametrize("solo", [None, 0, 100_000])
def test_bucket_plans_match_jax(leaf_lists, bucket_bytes, solo):
    for name, leaves in leaf_lists.items():
        jleaves = [jnp.zeros(tuple(x.shape), _JNP[x.dtype]) for x in leaves]
        s = tcoll._solo_default(bucket_bytes, solo)
        assert s == jcoll._solo_default(bucket_bytes, solo)
        assert tcoll._plan_buckets(leaves, bucket_bytes, s) == \
            jcoll._plan_buckets(jleaves, bucket_bytes, s), name
    assert tcoll.DEFAULT_BUCKET_BYTES == jcoll.DEFAULT_BUCKET_BYTES


SHAPES = [("a", (10,), "float32"), ("b", (3000, 4), "float32"),
          ("c", (7,), "bfloat16"), ("d", (5, 5), "int8"),
          ("e", (20000,), "float32"), ("f", (3,), "int16"),
          ("g", (), "float32"), ("h", (33,), "int8")]


@pytest.mark.parametrize("bucket_bytes", [None, 4096])
def test_world2_psum_allgather_pmean(tmp_path, bucket_bytes):
    results = run_world("collectives_case", 2, tmp_path, SHAPES,
                        bucket_bytes)

    trees = [{n: t.to(torch.float32).numpy()
              for n, t in rank_tree(r, SHAPES).items()} for r in range(2)]
    f32 = [n for n, _, dt in SHAPES if dt == "float32"]
    for res in results:  # every rank holds the same result
        assert sorted(res["psum"]) == sorted(f32)
        for n in f32:
            np.testing.assert_array_equal(res["psum"][n],
                                          trees[0][n] + trees[1][n])
            np.testing.assert_array_equal(
                res["pmean"][n], (trees[0][n] + trees[1][n]) / 2)
        for n, shape, _ in SHAPES:
            got = res["allgather"][n]
            assert got.shape == (2,) + shape
            np.testing.assert_array_equal(got, np.stack([trees[0][n],
                                                         trees[1][n]]))


def test_world2_psum_decomposed(tmp_path):
    results = run_world("decomposed_case", 2, tmp_path, SHAPES)
    trees = [{n: t.numpy() for n, t in rank_tree(r, SHAPES).items()
              if t.dtype == torch.float32} for r in range(2)]
    for rank, res in enumerate(results):
        for bucket_bytes, got in res.items():
            assert sorted(got["psum"]) == sorted(trees[0])
            for n, x in trees[0].items():
                np.testing.assert_array_equal(got["psum"][n],
                                              x + trees[1][n])
                np.testing.assert_array_equal(got["input"][n],
                                              trees[rank][n])


def _payload(rank):
    rng = np.random.RandomState(rank)
    return {"w": rng.randn(2, 3).astype(np.float32),
            "n": {"b": np.full((5,), rank + 3, np.int16)},
            "a2a": (np.arange(2)[:, None] * 10 + rank
                    + np.zeros((2, 4))).astype(np.float32)}


def test_world2_nonblocking_collectives_match_jax(tmp_path, mesh2):
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    pays = [_payload(0), _payload(1)]
    results = run_world("icollectives_case", 2, tmp_path, pays)

    def glob(get):
        return jax.device_put(np.stack([get(p) for p in pays]),
                              NamedSharding(mesh2, P("ps")))

    tree = {"w": glob(lambda p: p["w"]),
            "n": {"b": glob(lambda p: p["n"]["b"])}}
    want = {}
    for name, post in (
            ("iallgather", lambda: jcoll.iallgather(tree, mesh2)),
            ("igather", lambda: jcoll.igather(tree, mesh2, root=1)),
            ("igather_root_only", lambda: jcoll.igather(
                tree, mesh2, root=1, root_only=True)),
            ("ibroadcast", lambda: jcoll.ibroadcast(tree, mesh2, root=1)),
            ("ialltoall", lambda: jcoll.ialltoall(
                {"x": glob(lambda p: p["a2a"])}, mesh2)),
            ("ireduce", lambda: jcoll.ireduce({"w": tree["w"]}, mesh2))):
        pending = post()
        out = jax.tree.map(np.asarray, pending.wait())
        want[name] = (out, sorted(pending.timings),
                      pending.timings["msg_bytes"])
    for rank, res in enumerate(results):
        for name, (out, keys, jbytes) in want.items():
            got = res[name]
            assert got["timings"] == keys, name
            # msg_bytes: the tree each caller passed — the global array
            # in the JAX package, this rank's payload here.
            assert got["msg_bytes"] * 2 == jbytes, name
            if name == "igather_root_only" and rank != 1:
                assert got["result"] is None  # only the root holds a stack
                continue
            if name == "ialltoall":
                out = {"x": out["x"][rank]}   # row r is rank r's result
            jl, tl = tree_leaves(out), tree_leaves(got["result"])
            assert len(jl) == len(tl), name
            for a, b in zip(jl, tl):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(a, b, err_msg=name)
        # No op writes the caller's payload.
        np.testing.assert_array_equal(res["input_after"]["w"],
                                      pays[rank]["w"])
