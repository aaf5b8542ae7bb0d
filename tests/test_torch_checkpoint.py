"""On-disk checkpoints of the port: its copy of the native serializer and
`utils.checkpoint`, against the JAX package's.

* The buffer frames (``PSZ2``: shuffle, LZ, crc32) are byte for byte the
  JAX package's for the same arrays, at levels 0 and 1, leaf by leaf and
  as the batched tree encode writes them.
* The port's tree frame (``PSTP``, its structure as plain data) round-trips
  its own trees; a file the JAX package wrote (``PST2``: a pickled JAX
  PyTreeDef) is refused with the error that names the way across, and
  the way across works: the JAX package reads its file,
  `utils.interop.state_from_jax` converts the state, the port saves it
  and reads it back exactly.
* An optimizer checkpoint restores bitwise: a run saved, restored into a
  fresh optimizer and continued equals the run that never stopped (blockq
  with error feedback, ZeRO and EMA on the narrow ResNet, on the CPU).
* Retention (step-tagged siblings, keep-last-K, RESUMABLE markers) acts
  on a directory as the JAX package's does.
"""

import os
import pickle
import zlib
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu import models as jmodels
from pytorch_ps_mpi_tpu.native import serializer as jser
from pytorch_ps_mpi_tpu.parallel.mesh import make_ps_mesh
from pytorch_ps_mpi_tpu.utils import checkpoint as jckpt
from pytorch_ps_mpi_tpu_torch import SGD
from pytorch_ps_mpi_tpu_torch import models as tmodels
from pytorch_ps_mpi_tpu_torch.native import serializer as tser
from pytorch_ps_mpi_tpu_torch.utils import checkpoint as tckpt
from pytorch_ps_mpi_tpu_torch.utils import interop
from pytorch_ps_mpi_tpu_torch.utils.crc import fast_crc32


def _frame_arrays():
    rng = np.random.RandomState(0)
    bf16 = torch.from_numpy(rng.randn(3000).astype(np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()  # bf16 values, as f32
    return {
        "f32": rng.randn(64, 129).astype(np.float32),
        "bf16_as_f32": bf16,
        "int8": rng.randint(-128, 128, 5000).astype(np.int8),
        "empty": np.zeros((0, 7), np.float32),
        "scalar": np.asarray(3, np.int32),
        "zeros": np.zeros(70000, np.float32),  # LZ shrinks it
    }


@pytest.mark.parametrize("level", [0, 1])
def test_buffer_frames_match_jax_bitwise(level):
    arrays = _frame_arrays()
    for name, a in arrays.items():
        assert tser.compress(a, level=level) == \
            jser.compress(a, level=level), name
        np.testing.assert_array_equal(
            tser.decompress(jser.compress(a, level=level)).view(a.dtype),
            a.reshape(-1))
    leaves = list(arrays.values())
    assert bytes(tser._encode_frames(leaves, level)) == \
        bytes(jser._encode_frames(leaves, level))
    big = np.random.RandomState(1).bytes(1 << 16)
    assert fast_crc32(big) == zlib.crc32(big)
    assert fast_crc32(big[100:], zlib.crc32(big[:100])) == zlib.crc32(big)


@pytest.mark.parametrize("level", [0, 1])
def test_tree_round_trip(level):
    rng = np.random.RandomState(2)
    tree = {"params": OrderedDict([("b", rng.randn(3).astype(np.float32)),
                                   ("a", rng.randn(4, 5).astype(np.float32))]),
            "state": {"z": {"step": np.asarray(7, np.int32)},
                      "y": [rng.randint(0, 9, 6).astype(np.int64),
                            (np.zeros((0,), np.float32), None)]},
            "ef": None, "n": 5}
    blob = tser.dumps(tree, level=level, meta={"step": 3, "extra": {"k": [1]}})
    assert blob[:4] == b"PSTP"
    back, meta = tser.loads(blob, with_meta=True)
    assert meta == {"step": 3, "extra": {"k": [1]}}
    assert type(back["params"]) is OrderedDict
    assert list(back["params"]) == ["b", "a"]
    assert back["ef"] is None and isinstance(back["state"]["y"][1], tuple)
    assert back["state"]["y"][1][1] is None
    flat_in, spec_in = tser.tree_spec(tree)
    flat_out, spec_out = tser.tree_spec(back)
    assert spec_in == spec_out
    for a, b in zip(flat_in, flat_out):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_jax_written_file_is_refused_with_the_way_across(tmp_path):
    path = str(tmp_path / "jax.psz")
    jckpt.save(path, {"w": np.ones(3, np.float32)})
    with open(path, "rb") as f:
        assert f.read(4) == b"PST2"
    with pytest.raises(tckpt.CheckpointError) as e:
        tckpt.load(path)
    msg = str(e.value)
    assert "written by the JAX package" in msg
    assert "state_from_jax" in msg and "save_optimizer" in msg
    assert "corrupt" not in msg
    with pytest.raises(tser.ForeignTreeFrameError):
        tser.loads(open(path, "rb").read())


def test_corrupt_or_foreign_files_raise_checkpoint_error(tmp_path):
    path = str(tmp_path / "c.psz")
    tckpt.save(path, {"w": np.arange(4000, dtype=np.float32)})
    blob = bytearray(open(path, "rb").read())
    for cut in (bytes(blob[:len(blob) // 2]),
                bytes(blob[:-3000]) + b"x" * 3000):
        with open(path, "wb") as f:
            f.write(cut)
        with pytest.raises(tckpt.CheckpointError, match="corrupt"):
            tckpt.load(path)
    blob[30] ^= 1  # inside the metadata
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(tckpt.CheckpointError, match="crc32"):
        tckpt.load(path)
    tckpt._atomic_write(path, tser.dumps({"w": np.zeros(2)},
                                          meta={"format_version": 9}))
    with pytest.raises(tckpt.CheckpointError, match="format version"):
        tckpt.load(path)
    tckpt.save(path, {"w": np.zeros(2)})
    with pytest.raises(tckpt.CheckpointError, match="not an optimizer"):
        tckpt.load_optimizer(path, SGD([("w", np.zeros(2, np.float32))],
                                       device="cpu"))


def test_meta_must_be_plain_data():
    with pytest.raises(ValueError, match="restricted"):
        tser.dumps({"w": np.zeros(2)}, meta={"bad": np.float32(1.0)})
    # A file whose metadata names a global outside the allowlist (written
    # by hand here: `dumps` refuses to) is refused on read.
    good = tser.dumps({"w": np.zeros(2)}, meta={"ok": 1.0})
    _, meta_len, _ = tser._TREE_HDR.unpack_from(good, 0)
    md = tser._restricted_loads(good[tser._TREE_HDR.size:
                                     tser._TREE_HDR.size + meta_len])
    md["user"] = {"ok": np.float32(1.0)}
    bad = pickle.dumps(md, protocol=pickle.HIGHEST_PROTOCOL)
    blob = (tser._TREE_HDR.pack(b"PSTP", len(bad), zlib.crc32(bad)) + bad
            + good[tser._TREE_HDR.size + meta_len:])
    with pytest.raises(pickle.UnpicklingError, match="allowlist"):
        tser.loads(blob, with_meta=True)


def _narrow_resnet(seed=1):
    jmodel = jmodels.ResNet((1, 1), num_classes=10, dtype=jnp.float32)
    named, aux = jmodels.build_model(jmodel, (1, 8, 8, 3), seed=seed)
    return jmodel, {n: np.asarray(p) for n, p in named.items()}, aux


def _batches(n):
    rng = np.random.RandomState(0)
    return [{"x": rng.randn(4, 8, 8, 3).astype(np.float32),
             "y": rng.randint(0, 10, 4).astype(np.int32)} for _ in range(n)]


def _port_opt(tparams, taux, **options):
    model = tmodels.ResNet((1, 1), num_classes=10)
    loss_fn, _ = tmodels.make_classifier_loss(model)
    opt = SGD(list(tparams.items()), lr=0.1, momentum=0.9, device="cpu",
              **options)
    opt.compile_step(loss_fn, has_aux=True, aux=taux)
    return opt


@pytest.mark.parametrize("raw_shards", [False, True])
def test_optimizer_checkpoint_resumes_bitwise(tmp_path, raw_shards):
    _, named, aux = _narrow_resnet()
    tparams, taux = interop.params_from_jax(named, aux)
    options = dict(code="blockq", error_feedback=True, zero=True,
                   ema_decay=0.9)
    batches = _batches(5)
    ref = _port_opt(tparams, taux, **options)
    for b in batches:
        ref.step(b)
    a = _port_opt(tparams, taux, **options)
    for b in batches[:3]:
        a.step(b)
    path = str(tmp_path / "opt.psz")
    tckpt.save_optimizer(path, a, step=3, extra={"loader": {"epoch": 1}},
                         raw_shards=raw_shards)
    b_opt = _port_opt(tparams, taux, **options)
    info = tckpt.load_optimizer(path, b_opt, min_step=3)
    assert info == {"step": 3, "extra": {"loader": {"epoch": 1}}}
    for b in batches[3:]:
        b_opt.step(b)
    for n in ref.params:
        np.testing.assert_array_equal(b_opt.params[n].numpy(),
                                      ref.params[n].numpy(), err_msg=n)
        np.testing.assert_array_equal(b_opt.ema_params[n].numpy(),
                                      ref.ema_params[n].numpy(), err_msg=n)
    for n in ref.aux:
        np.testing.assert_array_equal(b_opt.aux[n].numpy(),
                                      ref.aux[n].numpy(), err_msg=n)
    with pytest.raises(tckpt.CheckpointError, match="rewind"):
        tckpt.load_optimizer(path, b_opt, min_step=4)


def test_state_crosses_from_a_jax_file(tmp_path):
    """The way across: a JAX checkpoint read by the JAX package, converted
    by `state_from_jax`, loaded into the port's optimizer and saved by the
    port, reads back into a fresh port optimizer exactly.  A raw ZeRO
    shard stays refused across packages."""
    jmodel, named, aux = _narrow_resnet(seed=2)
    loss_fn, _ = jmodels.make_classifier_loss(jmodel, has_aux=True)
    jopt = JSGD(list(named.items()), lr=0.1, momentum=0.9,
                mesh=make_ps_mesh(1), code="blockq", error_feedback=True,
                ema_decay=0.9)
    jopt.compile_step(loss_fn, has_aux=True, aux=aux)
    for b in _batches(2):
        jopt.step(b)
    jpath, tpath = str(tmp_path / "j.psz"), str(tmp_path / "t.psz")
    jckpt.save_optimizer(jpath, jopt, step=2, extra={"note": "jax"})

    arrays, meta = jckpt.load(jpath, with_meta=True)
    sd = interop.state_from_jax({**meta["state_dict_meta"], **arrays})
    tparams, taux = interop.params_from_jax(named, aux)
    opt = _port_opt(tparams, taux, code="blockq", error_feedback=True,
                    ema_decay=0.9)
    opt.load_state_dict(sd)
    tckpt.save_optimizer(tpath, opt, step=meta["step"], extra=meta["extra"])
    fresh = _port_opt(tparams, taux, code="blockq", error_feedback=True,
                      ema_decay=0.9)
    assert tckpt.load_optimizer(tpath, fresh) == {"step": 2,
                                                  "extra": {"note": "jax"}}
    for n, p in sd["params"].items():
        np.testing.assert_array_equal(fresh.params[n].numpy(), p)
        np.testing.assert_array_equal(
            fresh.state[n]["momentum_buffer"].numpy(),
            sd["state"][n]["momentum_buffer"])
        np.testing.assert_array_equal(fresh.ema_params[n].numpy(),
                                      sd["ema"][n])
        np.testing.assert_array_equal(fresh.extras["ef"][n].numpy(),
                                      sd["ef"][n])
    for n, a in sd["aux"].items():
        np.testing.assert_array_equal(fresh.aux[n].numpy(), a)

    zopt = JSGD(list(named.items()), lr=0.1, momentum=0.9,
                mesh=make_ps_mesh(2), zero=True)
    zopt.compile_step(loss_fn, has_aux=True, aux=aux)
    jckpt.save_optimizer(jpath, zopt, step=0, raw_shards=True)
    arrays, meta = jckpt.load(jpath, with_meta=True)
    with pytest.raises(ValueError, match="raw ZeRO shard"):
        interop.state_from_jax({**meta["state_dict_meta"], **arrays})


def test_retention_matches_jax(tmp_path):
    """Step-tagged paths, keep-last-K collection that spares the newest
    and any RESUMABLE file, and resume-target resolution, on two equal
    directories, one per package."""
    dirs = {}
    for tag, mod in (("j", jckpt), ("t", tckpt)):
        d = tmp_path / tag
        d.mkdir()
        base = str(d / "ck.psz")
        assert mod.latest_checkpoint(base) is None
        for s in (2, 4, 6, 8, 10):
            open(mod.step_path(base, s), "w").close()
        mod.mark_resumable(mod.step_path(base, 4), {"step": 4})
        gone = mod.gc_step_checkpoints(base, keep_last=2)
        dirs[tag] = ([os.path.basename(p) for p in gone],
                     [(s, os.path.basename(p))
                      for s, p in mod.list_step_checkpoints(base)],
                     os.path.basename(mod.latest_checkpoint(base)),
                     mod.is_resumable(mod.step_path(base, 4)))
        mod.clear_resumable(mod.step_path(base, 4))
        assert not mod.is_resumable(mod.step_path(base, 4))
        open(base, "w").close()
        assert mod.latest_checkpoint(base) == base
        with pytest.raises(ValueError):
            mod.gc_step_checkpoints(base, keep_last=0)
    assert dirs["t"] == dirs["j"]
    assert dirs["t"][0] == ["ck.step00000002.psz", "ck.step00000006.psz"]
    assert tckpt.step_path("a/ck.psz", 12) == "a/ck.step00000012.psz"


@pytest.mark.parametrize("name", ["ps_serial.cpp", "ps_loader.cpp"])
def test_native_sources_are_the_jax_packages_code(name):
    """The port's C++ is a copy: with ``//`` comment lines set aside, each
    source equals the JAX package's line for line."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent

    def code(pkg):
        text = (root / pkg / "native" / "src" / name).read_text()
        return [ln for ln in text.splitlines()
                if not ln.lstrip().startswith("//")]

    port, jax_src = code("pytorch_ps_mpi_tpu_torch"), code("pytorch_ps_mpi_tpu")
    assert len(port) > 40 and port == jax_src
