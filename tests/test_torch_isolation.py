"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
no quiet fall back to the CPU.

The name check matches the JAX package exactly or by its ``pytorch_ps_mpi_tpu.``
prefix: the port's own name, ``pytorch_ps_mpi_tpu_torch``, starts with
``pytorch_ps_mpi_tpu``.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import pytorch_ps_mpi_tpu_torch as port

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "pytorch_ps_mpi_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax")


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return (root in FORBIDDEN_ROOTS or module == "pytorch_ps_mpi_tpu"
            or module.startswith("pytorch_ps_mpi_tpu."))


def test_forbidden_name_check_tells_the_packages_apart():
    assert _forbidden("pytorch_ps_mpi_tpu")
    assert _forbidden("pytorch_ps_mpi_tpu.ops.codecs")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("pytorch_ps_mpi_tpu_torch")
    assert not _forbidden("pytorch_ps_mpi_tpu_torch.ops.codecs")


def test_import_pulls_in_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import pytorch_ps_mpi_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN_ROOTS!r} or m == 'pytorch_ps_mpi_tpu' or "
        "m.startswith('pytorch_ps_mpi_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('pytorch_ps_mpi_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_the_checks_cover_the_fleet_modules():
    """The import walk and the source scan reach the sharded fleet's
    modules (``shard/partition.py`` imports no JAX in the JAX package
    either, but the port keeps its own copy)."""
    import pkgutil

    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"shard/__init__.py", "shard/partition.py", "shard/router.py",
            "shard/fleet.py", "shard/hierarchy.py"} <= files
    walked = {m.name for m in pkgutil.walk_packages(port.__path__,
                                                     port.__name__ + ".")}
    assert {f"pytorch_ps_mpi_tpu_torch.shard.{m}"
            for m in ("partition", "router", "fleet", "hierarchy")} <= walked


def test_the_hierarchy_imports_no_jax_and_defaults_to_the_card():
    """``shard/hierarchy.py`` imports neither JAX nor the JAX package,
    directly or through what it imports, and its entry points raise
    without a card unless asked for the CPU."""
    tree = ast.parse((PKG / "shard" / "hierarchy.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module or "")
    assert imported and not any(_forbidden(n) for n in imported)
    code = ("import sys\n"
            "import pytorch_ps_mpi_tpu_torch.shard.hierarchy as h\n"
            "assert h.LocalAggregator and h.GroupWorker and h.Hierarchy\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN_ROOTS!r} or m == 'pytorch_ps_mpi_tpu' or "
            "m.startswith('pytorch_ps_mpi_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if not torch.cuda.is_available():
        from pytorch_ps_mpi_tpu_torch.shard import LocalAggregator

        with pytest.raises(port.PSRuntimeError, match="no CUDA device"):
            LocalAggregator([("w", np.zeros(2, np.float32))], group=0,
                            upstream=[("127.0.0.1", 1)], group_size=1)


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not _forbidden(name), f"{path}: imports {name}"


def test_the_multihost_modules_are_among_the_checked_sources():
    """The multihost slice's modules, and the bucket stream's, the
    nonblocking collectives' and the MoE's, are scanned by the import
    checks above (they walk every module of the package)."""
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"transport.py", "multihost_async.py", "utils/backoff.py",
            "utils/crc.py", "native/serializer.py",
            "ops/codecs.py", "parallel/overlap.py",
            "parallel/collectives.py", "models/moe.py"} <= names
    from pytorch_ps_mpi_tpu_torch.models import moe
    from pytorch_ps_mpi_tpu_torch.parallel import collectives, overlap

    assert hasattr(overlap, "make_async_bucket_step")
    assert hasattr(collectives, "PendingTree") and hasattr(moe, "MoEMLP")
    import pytorch_ps_mpi_tpu_torch.multihost_async as ma
    import pytorch_ps_mpi_tpu_torch.transport as tr

    assert ma.PROTOCOL_VERSION == 12 and hasattr(tr, "Session")


def test_the_serve_modules_are_among_the_checked_sources():
    """The serve tier's modules are scanned by the import checks above,
    and the reader and the front-end raise without a card unless asked
    for the CPU."""
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"serve/__init__.py", "serve/subscribe.py",
            "serve/infer.py"} <= names
    from pytorch_ps_mpi_tpu_torch import serve

    # The fleet's reader came with the fleet.
    assert serve.__all__ == ["Subscriber", "FleetSubscriber",
                             "InferenceFrontend", "InferRequest"]
    assert hasattr(serve, "FleetSubscriber")
    if not torch.cuda.is_available():
        from pytorch_ps_mpi_tpu_torch.models import TransformerLM, build_lm

        model = TransformerLM(vocab_size=8, d_model=8, n_heads=2,
                              n_layers=1, d_ff=8, max_len=8)
        with pytest.raises(port.PSRuntimeError, match="no CUDA device"):
            port.InferenceFrontend(model, build_lm(model))


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    with pytest.raises(port.PSRuntimeError, match="no CUDA device"):
        port.SGD([("w", torch.zeros(3))], lr=0.1)
    with pytest.raises(port.PSRuntimeError, match="no CUDA device"):
        port.SGD([("w", torch.zeros(3))], lr=0.1, device="cuda")
    with pytest.raises(port.PSRuntimeError, match="no CUDA device"):
        port.make_ps_group("cuda")


def test_unported_codec_raises():
    """Every codec name of the JAX package resolves in the port; a name
    neither package has raises.  The mesh options are ported: without a
    mesh the step's default one (``("ps",)`` over the world) is used, and
    a ``batch_spec`` naming an axis it lacks is refused, not run
    dense."""
    for name in ("identity", "bf16", "topk", "topk_approx", "quantize",
                 "sign", "blockq"):
        assert isinstance(port.get_codec(name), port.Codec)
    with pytest.raises(ValueError, match="unknown codec"):
        port.get_codec("nope")
    with pytest.raises(ValueError, match="'sp', not in mesh axes"):
        port.SGD([("w", np.zeros(3, np.float32))], device="cpu",
                 batch_spec=("ps", "sp"))


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """No result line from the smoke script without a card, nor from a
    directory that holds the script and nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    for cwd in (REPO, tmp_path):
        if cwd is tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path)
        env = dict(os.environ, PYTHONPATH="")
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
