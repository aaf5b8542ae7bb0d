"""What the benchmark imports, compared by the top-level name (the part
before the first dot) as a whole: the port's name begins with the JAX
package's, so a prefix test would be wrong both ways."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import run

HERE = Path(run.__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "optax", "pytorch_ps_mpi_tpu"}
PORT = "pytorch_ps_mpi_tpu_torch"
SOURCES = sorted(HERE.rglob("*.py"))
# The harness's own modules (the tests plant faults in the port).
HARNESS = [p for p in SOURCES if p.relative_to(HERE).parts[0] != "tests"]


def top_level_imports(path: Path) -> "set[str]":
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    found = top_level_imports(path)
    assert PORT not in found and "port_bench" not in found
    # relative imports stay inside the reference package
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, ast.dump(node)


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(
    HERE)))
def test_only_the_program_and_the_families_import_the_port(path):
    rel = path.relative_to(HERE)
    if PORT in top_level_imports(path):
        assert rel == Path("program.py") or rel.parts[0] == "families"


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pytorch_ps_mpi_tpu_torch_x", sys)
    assert "pytorch_ps_mpi_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pytorch_ps_mpi_tpu.models", sys)
    assert run.forbidden_modules() == ["pytorch_ps_mpi_tpu"]


def test_loaded_modules_of_a_cpu_run():
    """A run's modules: the harness with the port loads no JAX; the
    reference and the comparison alone, each family's reference model
    among them, load nothing of the port, nor does finding a family (it
    imports the port only to build or bind)."""
    code = (
        "import sys; import port_bench.reference, port_bench.check;"
        "from port_bench import spec;"
        "[port_bench.reference.model(m) for m in ('lm', 'resnet18')];"
        "[spec.family(m) for m in ('lm', 'resnet18')];"
        "assert not [m for m in sys.modules if m.split('.')[0] == "
        f"'{PORT}'], 'reference loaded the port';"
        "from port_bench import run, harness, program;"
        "program.build_model({'model': 'lm', 'compute_dtype': 'float32',"
        "'vocab_size': 8, 'd_model': 4, 'n_heads': 1, 'n_layers': 1,"
        "'d_ff': 8, 'max_len': 4});"
        "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=HERE.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_exits_nonzero_and_prints_no_result(tmp_path):
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "gpt2m-blockq-b16x1024", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=HERE.parent,
        env=env, timeout=120)
    assert out.returncode == run.NO_CARD
    assert "{" not in out.stdout
