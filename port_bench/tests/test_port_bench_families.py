"""Model families found by name: the two families give what the harness
gave before they were files of their own, a family is added by files
alone, and a model with no family is refused, naming what is missing."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from port_bench import data, flops, program, reference, spec
from port_bench.families import lm
from port_bench.tests.test_port_bench_cpu import SEED, tiny_cell

# Read from commit ce43a88's code, where the two families' code still sat
# in program.py, data.py, flops.py and reference/__init__.py: one rank's
# step FLOPs, a global batch's items and the SHA-256 of the JSON list of
# leaf sizes, at the cells' full sizes (built on the meta device) ...
FULL = {
    "gpt2m-blockq-b16x1024": (
        37222166298624.0, 16384,
        "87bab3d1878391f8cf3c391074f68458bddce9379917df42a23ec1131cc97e69"),
    "r18-blockq-b2048": (
        6825034383360.0, 2048,
        "464ea08062db0ea33de1653eef7bbbda517c4a9c4ec7a064ff7b9203b11f9192"),
}
# ... and at the CPU tests' tiny sizes (`tiny_cell`, seed `SEED`), on one
# thread: the SHA-256 of the weights' bytes in leaf order and of the
# first global batch's by key, the plain reference's three losses, and
# the SHA-256 of its first decoded gradient's norms (float64, leaf order).
TINY = {
    "lm": {
        "weights": "c6f3c2b90f559f014e35fa545c27d9dc"
                   "f2b33cce1c9745cf2e071949ef2a2a17",
        "batch": "911aec4b959207ba5b9acd9cb31ea27d"
                 "22d60fa02e04cafd0d84c9c19a09102b",
        "losses": [4.986861228942871, 4.713099956512451,
                   4.602909564971924],
        "grad_norms": "d735532be6b7d6281849808041c7e300"
                      "df90bd6de83b720d3b3b0413c3fd3c93"},
    "resnet18": {
        "weights": "fb6730c85313f74f1c25a026896e68f2"
                   "64ebb4a3caecddcdf9029c74f550378f",
        "batch": "bd7cf8d2b8f1b5f223e568858d94fbbc"
                 "bcc83b4667e85cc7cbd486cf4f8c3280",
        "losses": [2.1226274967193604, 1.2949298620224,
                   3.0641050338745117],
        "grad_norms": "accc3525b63496f11eb7357317190e19"
                      "6586607b5449463b15d07cb4d002767e"},
}


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_size_counts_are_unchanged(name):
    cell = spec.load_cell(name)
    family = spec.family(cell.config["model"])
    _, shapes, _ = program.build_model(cell.config)
    sizes = flops.leaf_sizes(shapes)
    step_flops, items, digest = FULL[name]
    assert family.step_flops(cell.config, cell.traffic) == step_flops
    assert family.items_per_batch(cell.traffic) == items
    assert len(sizes) == cell.config["tensors"]
    assert sum(sizes) == cell.config["parameters"]
    assert hashlib.sha256(json.dumps(sizes).encode()).hexdigest() == digest


@pytest.mark.parametrize("model", sorted(TINY))
def test_weights_batches_and_reference_are_unchanged(model):
    cell = tiny_cell(model)
    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    # The reference's sums on the CPU depend on the thread count.
    torch.set_num_threads(1)
    try:
        _, shapes, _ = program.build_model(cell.config)
        weights = data.init_weights(shapes, cell.config, SEED, cpu)
        pool = spec.family(model).batch_pool(cell.traffic, cell.config,
                                             SEED, cpu)
        ref = reference.run(cell.config, cell.traffic, weights, pool[:3],
                            steps=3)
    finally:
        torch.set_num_threads(threads)
    want = TINY[model]
    assert _sha(weights.values()) == want["weights"]
    assert _sha(pool[0][k] for k in sorted(pool[0])) == want["batch"]
    assert ref["losses"] == want["losses"]
    norms = torch.tensor(list(ref["grad_norms"].values()),
                         dtype=torch.float64)
    assert _sha([norms]) == want["grad_norms"]


def test_a_family_states_a_leaf_fan_in(monkeypatch):
    """A family's ``fan_in`` sets a kernel's scale; the draw is the same."""
    cell = tiny_cell("lm")
    _, shapes, _ = program.build_model(cell.config)
    cpu = torch.device("cpu")
    plain = data.init_weights(shapes, cell.config, SEED, cpu)
    monkeypatch.setattr(lm, "fan_in", lambda name, shape: 4 * shape[1],
                        raising=False)
    quartered = data.init_weights(shapes, cell.config, SEED, cpu)
    for n, w in plain.items():
        if n.endswith("qkv.weight"):
            torch.testing.assert_close(quartered[n], w / 2, rtol=1e-6,
                                       atol=0)
        elif n.endswith("_embed.weight") or w.dim() < 2:
            assert torch.equal(quartered[n], w), n


def _copy(tmp_path):
    """A copy of the benchmark's package and ``BENCHMARK.json``, and the
    bytes of every file in it."""
    root = tmp_path / "port_bench"
    shutil.copytree(spec.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    return root, {p: p.read_bytes() for p in tmp_path.rglob("*")
                  if p.is_file()}


def _write(root, kind: str, name: str, obj: dict) -> None:
    (root / kind / f"{name}.json").write_text(json.dumps(obj))


def _tiny_files(root, model: str, name: str) -> None:
    """A tiny LM cell ``name`` of the model ``model``: its configuration,
    traffic and workload files, with the limits of the LM's cell."""
    cell = tiny_cell("lm")
    _write(root, "configs", name, {**cell.config, "model": model,
                                   "name": name})
    _write(root, "traffic", name, {**cell.traffic, "model": model})
    _write(root, "workloads", name, {
        "name": name, "config": name, "traffic": name, "chips": 1,
        "why": "a test cell", "limits": cell.limits})


def test_a_family_is_added_by_files_alone(tmp_path):
    """In a copy of the package, a second name for the LM (its program
    side and its reference copied under ``lm_twin``) with a configuration,
    traffic and a cell of its own runs set-up, window, the reference and
    the comparison on the CPU, and comes out correct; no file of the copy
    changes."""
    root, before = _copy(tmp_path)
    for part in ("families", "reference"):
        shutil.copy(root / part / "lm.py", root / part / "lm_twin.py")
    _tiny_files(root, "lm_twin", "twin-tiny")
    code = textwrap.dedent(f"""
        import argparse, json
        from port_bench import run, spec
        cell = spec.load_cell("twin-tiny")
        args = argparse.Namespace(workload=cell.name, seed={SEED},
                                  seconds=0.2, trace=0)
        res = run.run_world(args, cell, "cpu")
        print(json.dumps({{"package": spec.__file__,
                          "correct": res["correct"],
                          "compared": res["compared"],
                          "items": res["rec"]["items_per_step"],
                          "flops": res["rec"]["step_flops"]}}))
        """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(spec.ROOT)]), TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["package"].startswith(str(root))
    assert got["correct"], got["compared"]
    traffic = tiny_cell("lm").traffic
    assert got["items"] == lm.items_per_batch(traffic)
    assert got["flops"] == lm.step_flops(tiny_cell("lm").config, traffic)
    for path, data_ in before.items():
        assert path.read_bytes() == data_, path
    with pytest.raises(spec.SpecError):
        spec.check_family("lm_twin")   # nothing of it reached the repo


def test_an_unknown_model_is_refused_naming_its_files(tmp_path):
    with pytest.raises(spec.SpecError) as err:
        spec.family("no_such_model")
    assert "families/no_such_model.py" in str(err.value)
    assert "reference/no_such_model.py" in str(err.value)
    with pytest.raises(ValueError, match="reference/no_such_model.py"):
        reference.model("no_such_model")
    with pytest.raises(spec.SpecError, match="bad model name"):
        spec.family("../lm")
    root, _ = _copy(tmp_path)
    (root / "families" / "half.py").write_text('"""No reference."""\n')
    _tiny_files(root, "half", "half-tiny")
    with pytest.raises(spec.SpecError) as err:
        spec.load_cell("half-tiny", root)
    assert "reference/half.py" in str(err.value)
    assert "families/half.py" not in str(err.value)

