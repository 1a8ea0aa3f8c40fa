"""What the benchmark loads: no JAX module in the run's process (top-level
names compared whole, so the port ``transformer_mm_explainability_tpu_torch``
is not taken for the JAX package), nothing of the port in the references,
and no result without a card."""

import ast
import pathlib
import subprocess
import sys

from portbench.core import cell, spec

ROOT = spec.ROOT
PB = ROOT / "portbench"


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_jax_names_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["transformer_mm_explainability_tpu_torch_x"] = sys
        sys.modules["jaxish"] = sys
        assert "transformer_mm_explainability_tpu_torch_x" not in \
            cell.jax_modules()
        sys.modules["jaxlib.xla"] = sys
        assert "jaxlib.xla" in cell.jax_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """Everything run.py imports, every driver, metric, reference and work
    count, and a whole tiny run of every cell."""
    code = f"""
import sys, runpy
sys.path.insert(0, {str(ROOT)!r})
sys.argv = ["run.py", "--help"]
try:
    runpy.run_path({str(PB / "run.py")!r}, run_name="__main__")
except SystemExit:
    pass
from portbench.core import cell, spec
from portbench.tests import tiny
for w in spec.benchmark()["workloads"]:
    c = spec.cell(w["name"])
    spec.task(c.config, c.mix)
    for m in c.per_layer:
        spec.metric_reader(m["name"])
    tiny.run(w["name"], seconds=0.05)
import portbench.flops.vit, portbench.flops.visual_bert
print("LOADED", cell.jax_modules())
"""
    done = _python(code)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "LOADED []" in done.stdout


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_port():
    bad = ("transformer_mm_explainability_tpu", "jax", "jaxlib", "flax")
    for path in sorted((PB / "reference").glob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in bad, (path, name)
            if name.startswith("portbench"):
                assert name.split(".")[1] in ("core", "reference"), name
    done = _python(f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import portbench.reference.vit, portbench.reference.visual_bert
print("PORT", sorted(m for m in sys.modules
                     if m.split(".")[0].startswith("transformer_mm")))
""")
    assert "PORT []" in done.stdout, done.stderr[-2000:]


def test_no_result_without_a_card(tmp_path):
    """No CUDA here: exit not 0 and nothing on standard output, in the
    checkout and in a directory holding only BENCHMARK.json and portbench/
    (nothing of the program)."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, tmp_path):
        done = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "vit_b16.explain_b32", "--seed", str(2 ** 33 + 1), "--seconds",
             "1", "--trace", "0"], cwd=where, capture_output=True, text=True,
            timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert done.returncode != 0 and done.stdout.strip() == "", where
