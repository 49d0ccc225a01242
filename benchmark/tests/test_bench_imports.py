"""Nothing of the benchmark imports JAX, flax or the JAX package, and the
plain references import nothing of the program. Module names are compared
whole at their top level: the program's package name begins with the JAX
package's."""

import ast
import sys
from pathlib import Path

from benchmark import harness

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "frame2frame_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(HERE.rglob("*.py"))


def test_no_module_of_the_benchmark_imports_jax():
    found = {str(p.relative_to(HERE)): top_level_imports(p) & FORBIDDEN
             for p in sources()}
    assert not {k: v for k, v in found.items() if v}


def test_the_references_import_nothing_of_the_program():
    for p in sorted((HERE / "reference").glob("*.py")):
        names = top_level_imports(p)
        assert "frame2frame_tpu_torch" not in names, p
        assert not names & FORBIDDEN, p


def test_whole_names_are_compared(monkeypatch):
    # the program's own top-level name is allowed; the JAX package's is not
    monkeypatch.setitem(sys.modules, "frame2frame_tpu_torch_probe", object())
    assert "frame2frame_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "frame2frame_tpu.probe", object())
    assert "frame2frame_tpu" in harness.forbidden_modules()


def test_the_harness_core_names_no_cell_configuration_or_metric():
    spec = harness.load_spec()
    names = ([w["name"] for w in spec["workloads"]]
             + [c["name"] for c in spec["configs"]]
             + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
             + [w["traffic"] for w in spec["workloads"]])
    for f in ("run.py", "harness.py", "trace.py", "reduce.py"):
        text = (HERE / f).read_text()
        assert not [n for n in names if n in text and n != "setup_s"], f
