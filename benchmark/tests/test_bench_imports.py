"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX
package (top-level names compared whole: the program's name begins with
the JAX package's), and the reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "esn_ofdm_mimo_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_import(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = BENCH / "reference"
    for p in ref.rglob("*.py"):
        assert "esn_ofdm_mimo_tpu_torch" not in _top_level_imports(p), p
        assert "esn_ofdm_mimo_tpu_torch" not in p.read_text(), p


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference as r\n"
            "import benchmark.reference.chain.pipelines.cdl\n"
            "import benchmark.reference.chain.pipelines.blockfading\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'esn_ofdm_mimo_tpu_torch', 'jax', 'jaxlib',\n"
            "                'flax', 'esn_ofdm_mimo_tpu'})\n"
            "assert not bad, bad\n") % str(BENCH.parent)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_harness_refuses_forbidden_modules(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "esn_ofdm_mimo_tpu_torch_x",
                        sys.modules[__name__])
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules[__name__])
    assert run.forbidden_modules() == ["jax"]
