"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names compared
whole (the program's name begins with the JAX package's)."""
import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add("." if node.level else node.module.split(".")[0])
    return roots


def test_benchmark_imports_no_jax_and_no_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    bad = {str(p.relative_to(HERE)): sorted(imported_roots(p)
                                            & (FORBIDDEN | {"."}))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    files = sorted((HERE / "reference").rglob("*.py"))
    assert files
    for p in files:
        assert not imported_roots(p) & {"repro_torch", "perfbench"}, p


def test_whole_name_comparison(tmp_path):
    """`repro_torch` is the program, not the JAX package: the comparison
    takes the whole first name, never a prefix."""
    src = "import repro_torch.core\nfrom repro_torch import kernels\n"
    p = tmp_path / "probe.py"
    p.write_text(src)
    assert imported_roots(p) & FORBIDDEN == set()
    p.write_text("import repro.core\n")
    assert imported_roots(p) & FORBIDDEN == {"repro"}
