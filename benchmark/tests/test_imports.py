"""Nothing the benchmark runs imports JAX or the JAX package; the reference
imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark.harness import files

JAX = {"jax", "jaxlib", "flax", "twoforone_tpu"}


def imported_top_levels(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def modules(folder: str) -> list:
    return [os.path.join(d, f) for d, _, fs in os.walk(folder) for f in fs if f.endswith(".py")]


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: imported_top_levels(p) & JAX for p in modules(files.BENCH)}
    assert not {p: n for p, n in found.items() if n}


def test_the_reference_imports_nothing_of_the_program():
    folder = os.path.join(files.BENCH, "reference")
    found = {p: imported_top_levels(p) & (JAX | {"twoforone_torch", "benchmark"})
             for p in modules(folder)}
    assert not {p: n for p, n in found.items() if n}


def test_the_scan_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import twoforone_torch.ops\nimport jaxtyping\nfrom flax import linen\n")
    assert imported_top_levels(str(p)) & JAX == {"flax"}


def test_a_run_loads_no_jax(tiny_bench):
    code = ("import sys, time, torch; sys.path.insert(0, {root!r}); "
            "from benchmark.harness import runner; "
            "runner.run('chignolin.langevin.1000', 5, 0.1, False, torch.device('cpu'), "
            "time.time(), bench={bench!r}); print(runner.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code.format(root=files.ROOT, bench=tiny_bench)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
