"""Nothing the benchmark loads is JAX or the JAX package, compared by the
whole top-level name (``tpu_pathopt_torch`` is not ``tpu_pathopt``), and the
plain reference loads nothing of the program."""

import subprocess
import sys

from h100_bench.core import manifest

HARNESS = ["h100_bench.core.check", "h100_bench.core.manifest",
           "h100_bench.core.port", "h100_bench.core.spans",
           "h100_bench.core.trace", "h100_bench.core.card",
           "h100_bench.core.traffic", "h100_bench.gen.scenarios"]
REFERENCE = ["h100_bench.reference.pipeline", "h100_bench.reference.qp",
             "h100_bench.reference.compare", "h100_bench.reference.config",
             "h100_bench.core.check", "h100_bench.core.traffic"]


def top_level_modules(code: str) -> set:
    """The top-level names in ``sys.modules`` after running ``code`` in a
    fresh interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=manifest.ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_the_run_loads_no_jax():
    files = [p for c in manifest.load()["workloads"] for p in
             (manifest.cell_files(manifest.load(), c["name"])["driver"],
              *manifest.cell_files(manifest.load(), c["name"])[
                  "metrics"].values())]
    code = "\n".join(
        ["import sys", "sys.path.insert(0, '.')", "import runpy",
         "runpy.run_path('h100_bench/run.py', run_name='bench_run')",
         "from h100_bench.core import manifest"]
        + [f"import {m}" for m in HARNESS]
        + [f"manifest.module(__import__('pathlib').Path({str(p)!r}))"
           for p in sorted(set(files))])
    found = top_level_modules(code)
    assert "tpu_pathopt_torch" in found
    assert not found & {"jax", "jaxlib", "flax", "tpu_pathopt"}, found


def test_the_reference_loads_nothing_of_the_program():
    code = "\n".join(["import sys", "sys.path.insert(0, '.')"]
                     + [f"import {m}" for m in REFERENCE]
                     + ["import runpy",
                        "runpy.run_path('h100_bench/control.py', "
                        "run_name='control')"])
    found = top_level_modules(code)
    assert "scipy" in found
    assert not found & {"tpu_pathopt_torch", "torch", "jax", "jaxlib",
                        "flax", "tpu_pathopt"}, found


def test_the_forbidden_check_compares_whole_names():
    import runpy

    import tpu_pathopt_torch  # noqa: F401
    run = runpy.run_path(str(manifest.HERE / "run.py"), run_name="bench_run")
    assert "tpu_pathopt" not in run["forbidden_modules"]()
