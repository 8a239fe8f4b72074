"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the system under test."""

import ast
import subprocess
import sys

from benchmark.harness.spec import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nerf_tpu")


def loaded_after(code: str) -> set:
    """Top-level module names loaded in a fresh process after ``code``."""
    probe = code + "\nimport sys\nprint(sorted({m.split('.', 1)[0] for m in sys.modules}))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(ast.literal_eval(out.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    tops = loaded_after(
        "import benchmark.run, benchmark.calibrate, benchmark.drivers.train, "
        "benchmark.drivers.render, benchmark.reference.nerf_plain\n"
        "from benchmark.harness import spec\n"
        "for m in spec.benchmark_spec()['per_layer']: spec.metric_reader(m['name'])\n"
        "for c in spec.benchmark_spec()['configs']:\n"
        "    t = spec.model_type(spec.load_json(c['file'])['models']['coarse']['type'])\n"
        "    t.plugin.train_counters(), t.plugin.render_counters()\n"
        "import nerf_tpu_torch.serve_nerf, nerf_tpu_torch.engine.train")
    assert "nerf_tpu_torch" in tops                  # compared whole: not nerf_tpu
    assert not tops.intersection(FORBIDDEN), tops.intersection(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_system():
    # Each model type's plain field, loaded as the harness loads it.
    tops = loaded_after(
        "import importlib.util, pathlib\n"
        "import benchmark.reference.nerf_plain\n"
        "for path in sorted(pathlib.Path('benchmark/reference/fields').glob('*.py')):\n"
        "    s = importlib.util.spec_from_file_location("
        "'benchmark.reference.fields.' + path.stem, path)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))")
    assert "nerf_tpu_torch" not in tops and not tops.intersection(FORBIDDEN)
    files = sorted((ROOT / "benchmark" / "reference").rglob("*.py"))
    assert ROOT / "benchmark/reference/fields/FlexibleNeRFModel.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
                assert node.level == 0 or not names[0].startswith(("drivers", "harness")), path
            for name in names:
                top = name.split(".", 1)[0]
                assert top not in FORBIDDEN + ("nerf_tpu_torch", "benchmark"), (path, name)


def test_the_guard_compares_whole_names(monkeypatch):
    from benchmark.harness import device

    monkeypatch.setitem(sys.modules, "nerf_tpu_torch_probe", object())
    assert device.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert device.forbidden_modules() == ["jax"]
