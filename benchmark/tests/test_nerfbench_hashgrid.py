"""The hash-grid field's model type (``HashGridNeRFModel``, configuration
``ngp_hash_l16``, cell ``ngp_train``): its plug-in's counts against hand
arithmetic, its seeding, its readers on a hand-made trace, and the cell run
on the CPU at cut sizes, laid as new files and entries over a checkout that
lacks them, as ``third_type/`` is."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark.drivers.common import program_config, seed_fields
from benchmark.harness import spec
from benchmark.harness import trace as tr
from benchmark.harness.spec import ROOT, load_json
from cpu_runs import cpu_run

TYPE = "HashGridNeRFModel"
CONFIG = load_json(ROOT / "benchmark/configs/ngp_hash_l16.json")
MODEL = CONFIG["models"]["coarse"]
ROWS = 4913 + 12167 + 29791 + 79507 + 205379 + 11 * 2 ** 19    # levels 0-4 dense, 5-15 hashed
# The type's files and entries, as this cell brought them.
NEW_FILES = ["configs/ngp_hash_l16.json", "models/HashGridNeRFModel.py",
             "reference/fields/HashGridNeRFModel.py", "workloads/ngp_train.json",
             "metrics/hashgrid_encode_roofline.py", "metrics/hashgrid_encode_ms.py",
             "metrics/launches_per_step.ngp_train.py", "metrics/device_idle_pct.ngp_train.py",
             "metrics/untraced_busy_pct.ngp_train.py", "metrics/host_rays_per_s.ngp_train.py"]
# The kernel pair's readers, then the step's readers of the cell's own.
KERNEL_METRICS = ("hashgrid_encode_roofline", "hashgrid_encode_ms")
STEP_METRICS = ("launches_per_step.ngp_train", "device_idle_pct.ngp_train",
                "untraced_busy_pct.ngp_train")
HOST_METRICS = ("host_rays_per_s.ngp_train",)
NEW_METRICS = KERNEL_METRICS + STEP_METRICS + HOST_METRICS


def plugin():
    return spec.model_type(TYPE).plugin


def test_counts_against_hand_arithmetic():
    p = plugin()
    assert p.table_rows(MODEL) == ROWS == 6_098_925
    # Density 32x64 + 64x16, colour 32x64 + 64x64 + 64x3.
    macs = 32 * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 3
    assert macs == 9408
    assert p.flops(MODEL, 10, False) == 2 * 10 * macs
    # Layer gradients: the features (32) and the density outputs (16) of the
    # colour layer's input need one, the harmonics none.
    grads_in = 32 * 64 + 64 * 16 + 16 * 64 + 64 * 64 + 64 * 3
    assert p.flops(MODEL, 10, True) == 2 * 10 * (2 * macs + grads_in)
    # The roofline's bytes: points (12) in and bf16 features (64) out a
    # point, the table (8 bytes a row) read once; the backward the points
    # and the features' gradient again, and no table-wide write.
    n = 1024 * 64
    one_way = n * (12 + 2 * 32) + 8 * ROWS
    assert p.encode_bytes(MODEL, n, False, "bfloat16") == one_way
    assert p.encode_bytes(MODEL, n, True, "bfloat16") == 2 * n * (12 + 2 * 32) + 8 * ROWS
    assert p.encode_bytes(MODEL, n, False, "float32") == n * (12 + 4 * 32) + 8 * ROWS
    assert p.nbytes(MODEL, 1024, n, False) == 4 * (3 * n + 3 * 1024 + macs + 2 * ROWS + 4 * n)


def fields():
    from nerf_tpu_torch.config import model_from_config

    cfg = program_config(CONFIG)
    return [model_from_config(cfg.models.coarse), model_from_config(cfg.models.fine)]


def test_every_leaf_is_seeded_and_the_tables_within_1e4():
    def seeded(seed):
        mods = fields()
        seed_fields(spec.model_type(TYPE), mods, seed, "cpu")   # raises on a leaf left NaN
        return mods, [p.detach().clone() for m in mods for p in m.parameters()]

    mods, first = seeded(2147483659)
    _, again = seeded(2147483659)
    _, other = seeded(2147483660)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(not torch.equal(a, b) for a, b in zip(first, other))
    for m in mods:
        assert m.table.abs().max() <= 1e-4 and m.table.abs().max() > 0.9e-4
        assert m.table.std() > 0.5e-4
        for layer in [*m.density_net, *m.color_net]:
            assert layer.weight.abs().max() <= layer.in_features ** -0.5
    # The coarse and the fine field differ.
    assert not torch.equal(mods[0].table, mods[1].table)


def chrome(window, device):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": window[0], "dur": window[1] - window[0]}]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": e - s} for n, s, e in device]
    return {"traceEvents": ev}


def test_readers_on_a_traced_step():
    # Two steps, each with 4 encodings (coarse and fine, forward and
    # backward) of 50 us and 1 ms of other work.
    dev = []
    for step in range(2):
        t0 = step * 5000
        for i, name in enumerate(["hash_encode_fwd_kernel<true>", "hash_encode_fwd_kernel<true>",
                                  "hash_encode_bwd_kernel<true>", "hash_encode_bwd_kernel<true>"]):
            dev.append((f"void (anonymous namespace)::{name}(float const*)", t0 + 50 * i,
                        t0 + 50 * (i + 1)))
        dev.append(("at::native::elementwise", t0 + 200, t0 + 1200))
    t = tr.from_chrome(chrome((0, 10000), dev))
    info = {"config": CONFIG, "traced": {"trace": t, "steps": 2},
            "window": {"seconds": 2.0, "steps": 200, "train_rays_per_s": 102400.0}}
    ms = spec.metric_reader("hashgrid_encode_ms").read(info)
    assert ms == pytest.approx(0.2)
    # The step's own: 5 launches and 1.2 ms busy a step, in a traced window
    # of 10 ms and an untraced one of 10 ms a step.
    read = {name: spec.metric_reader(name).read(info) for name in STEP_METRICS + HOST_METRICS}
    assert read == pytest.approx({"launches_per_step.ngp_train": 5.0,
                                  "device_idle_pct.ngp_train": 76.0,
                                  "untraced_busy_pct.ngp_train": 12.0,
                                  "host_rays_per_s.ngp_train": 102400.0})
    least = sum(plugin().encode_bytes(MODEL, n, True, "bfloat16")
                for n in (1024 * 64, 1024 * 192)) / 3.35e12
    roof = spec.metric_reader("hashgrid_encode_roofline").read(info)
    assert roof == pytest.approx(100 * least / 200e-6)
    # Another type's cell, or no such kernel: nothing to read.
    flex = dict(info, config=load_json(ROOT / "benchmark/configs/flex_4x128.json"))
    bare = dict(info, traced={"trace": tr.from_chrome(chrome((0, 10), [("k", 1, 2)])),
                              "steps": 1})
    for name in KERNEL_METRICS:
        assert spec.metric_reader(name).read(flex) is None
        assert spec.metric_reader(name).read(bare) is None
        assert spec.metric_reader(name).read(dict(info, traced=None)) is None


def digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def checkout_without_the_type(tmp_path: Path) -> Path:
    """A copy of the checkout's benchmark as it was before the type: its
    files and entries taken out."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel in NEW_FILES + ["tests/test_nerfbench_hashgrid.py"]:
        (root / "benchmark" / rel).unlink()
    bench = load_json(ROOT / "BENCHMARK.json")
    bench["configs"] = [c for c in bench["configs"] if c["name"] != "ngp_hash_l16"]
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != "ngp_train"]
    bench["per_layer"] = [m for m in bench["per_layer"] if m["name"] not in NEW_METRICS]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != "ngp_train"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def add_the_type(root: Path) -> None:
    """Lay the type's files over the checkout and append its entries;
    refuse to overwrite anything."""
    for rel in NEW_FILES:
        target = root / "benchmark" / rel
        assert not target.exists(), rel
        shutil.copy(ROOT / "benchmark" / rel, target)
    full = load_json(ROOT / "BENCHMARK.json")
    bench = load_json(root / "BENCHMARK.json")
    bench["configs"] += [c for c in full["configs"] if c["name"] == "ngp_hash_l16"]
    bench["workloads"] += [w for w in full["workloads"] if w["name"] == "ngp_train"]
    bench["per_layer"] += [m for m in full["per_layer"] if m["name"] in NEW_METRICS]
    for m in bench["end_to_end"]:
        if m["name"] == "train_step_device_ms":
            m["workloads"].append("ngp_train")
    assert bench == full
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_the_cell_joins_by_new_files_alone_and_runs_correct(tmp_path, trace):
    root = checkout_without_the_type(tmp_path)
    with pytest.raises(KeyError):
        spec.find_cell("ngp_train", root)
    before = digests(root)
    add_the_type(root)
    after = digests(root)
    changed = [p for p, d in before.items() if after[p] != d and p != Path("BENCHMARK.json")]
    assert not changed, changed

    res = cpu_run("ngp_train", seed=3000000077, trace=trace, root=root)
    assert res["correct"], res["checks"]
    cell = spec.find_cell("ngp_train", root)
    assert cell.model.name == TYPE
    # A step: the coarse and the fine field, one encoding launch each way;
    # the warm-up call and the traced one (train_step_device_ms is read
    # from the trace, so every run traces) take 3 steps each beside the window.
    steps = res["attempted"] + 3 + 3
    assert res["checks"]["field_fwd_launches"]["value"] == 2 * steps
    assert res["checks"]["field_bwd_launches"]["value"] == 2 * steps
    # On the CPU no device operation runs: the device readers find nothing,
    # and say so by leaving their metrics out; the host's rate is there.
    if trace:
        assert not set(KERNEL_METRICS + STEP_METRICS) & set(res["metrics"])
        assert set(HOST_METRICS) <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"setup_s"}
