"""Model types as the benchmark finds them: one plug-in (``models/<type>.py``)
and one plain field (``reference/fields/<type>.py``) a type.

Today's two types seed their weights bitwise as the harness did before the
plug-ins (each leaf's checksum and three elements, from that harness, in
``seed_pins.json``). A third type, the port's ``ReplicateNeRFModel`` on its
plain path, joins by new files alone: ``third_type/`` holds its configuration,
its two files and its two cells' limits, and ``third_type/entries.json`` its
entries of ``BENCHMARK.json``. The test lays them over a copy of the checkout
and runs a training cell and a render cell of it to ``correct`` on the CPU,
with no file that was there before changed.
"""

import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark.drivers.common import program_config, seed_fields
from benchmark.harness import counts, readings, spec
from benchmark.harness.spec import ROOT, load_json
from cpu_runs import cpu_run

HERE = Path(__file__).resolve().parent
PINS = load_json(HERE / "seed_pins.json")
PIN_SEED = 2147483659


def fields(config):
    from nerf_tpu_torch.config import model_from_config

    cfg = program_config(config)
    return [model_from_config(cfg.models.coarse), model_from_config(cfg.models.fine)]


@pytest.mark.parametrize("opacify", [False, True], ids=["train", "render"])
@pytest.mark.parametrize("name", ["flex_4x128", "paper_8x256"])
def test_seeding_is_bitwise_the_harness_before_plugins(name, opacify):
    config = load_json(ROOT / f"benchmark/configs/{name}.json")
    mc, mf = fields(config)
    seed_fields(spec.model_type(config["models"]["coarse"]["type"]), [mc, mf], PIN_SEED, "cpu",
                opacify=opacify)
    leaves = {f"coarse.{k}": p for k, p in mc.named_parameters()}
    leaves.update({f"fine.{k}": p for k, p in mf.named_parameters()})
    pins = PINS[f"{name}/{opacify}"]
    assert list(leaves) == list(pins)
    for k, p in leaves.items():
        flat = p.detach().reshape(-1)
        digest, elements = pins[k]
        assert hashlib.sha256(flat.numpy().tobytes()).hexdigest()[:16] == digest, k
        at = (0, flat.numel() // 2, flat.numel() - 1)
        assert [float(flat[i]).hex() for i in at] == elements, k


def checkout(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    return root


def digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def add_third_type(root: Path) -> None:
    """Lay ``third_type/`` over the checkout's ``benchmark/`` and add its
    entries to ``BENCHMARK.json``; refuse to overwrite anything."""
    source = HERE / "third_type"
    for path in source.rglob("*.*"):
        rel = path.relative_to(source)
        if rel.name == "entries.json" or "__pycache__" in rel.parts:
            continue
        target = root / "benchmark" / rel
        assert not target.exists(), rel
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(path, target)
    bench = load_json(root / "BENCHMARK.json")
    for section, entries in load_json(source / "entries.json").items():
        bench[section] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.mark.parametrize("workload", ["replicate_train", "replicate_render"])
def test_a_third_type_joins_by_new_files_alone(tmp_path, workload):
    root = checkout(tmp_path)
    before = digests(root)
    old_bench = load_json(root / "BENCHMARK.json")
    add_third_type(root)
    after = digests(root)
    changed = [p for p, d in before.items() if after[p] != d and p != Path("BENCHMARK.json")]
    assert not changed, changed
    new_bench = load_json(root / "BENCHMARK.json")
    for key, value in old_bench.items():
        if isinstance(value, list) and key not in ("command", "paths"):
            assert new_bench[key][:len(value)] == value, key      # entries added after
        else:
            assert new_bench[key] == value, key

    res = cpu_run(workload, seed=3000000077, root=root)
    assert res["correct"], res["checks"]
    cell = spec.find_cell(workload, root)
    assert cell.model.name == "ReplicateNeRFModel"
    assert set(res["checks"]) == set(cell.workload["limits"])   # no kernel: no counter
    # The counts and a reader on them find the type's plug-in by its files.
    model = cell.config["models"]["coarse"]
    macs = 39 * 64 + 2 * 64 * 64 + 64 + (64 + 27) * 32 + 32 * 32 + 32 * 3
    assert counts.field_flops(model, 10, False, root) == 2 * 10 * macs
    info = {"config": cell.config, "window": {"seconds": 1.0, "frames": 1}, "root": root}
    assert readings.mfu_pct(info, training=False) == pytest.approx(
        100 * 2 * macs * 400 * 400 * (64 + 128) / 67e12)


TABLE_FIELD = '''
import torch

def seed(modules, seed, device, opacify=False):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    with torch.no_grad():
        for mod in modules:
            mod.table.uniform_(-1e-4, 1e-4, generator=gen)
            for p in mod.head.parameters():
                p.uniform_(-1.0, 1.0, generator=gen)
'''
LINEARS_ONLY = '''
from benchmark.drivers.common import seed_linears

def seed(modules, seed, device, opacify=False):
    seed_linears(modules, seed, device, opacify, density_bias="head")
'''


class TableField(torch.nn.Module):
    """A hash-grid field's leaves in small: a table of features that is no
    linear layer, and a dense head."""

    def __init__(self):
        super().__init__()
        self.table = torch.nn.Parameter(torch.empty(64, 2))
        self.head = torch.nn.Linear(2, 4)


def with_plugin(root: Path, name: str, text: str) -> spec.ModelType:
    (root / "benchmark/models" / f"{name}.py").write_text(text)
    (root / "benchmark/reference/fields" / f"{name}.py").write_text("def field(*a):\n    pass\n")
    return spec.model_type(name, root)


def test_a_parameter_table_is_seeded_by_its_plugin(tmp_path):
    root = checkout(tmp_path)
    table_type = with_plugin(root, "TableField", TABLE_FIELD)

    def seeded(seed):
        mods = [TableField(), TableField()]
        seed_fields(table_type, mods, seed, "cpu")
        return [p.detach().clone() for m in mods for p in m.parameters()]

    first, again, other = seeded(2147483659), seeded(2147483659), seeded(2147483660)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first[0], other[0]) and not torch.equal(first[3], other[3])
    # A plug-in that seeds the linear layers alone leaves the table unseeded.
    linear_type = with_plugin(root, "LinearsOnly", LINEARS_ONLY)
    with pytest.raises(ValueError, match=r"0\.table"):
        seed_fields(linear_type, [TableField()], 1, "cpu")


@pytest.mark.parametrize("missing", ["models", "reference/fields"])
def test_a_type_lacking_a_file_fails_before_any_run(tmp_path, missing):
    root = checkout(tmp_path)
    add_third_type(root)
    (root / "benchmark" / missing / "ReplicateNeRFModel.py").unlink()
    with pytest.raises(FileNotFoundError) as err:
        spec.find_cell("replicate_train", root)
    for path in spec.model_type_files("ReplicateNeRFModel", root):
        assert str(path) in str(err.value)
