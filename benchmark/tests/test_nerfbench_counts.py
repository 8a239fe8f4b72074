"""Operation and byte counts against hand counts of both configurations,
through their model types' plug-ins."""

import pytest

from benchmark.harness import counts, spec
from benchmark.harness.spec import ROOT, load_json

FLEX = load_json(ROOT / "benchmark/configs/flex_4x128.json")
PAPER = load_json(ROOT / "benchmark/configs/paper_8x256.json")


def layers(config):
    model = config["models"]["coarse"]
    return spec.model_type(model["type"]).plugin.layers(model)


def test_flexible_counts_by_hand():
    m = layers(FLEX)
    # layer1 63x128, three 128x128, fc_feat 128x128, fc_alpha 128x1,
    # layers_dir.0 (128 + 27)x64, fc_rgb 64x3.
    fwd = 63 * 128 + 3 * 128 * 128 + 128 * 128 + 128 + 155 * 64 + 64 * 3
    assert fwd == 83_840 == counts.forward_macs(m)
    # Layer gradients: all but layer1's input and the encoded directions.
    assert counts.input_grad_macs(m) == 3 * 128 * 128 + 128 * 128 + 128 + 128 * 64 + 64 * 3 \
        == 74_048
    assert counts.weight_grad_macs(m) == fwd


def test_paper_counts_by_hand():
    m = layers(PAPER)
    fwd = (63 * 256 + 3 * 256 * 256 + (63 + 256) * 256 + 3 * 256 * 256 + 256 * 256 + 256
           + (256 + 27) * 128 + 2 * 128 * 128 + 128 * 3)
    assert fwd == 626_176 == counts.forward_macs(m)
    assert counts.input_grad_macs(m) == 7 * 256 * 256 + 256 * 256 + 256 + 256 * 128 \
        + 2 * 128 * 128 + 128 * 3 == 590_464


@pytest.mark.parametrize("config", [FLEX, PAPER], ids=["flex", "paper"])
def test_parameter_count_matches_the_modules(config):
    from nerf_tpu_torch.config import model_from_config
    from benchmark.drivers.common import program_config

    model = model_from_config(program_config(config).models.coarse)
    total = sum(p.numel() for p in model.parameters())
    unused = 128 * 128 + 128 if config is PAPER else 0     # layers_dir.3, never run
    assert counts.num_params(layers(config)) == total - unused


def test_step_and_frame_operations():
    m = FLEX["models"]["coarse"]
    # A 1024-ray step of 64 + 64 samples: 65,536 coarse and 131,072 fine points.
    pts = 1024 * 64 + 1024 * 128
    assert 3 * counts.field_flops(m, pts, backward=False) == 3 * 2 * 83_840 * pts
    assert 3 * counts.field_flops(m, pts, backward=False) == pytest.approx(98.9e9, rel=1e-3)
    frame = 400 * 400 * (64 + 128)      # coarse 64, fine 64 + 64
    assert counts.field_flops(m, frame, backward=False) == pytest.approx(5.15e12, rel=1e-3)
    p = PAPER["models"]["coarse"]
    assert counts.field_flops(p, frame, backward=False) == pytest.approx(38.47e12, rel=1e-3)
    assert counts.field_flops(m, 10, backward=True) == 2 * 10 * (83_840 + 74_048 + 83_840)


def test_bytes_and_least_time_by_hand():
    m = FLEX["models"]["coarse"]
    params = counts.num_params(layers(FLEX))
    # Forward: points and directions in, weights in, raw out, 4 bytes each.
    assert counts.field_bytes(m, 2, 8, backward=False) == 4 * (3 * 8 + 3 * 2 + params + 4 * 8)
    # Backward adds the cotangent, the points and directions again, and the
    # weights and their gradients.
    assert counts.field_bytes(m, 2, 8, backward=True) == 4 * (
        3 * 8 + 3 * 2 + params + 4 * 8 + 4 * 8 + 3 * 8 + 3 * 2 + 2 * params)
    flops = counts.field_flops(m, 1024 * 128, backward=True)
    nbytes = counts.field_bytes(m, 1024, 1024 * 128, backward=True)
    assert counts.least_seconds(flops, nbytes, "bfloat16") == flops / 989e12   # ops-bound
    assert counts.least_seconds(1.0, 3.35e12, "float32") == 1.0                 # bytes-bound
