"""Every weight image the MLP kernels read, pinned value for value.

A bf16 kernel's weights are an image of the packed f32 parameters
(``kernels/common.WeightImage``), built by one gather whose index says where
each value comes from (one past the buffer's end for a zero pad). Each case
holds one image's index, of the 4x128 family (``kernels/mlp.IMAGES``) or of
the 8x256 one at an encoding depth (``kernels/paper_t.images``), to its
length and to the sha256 of its int64 values as the layout was first
recorded: a pack from an equal index is the same buffer bit for bit, so a
change to how an image is declared or built cannot move a value the card
reads without failing here.
"""

import hashlib

import pytest
import torch

from nerf_tpu_torch.kernels import mlp, paper_t

# (image, encoding depth (None: the 4x128 family), values, sha256 of the index)
PINS = [
    ("tc_forward", None, 82240,
     "3c9575a2ea7eacbb2c6ba9e3f1357bdf9cf6e7235d6e511139becc75dfa6f2b7"),
    ("tc_forward_points", None, 84288,
     "8bf9abeec31683bbcd120ec2466f60a04ded6ae9f96d11925e799eb2202a925b"),
    ("wg_forward", None, 82240,
     "c45adb0e829b9ee90c9dce183ec53a22b2a5960afa923df24b95ae4af386a5a4"),
    ("tc_backward", None, 76800,
     "287d0968145448693c93a132094a5b3c1791e0762ba8db6e65df37f6ebb03048"),
    ("f32_backward", None, 74048,
     "b23f7a98798d8816d90b1bf6a9ae8502305aeee1d6485f14172c4083db2e0b4a"),
    ("tc_forward", 0, 598656, "e85a75c083d07c32e0c5124de3e4d11adabc27017ced7b07c336af50d25c8fe2"),
    ("wg_forward", 0, 623232, "f8ed9f641a6fdac948184a862a398371d33704d5abdc02704cf53100b6a4ff36"),
    ("tc_backward", 0, 595968, "69ae4dbe6cda4070454ec653ff572950fa3374a1fd4e333ab89d1bf65632678d"),
    ("f32_backward", 0, 590464, "add83a614396f714604f1176dff80b3cbfc240498cd771ad323a10161629f842"),
    ("tc_forward", 6, 615040, "f73a9bfe98999f32bbc38781d5c6daa47039d4a52791666d0fa8a5f6ec933d40"),
    ("wg_forward", 6, 623232, "5c23dec3da23277ca6d8b91308ce2d4e0d6238fd244474aa12e1d6aca8ec1323"),
    ("tc_backward", 6, 595968, "7ef2a9ade4d7abd9a6218ad8a4d88a414eefc54bf194f1d727e3fcf07ae7767d"),
    ("f32_backward", 6, 590464, "3c29f86b78da6e8c30f44d053623e08cea53c03a47242954275d5e4fc38dcf69"),
    ("tc_forward", 10, 623232, "8b0034924c4bdd05afcb0fafab789d9b70a8855c9b3219b7486e692653eaba4d"),
    ("wg_forward", 10, 623232, "b5796f07ba80855c0c0bdb4a942bab6fb4483be770823b0250d3b63459f1f354"),
    ("tc_backward", 10, 595968, "e92ca94ac39356e4075cf8ce724589c519f64786bb6ed1967b120ef8f66fa0c1"),
    ("f32_backward", 10, 590464,
     "57d7b4d701b876a5a9a70a9a55dcf6b539afaea86f0d370574c6ec5cd9b2eab5"),
    ("tc_forward", 16, 647808, "ab405b192eb4e100c90a151e45feb780c442670c4b1bed45e36d49bf2f54032b"),
    ("wg_forward", 16, 656000, "97d83ee323f5f5c4c14125a8c076c755e13efc701ff8720b19fd4c7a8c55e964"),
    ("tc_backward", 16, 595968, "3786f1b13785dcc08133e061595c602ed9d1cf718f745057344e323d1d1805ad"),
    ("f32_backward", 16, 590464,
     "1a19c6068005a1dec637c9059c2514d78170c2054a6b987518c74138a9a591db"),
]


@pytest.mark.parametrize("name, num_freq, size, digest", PINS,
                         ids=[f"{n}-{'flex' if f is None else f'paper{f}'}" for n, f, _, _ in PINS])
def test_image_index_is_pinned(name, num_freq, size, digest):
    image = getattr(mlp.IMAGES if num_freq is None else paper_t.images(num_freq), name)
    index = image.index("cpu")
    assert image.size == index.numel() == size
    assert index.dtype == torch.int64
    assert hashlib.sha256(index.numpy().tobytes()).hexdigest() == digest
