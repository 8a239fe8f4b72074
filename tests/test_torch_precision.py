"""The per-ray direction contribution runs in full f32 without touching the
caller's TF32 setting.

Both kernel families compute ``enc(viewdirs) @ W_dir[:, split:].T`` outside
their kernels (``kernels/mlp.dir_contribution``, ``kernels/paper_t
.dir_contribution``) through ``kernels/common.f32_matmul``, which turns
``torch.backends.cuda.matmul.allow_tf32`` off around that product and its
gradient only, as the JAX package asks for HIGHEST precision per dot. A
caller who enabled TF32 keeps it. On the CPU the flag does not change the
arithmetic, so the values are held to plain autograd exactly.
"""

import pytest
import torch

from nerf_tpu_torch.kernels import mlp, paper_t
from nerf_tpu_torch.kernels.common import f32_matmul
from nerf_tpu_torch.models import FlexibleNeRFModel, PaperNeRFModel

torch.set_num_threads(1)
FAMILIES = {
    "flexible": (FlexibleNeRFModel, mlp.dir_contribution, 128),
    "paper": (PaperNeRFModel, paper_t.dir_contribution, 256),
}


@pytest.fixture
def tf32_on():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dir_contribution_keeps_the_tf32_setting(tf32_on, family):
    cls, dir_contribution, split = FAMILIES[family]
    model = cls(num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
                generator=torch.Generator().manual_seed(0))
    vd = torch.nn.functional.normalize(torch.randn(9, 3, generator=torch.Generator()
                                                   .manual_seed(1)), dim=-1)
    dc = dir_contribution(model, vd)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    dc.square().sum().backward()
    assert torch.backends.cuda.matmul.allow_tf32 is True
    got = model.layers_dir[0].weight.grad[:, split:].clone()

    model.zero_grad()
    direnc = torch.cat([vd] + [fn(2.0 ** i * vd) for i in range(4) for fn in (torch.sin,
                                                                              torch.cos)], -1)
    want_dc = direnc @ model.layers_dir[0].weight[:, split:].t()
    want_dc.square().sum().backward()
    torch.testing.assert_close(dc, want_dc, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, model.layers_dir[0].weight.grad[:, split:], rtol=1e-5,
                               atol=1e-5)


def test_f32_matmul_gradients_are_matmul_gradients(tf32_on):
    gen = torch.Generator().manual_seed(2)
    a = torch.randn(5, 27, generator=gen, requires_grad=True)
    b = torch.randn(27, 64, generator=gen, requires_grad=True)
    g = torch.randn(5, 64, generator=gen)
    (f32_matmul(a, b) * g).sum().backward()
    got = a.grad.clone(), b.grad.clone()
    a.grad = b.grad = None
    ((a @ b) * g).sum().backward()
    assert torch.equal(got[0], a.grad) and torch.equal(got[1], b.grad)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    # An input that needs no gradient gets none.
    c = torch.randn(5, 27, generator=gen)
    (f32_matmul(c, b) * g).sum().backward()
