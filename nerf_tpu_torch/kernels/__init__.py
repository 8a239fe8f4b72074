"""Hand-written CUDA kernels and their Python wrappers.

Each wrapper keeps a plain PyTorch version of its kernel beside it: a tensor
on the CPU goes through the plain version, a tensor on a CUDA device through
the kernel (or the call raises). Nothing here imports a compiler or builds a
kernel when it is imported; the build happens at the first CUDA call
(``_build.load_library``).
"""

from .composite import fused_volume_render, volume_render_plain
from .flex_train import fused_flex_mlp_train, flex_train_plain_bwd, flex_train_plain_fwd
from .hashgrid import (
    fused_hash_encode,
    hash_encode_plain,
    hash_encode_plain_bwd,
)
from .mlp import (
    flexible_mlp_plain,
    flexible_mlp_rays_plain,
    fused_flexible_mlp,
    fused_flexible_mlp_rays,
    supports_fused,
)
from .mlp_t import fused_mlp_t, mlp_t_plain
from .paper_t import fused_paper_mlp_t, paper_t_plain, supports_fused_paper
from .paper_train import fused_paper_mlp_train, paper_train_plain_bwd, paper_train_plain_fwd
from .resample import fused_sample_pdf, sample_pdf
from .stage import fused_render_stage, render_stage_plain

__all__ = [
    "fused_volume_render",
    "volume_render_plain",
    "fused_flex_mlp_train",
    "flex_train_plain_bwd",
    "flex_train_plain_fwd",
    "fused_hash_encode",
    "hash_encode_plain",
    "hash_encode_plain_bwd",
    "flexible_mlp_plain",
    "flexible_mlp_rays_plain",
    "fused_flexible_mlp",
    "fused_flexible_mlp_rays",
    "supports_fused",
    "fused_mlp_t",
    "mlp_t_plain",
    "fused_paper_mlp_t",
    "paper_t_plain",
    "supports_fused_paper",
    "fused_paper_mlp_train",
    "paper_train_plain_bwd",
    "paper_train_plain_fwd",
    "fused_sample_pdf",
    "sample_pdf",
    "fused_render_stage",
    "render_stage_plain",
]
