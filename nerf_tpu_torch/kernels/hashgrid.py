"""Instant-NGP's multiresolution hash encoding on the card: a forward and a
backward kernel (``csrc/hashgrid.cu``) behind one ``torch.autograd.Function``.

No TPU kernel is replaced: the JAX package has no hash-grid field. The
kernels serve ``models/hashgrid.HashGridNeRFModel``, whose encoding the
renderer routes here under ``use_pallas_train`` (training) and
``use_pallas`` (rendering).

- forward: points (P, 3) float32 -> features (P, L * F) in the compute dtype,
  each level's F features the trilinear sum of its 8 corners' table rows;
- backward: the features' gradient -> the table's gradient (entries, F)
  float32, each corner's w_c * gradient added into its row by the card's
  vector reductions. No gradient is made for the points: the wrapper refuses
  points that require one.

What bounds them: bytes and latency, not operations. A point reads 8 rows of
8 bytes at each of 16 levels, at rows scattered over a 48.8 MB table (the
hashed levels), and the backward adds into as many. The design: one thread a
point walks all levels, so that a warp's points (consecutive samples of a
ray, near each other) share the coarse levels' rows in L1 and L2 and the
hash's x prime of 1 keeps a corner pair's rows in one sector; its 2L
features stay in registers and leave in 16-byte stores.

``hash_encode_plain`` (forward, in the kernel's order of roundings) and
``hash_encode_plain_bwd`` (backward, autograd of the plain encoding) are the
plain PyTorch version; CPU tensors take them, CUDA tensors the kernels or an
error.
``fused_hash_encode.fwd_launches`` and ``.bwd_launches`` count the kernels'
launches (one a call each way).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.encoding import HashGrid, hash_encode
from .common import check_compute_dtype

MAX_LEVELS = 16          # csrc/hashgrid.cu kMaxLevels


def _kernels_take(grid: HashGrid) -> bool:
    """At most 16 levels of 2 features, hashed levels of 2^k rows, row
    numbers in 31 bits."""
    return (grid.features == 2 and 1 <= grid.num_levels <= MAX_LEVELS
            and grid.num_entries < 2 ** 31
            and all(d or (s & (s - 1)) == 0 for d, s in zip(grid.dense, grid.sizes)))


def hash_encode_plain(table: torch.Tensor, pts: torch.Tensor, grid: HashGrid,
                      compute_dtype: str = "float32") -> torch.Tensor:
    """The forward kernel's function in PyTorch: (P, L * F) in the compute
    dtype."""
    return hash_encode(table, pts, grid).to(getattr(torch, compute_dtype))


def hash_encode_plain_bwd(grad: torch.Tensor, pts: torch.Tensor, grid: HashGrid
                          ) -> torch.Tensor:
    """The backward kernel's function in PyTorch: the table's gradient
    (entries, F) float32 from the features' gradient (P, L * F), by autograd
    of ``hash_encode`` (linear in the table, so a zero table serves)."""
    table = torch.zeros((grid.num_entries, grid.features), dtype=torch.float32,
                        device=grad.device, requires_grad=True)
    with torch.enable_grad():
        (dtable,) = torch.autograd.grad(hash_encode(table, pts, grid), table, grad.float())
    return dtable


@functools.lru_cache(maxsize=None)
def _kernels():
    from ._build import load_library

    lib = load_library()
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fwd = lib.nerf_hash_encode_forward
    fwd.argtypes = [ptr, ptr, ptr, i32, f32, f32, ptr, i64, i32, ptr]
    bwd = lib.nerf_hash_encode_backward
    bwd.argtypes = [ptr, ptr, i32, ptr, i32, f32, f32, ptr, i64, ptr]
    for fn in (fwd, bwd):
        fn.restype = ctypes.c_int
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _levels(grid: HashGrid):
    """The grid's levels as the C interface takes them: 4 ints a level
    (resolution, first row, rows, dense)."""
    flat = [v for level in zip(grid.resolutions, grid.offsets, grid.sizes, grid.dense)
            for v in map(int, level)]
    return (ctypes.c_int * len(flat))(*flat)


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"fused_hash_encode: {name} kernel launch failed with CUDA error {rc}")


def _forward(table, pts, grid, compute_dtype):
    p = pts.shape[0]
    out = torch.empty((p, grid.num_levels * grid.features), dtype=getattr(torch, compute_dtype),
                      device=pts.device)
    if p == 0:
        return out
    fwd, _ = _kernels()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        _check("forward", fwd(pts.data_ptr(), table.data_ptr(), _levels(grid), grid.num_levels,
                              grid.box, 1.0 / (2.0 * grid.box), out.data_ptr(), p,
                              int(compute_dtype == "bfloat16"), stream))
    fused_hash_encode.fwd_launches += 1
    return out


def _backward(grad, pts, grid):
    dtable = torch.zeros((grid.num_entries, grid.features), dtype=torch.float32,
                         device=pts.device)
    p = pts.shape[0]
    if p == 0:
        return dtable
    _, bwd = _kernels()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        _check("backward", bwd(pts.data_ptr(), grad.data_ptr(),
                               int(grad.dtype == torch.bfloat16), _levels(grid),
                               grid.num_levels, grid.box, 1.0 / (2.0 * grid.box),
                               dtable.data_ptr(), p,
                               stream))
    fused_hash_encode.bwd_launches += 1
    return dtable


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, pts, grid, compute_dtype):
        ctx.grid = grid
        ctx.save_for_backward(pts)
        if pts.device.type == "cpu":
            return hash_encode_plain(table, pts, grid, compute_dtype)
        return _forward(table, pts, grid, compute_dtype)

    @staticmethod
    def backward(ctx, grad):
        (pts,) = ctx.saved_tensors
        grad = grad.contiguous()
        if pts.device.type == "cpu":
            return hash_encode_plain_bwd(grad, pts, ctx.grid), None, None, None
        return _backward(grad, pts, ctx.grid), None, None, None


def fused_hash_encode(table: torch.Tensor, pts: torch.Tensor, grid: HashGrid,
                      compute_dtype: str = "float32") -> torch.Tensor:
    """The hash encoding of points (P, 3) float32 under ``table`` (entries,
    F) float32: (P, L * F) in ``compute_dtype``, differentiable in
    ``table``. CPU tensors go through the plain version; CUDA tensors through
    the kernels; anything they do not take raises."""
    check_compute_dtype(compute_dtype)
    if pts.requires_grad:
        raise ValueError("fused_hash_encode makes no gradient for the points; "
                         "pass points that do not require one (detach them)")
    if pts.ndim != 2 or pts.shape[1] != 3 or pts.dtype != torch.float32:
        raise ValueError(f"fused_hash_encode: want float32 points (P, 3), got "
                         f"{tuple(pts.shape)} {pts.dtype}")
    want = (grid.num_entries, grid.features)
    if table.dtype != torch.float32 or tuple(table.shape) != want:
        raise ValueError(f"fused_hash_encode: want a float32 table {want}, "
                         f"got {tuple(table.shape)} {table.dtype}")
    if table.device != pts.device:
        raise ValueError("fused_hash_encode: the table and the points must share a device")
    if pts.device.type == "cuda" and not _kernels_take(grid):
        raise ValueError("fused_hash_encode: the kernels take 1-16 levels of 2 features, "
                         "hashed levels of 2^k rows")
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_hash_encode: no kernel for device {pts.device}")
    return _HashEncode.apply(table, pts.contiguous(), grid, compute_dtype)


fused_hash_encode.fwd_launches = 0
fused_hash_encode.bwd_launches = 0
