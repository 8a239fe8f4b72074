"""What every MLP kernel wrapper of ``kernels/`` shares: the precision
policy, the checks and the return code of a call, and the weight images.

It imports no sibling module: the families (``mlp`` the 4x128 FlexibleNeRF,
``paper_t`` the 8x256 PaperNeRF) declare their images here and their
wrappers call in, never the other way.

Weight images. A bf16 kernel reads its weights as one image that its
wrapper builds a call from the packed f32 parameters: each operand matrix
(N, K) in the format its instruction reads, one after another. A family
declares an image by a :class:`WeightImage`: how to unpack its parameter
buffer into layers, which operands it computes from them (in order, K pads
holding a given value) and the format of the wide ones. The narrow heads
(fc_alpha, fc_rgb; fewer rows than the format takes) follow row by row.
The image works out once, on the positions of the packed buffer
themselves, where each of its values comes from, and packs with one gather.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

# --- precision -----------------------------------------------------------

COMPUTE_DTYPES = ("float32", "bfloat16")


def check_compute_dtype(compute_dtype: str) -> bool:
    """Raises unless ``compute_dtype`` is one of ``COMPUTE_DTYPES``; True for
    bfloat16."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}")
    return compute_dtype == "bfloat16"


def rounder(compute_dtype: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> x rounded to the matmul input dtype, kept f32: how the plain
    versions emulate bf16 operands with f32 sums."""
    if check_compute_dtype(compute_dtype):
        return lambda x: x.bfloat16().float()
    return lambda x: x


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for the matmuls inside; the caller's setting is restored."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class _F32MatMul(torch.autograd.Function):
    # vmap (the multi-scene step's scene axis) runs the forward and the
    # backward below on batched tensors.
    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        with _no_tf32():
            return a @ b

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _no_tf32():
            return (g @ b.t() if ctx.needs_input_grad[0] else None,
                    a.t() @ g if ctx.needs_input_grad[1] else None)


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32 on the card, forward and gradient, whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says: the JAX package asks for
    HIGHEST precision per dot, so the flag is turned off around these
    products only and the caller's setting is kept."""
    return _F32MatMul.apply(a, b)


# --- a call --------------------------------------------------------------


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, float32 and 16-byte aligned (the kernels read float4)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_forward(what: str, fits: bool, shape: str, compute_dtype: str, model,
                  pts: torch.Tensor, viewdirs: torch.Tensor, points: bool = False) -> bool:
    """The checks of a forward wrapper: the compute dtype, the model's shape
    (``fits``: the kernel's gate took it; ``shape`` names what it takes)
    and the device. True on the CPU, where the wrapper calls its plain
    version. On CUDA the inputs too: pts (N, S, 3) and viewdirs (N, 3), or
    with ``points`` pts (N, 3) each seen along its own viewdirs row; float32;
    on the model's device."""
    check_compute_dtype(compute_dtype)
    if not fits:
        raise ValueError(f"{what}: model is not {shape}")
    if pts.device.type == "cpu":
        return True
    if pts.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {pts.device}")
    if points:
        ok, want = pts.ndim == 2 and tuple(viewdirs.shape) == tuple(pts.shape), "(N, 3)"
    else:
        ok, want = pts.ndim == 3 and tuple(viewdirs.shape) == (pts.shape[0], 3), "(N, S, 3)"
    if not ok or pts.shape[-1] != 3:
        raise ValueError(f"{what}: want pts {want} and viewdirs (N, 3), got "
                         f"{tuple(pts.shape)} and {tuple(viewdirs.shape)}")
    if pts.dtype != torch.float32 or viewdirs.dtype != torch.float32:
        raise ValueError(f"{what}: pts and viewdirs must be float32")
    if viewdirs.device != pts.device or next(model.parameters()).device != pts.device:
        raise ValueError(f"{what}: pts, viewdirs and the model must share a device")
    return False


def cuda_stream(device: torch.device) -> int:
    """The current stream of ``device``, as the C entry points take it."""
    return torch.cuda.current_stream(device).cuda_stream


def check_rc(what: str, rc: int) -> None:
    """A C entry point's return code: nonzero is the CUDA error it met."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc}")


# --- weight images -------------------------------------------------------


def fragment_order(m: torch.Tensor, warps: int = 8) -> torch.Tensor:
    """An (N, K) operand matrix (N a multiple of 8 ``warps``, K of 16)
    flattened in the order the tensor-core kernels read it
    (``csrc/tc_mma.cuh``): for each 16-deep k-step, for each of the ``warps``
    warps (N / warps consecutive outputs; 8 in the PaperNeRF kernels, 4 in the
    4x128 ones), for each lane l, the NT = N / (8 warps) m16n8k16 B fragments
    that lane holds: ``m[n][k]`` for n = (warp * NT + j) * 8 + l // 4 and
    k = 16 ks + 8 h + 2 (l % 4) + e, in (j, h, e) order."""
    n, k = m.shape
    x = m.reshape(warps, n // (8 * warps), 8, k // 16, 2, 4, 2)   # warp, j, l // 4, ks, h, l % 4, e
    return x.permute(3, 0, 2, 5, 1, 4, 6).reshape(-1)


def fragment_matrix(flat: torch.Tensor, n: int, k: int, warps: int = 8) -> torch.Tensor:
    """The inverse of ``fragment_order``: the (N, K) matrix."""
    x = flat.reshape(k // 16, warps, 8, 4, n // (8 * warps), 2, 2)
    return x.permute(1, 4, 2, 0, 5, 3, 6).reshape(n, k)


SLICE_K = 64   # K columns of a wgmma slice (csrc/paper_wg.cuh, flex_wg.cuh kSliceK)


def _slices(k: int) -> int:
    """K padded to whole slices."""
    return -(-k // SLICE_K) * SLICE_K


def swizzled(m: torch.Tensor, pad: float) -> torch.Tensor:
    """An (N, K) operand as the shared-memory images of its K slices
    (``csrc/paper_wg.cuh``, ``flex_wg.cuh``): K cut into 64-column slices,
    the last padded with ``pad``; each slice N rows of 128 bytes, K-major,
    whose eight 16-byte chunks lie swizzled: column k of row n in chunk
    (k // 8) ^ (n % 8), the layout wgmma's 128-byte-swizzle descriptor
    reads."""
    n, k = m.shape
    kp = _slices(k)
    x = torch.nn.functional.pad(m, (0, kp - k), value=pad).reshape(n, kp // SLICE_K, 8, 8)
    rows = torch.arange(n).view(n, 1)
    x = x[rows, :, torch.arange(8).view(1, 8) ^ (rows % 8)]     # n, chunk, slice, e
    return x.permute(2, 0, 1, 3).reshape(-1)


def unswizzled(flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The inverse of ``swizzled``: the (N, K) matrix, the slices' pads cut."""
    kp = _slices(k)
    x = flat.reshape(kp // SLICE_K, n, 8, 8).permute(1, 0, 2, 3)   # n, slice, chunk, e
    rows = torch.arange(n).view(n, 1)
    x = x[rows, :, torch.arange(8).view(1, 8) ^ (rows % 8)]         # n, chunk, slice, e
    return x.permute(0, 2, 1, 3).reshape(n, kp)[:, :k]


class Rows(NamedTuple):
    """An operand row by row, as (N, K) lies in memory."""

    min_rows: int = 0

    def flatten(self, m: torch.Tensor, pad: float) -> torch.Tensor:
        return m.reshape(-1)

    def size(self, n: int, k: int) -> int:
        return n * k

    def unflatten(self, flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
        return flat.view(n, k)


class Fragments(NamedTuple):
    """An operand as the ``mma.sync`` B fragments of a block of ``warps``
    warps (``fragment_order``)."""

    warps: int

    @property
    def min_rows(self) -> int:
        return 8 * self.warps

    def flatten(self, m: torch.Tensor, pad: float) -> torch.Tensor:
        return fragment_order(m, self.warps)

    def size(self, n: int, k: int) -> int:
        return n * k

    def unflatten(self, flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
        return fragment_matrix(flat, n, k, self.warps)


class Swizzled(NamedTuple):
    """An operand as the swizzled images of its 64-column K slices
    (``swizzled``), the last slice's pad holding the image's pad."""

    min_rows: int = 64

    def flatten(self, m: torch.Tensor, pad: float) -> torch.Tensor:
        return swizzled(m, pad)

    def size(self, n: int, k: int) -> int:
        return n * _slices(k)

    def unflatten(self, flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
        whole = unswizzled(flat, n, _slices(k))
        if whole[:, k:].any():
            raise ValueError("nonzero values in a slice's pad")
        return whole[:, :k]


Operands = List[Tuple[str, torch.Tensor]]


class WeightImage:
    """A kernel's weights as an image of a family's packed parameters.

    ``unpack(params)`` gives the layers of a packed buffer of ``n_params``
    values, ``operands(layers, pad)`` the image's matrices (name, (N, K)) in
    order, their K pads holding ``pad``; the wide ones lie in ``fmt``, the
    others row by row. A bf16 image is rounded to bf16 with zero pads; an
    f32 one (``bf16=False``) has no pads and is a plain gather.
    """

    def __init__(self, unpack: Callable[[torch.Tensor], Dict[str, tuple]], n_params: int,
                 operands: Callable[[Dict[str, tuple], float], Operands], fmt,
                 bf16: bool = True):
        self.n_params, self.fmt, self.bf16 = n_params, fmt, bf16
        self._unpack, self._operands = unpack, operands
        self._index: Dict[str, torch.Tensor] = {}

    def _parts(self, params: torch.Tensor, pad: float):
        return [(name, m, self.fmt if m.shape[0] >= self.fmt.min_rows else Rows())
                for name, m in self._operands(self._unpack(params), pad)]

    def index(self, device: str = "cpu") -> torch.Tensor:
        """Where each value of the image comes from in the packed parameters
        (``n_params`` for a zero pad), on ``device``: worked out once a
        device by running the operands on the positions themselves."""
        if device not in self._index:
            n = self.n_params
            ref = torch.arange(n + 1, dtype=torch.float64)
            self._index[device] = torch.cat([
                fmt.flatten(m, float(n)) for _, m, fmt in self._parts(ref, float(n))
            ]).long().to(device)
        return self._index[device]

    @property
    def size(self) -> int:
        """Values of the image, which the wrappers hold the C layouts to."""
        return self.index().numel()

    def pack(self, params: torch.Tensor) -> torch.Tensor:
        """The image of the packed parameters (..., n_params), one leading
        index a scene: one gather; a bf16 image rounded, 16-byte aligned."""
        if not self.bf16:
            return params[..., self.index(str(params.device))]
        params = params.detach().float()
        ext = torch.nn.functional.pad(params, (0, 1))
        out = ext[..., self.index(str(params.device))].to(torch.bfloat16)
        return out if out.data_ptr() % 16 == 0 else out.clone()

    def unpack(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The inverse of ``pack``: name -> the f32 (N, K) operand with its K
        pads. Raises on a buffer of another length."""
        out, off = {}, 0
        for name, m, fmt in self._parts(torch.zeros(self.n_params), 0.0):
            n, k = m.shape
            size = fmt.size(n, k)
            out[name] = fmt.unflatten(buf[off:off + size].float(), n, k)
            off += size
        if off != buf.numel():
            raise ValueError(f"a buffer of {buf.numel()} values for a layout of {off}")
        return out
