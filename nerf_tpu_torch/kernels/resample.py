"""Hierarchical inverse-CDF resampling of new depths along each ray.

Replaces ``nerf_tpu/ops/pallas/resample.py:fused_sample_pdf`` with a
hand-written CUDA kernel for Hopper (``csrc/resample.cu``): bin edges
(N, M) and bin weights (N, M-1) -> (N, num_samples) depths, f32, through the
reference's whole chain (weight floor, pdf, zero-prepended CDF, right-side
rank, index clamps, denom guard, interpolation) in one launch whose pdf and
CDF stay in shared memory.

What bounds it on the card is memory traffic: each edge, weight, uniform and
output crosses it once. The kernel takes one warp a ray and reads its
weights once, into registers; the CDF is an f64 warp scan (Kogge-Stone over
the lanes' pairs of terms) rounded once an entry to f32, where the TPU
kernel used a triangular matmul. Its f64 partial sums are exact for any
weights a compositing pass gives, so it is the CDF a serial f64 prefix sum
gives, bit for bit: non-decreasing, as the binary search for the rank
needs, and what ``torch.cumsum`` gives on the CPU. A float32 ``torch.cumsum`` on the card rounds otherwise, which moves
samples of bins of small pdf (``chip_smoke.check_resample`` holds those in
CDF space).

The arguments are those of ``ops/sampling.sample_pdf``, which is the plain
version: ``det`` takes linspace(0, 1) uniforms, else they are drawn from
``generator`` exactly as ``sample_pdf`` draws them; ``u`` overrides both, so
that a test can hand the JAX package and the port the same numbers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..ops.sampling import sample_pdf


@functools.lru_cache(maxsize=None)
def _kernel():
    from ._build import load_library

    lib = load_library()
    fn = lib.nerf_resample
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, lib.nerf_resample_max_bins()


def fused_sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    det: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``num_samples`` new depths per ray from edges ``bins`` (N, M) and
    weights ``weights`` (N, M-1): (N, num_samples) f32.

    CPU tensors go through ``sample_pdf``. CUDA tensors go through the
    kernel; anything it does not take raises. ``fused_sample_pdf.launches``
    counts the kernel's launches.
    """
    if bins.device.type == "cpu":
        return sample_pdf(bins, weights, num_samples, det=det, generator=generator, u=u)
    if bins.device.type != "cuda":
        raise ValueError(f"fused_sample_pdf: no kernel for device {bins.device}")
    if bins.ndim != 2 or bins.shape[1] < 2 or tuple(weights.shape) != (bins.shape[0],
                                                                         bins.shape[1] - 1):
        raise ValueError(
            f"fused_sample_pdf: want bins (N, M >= 2) and weights (N, M - 1), got "
            f"{tuple(bins.shape)} and {tuple(weights.shape)}"
        )
    if num_samples < 1:
        raise ValueError(f"fused_sample_pdf: num_samples must be positive, got {num_samples}")
    if bins.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError("fused_sample_pdf: bins and weights must be float32")
    n, m = bins.shape
    if u is not None and (tuple(u.shape) != (n, num_samples) or u.dtype != torch.float32):
        raise ValueError(f"fused_sample_pdf: want u ({n}, {num_samples}) float32, got "
                         f"{tuple(u.shape)} {u.dtype}")
    if weights.device != bins.device or (u is not None and u.device != bins.device):
        raise ValueError(f"fused_sample_pdf: every input must be on {bins.device}")

    out = torch.empty((n, num_samples), dtype=torch.float32, device=bins.device)
    if n == 0:
        return out
    with torch.cuda.device(bins.device):
        fn, max_bins = _kernel()
        if m > max_bins:
            raise ValueError(f"fused_sample_pdf: the kernel takes at most {max_bins} bin "
                             f"edges, got {m}")
        if u is None and det:
            # One linspace row for every ray (row stride 0), the values
            # sample_pdf's expand() gives.
            u, stride = torch.linspace(0.0, 1.0, num_samples, dtype=torch.float32,
                                       device=bins.device), 0
        else:
            if u is None:
                u = torch.rand((n, num_samples), generator=generator, dtype=torch.float32,
                               device=bins.device)
            u, stride = u.contiguous(), num_samples
        bins_c, weights_c = bins.contiguous(), weights.contiguous()
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        rc = fn(bins_c.data_ptr(), weights_c.data_ptr(), u.data_ptr(), stride, out.data_ptr(),
                n, m, num_samples, stream)
    if rc != 0:
        raise RuntimeError(f"fused_sample_pdf: kernel launch failed with CUDA error {rc}")
    fused_sample_pdf.launches += 1
    return out


fused_sample_pdf.launches = 0
