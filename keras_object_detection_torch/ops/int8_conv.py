"""The s8 x s8 -> s32 convolution of int8 serving (counterpart of the
``lax.conv_general_dilated(..., preferred_element_type=jnp.int32)`` of
``keras_object_detection_tpu/export/int8_serving.py`` ``_int8_conv``, a
library convolution outside any Pallas kernel).

Layouts: the activation is NHWC int8, the kernel ``(cout, kh, kw, cin)``
int8 (OHWI: JAX's HWIO kernel with its output axis first), the result the
NHWC int32 accumulator.

The route (``int8_conv2d`` on a CUDA tensor): the input is zero-padded
explicitly (symmetric quantization has zero-point 0, so the padding is
exact), cut into patches by ``Tensor.unfold`` views and laid out as the
``(M, K)`` im2col matrix with K ordered ``(kh, kw, cin)``, the kernel's
row order; then ``torch._int_mm`` (cuBLASLt's int8 GEMM, int32 sums) against
the kernel viewed as ``(cout, K)`` and transposed. ``_int_mm`` takes M > 16
and K and N multiples of 8 (torch 2.11+cu128 on the H100); K and N are
zero-padded to a multiple of 8 and M to 17 where smaller, which adds only
zeros to each integer sum, so the result is exact. A 1x1 stride-1 conv needs
no im2col copy: the activation is already the matrix.

The plain version (``plain_int8_matmul``) multiplies the same im2col matrix
and kernel in float64: every s32 sum is exact there, since ``|acc| <= K *
127**2`` (9,216 * 127² ≈ 1.5e8 at the widest 3x3 of the flagship) is far
below 2**53. A CPU tensor takes it; a CUDA tensor takes the route or raises:
nothing falls back. ``LAUNCHES`` counts the route's GEMMs.

What bounds the route on the H100: the int8 tensor-core rate (1,979 TOP/s)
for the wide layers, the im2col's bytes (K times the activation, written and
read again) for the early ones; the im2col copy is the cost a direct int8
convolution kernel would save.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from keras_object_detection_torch.models.layers import same_padding

LAUNCHES = 0

Padding = Union[int, str]  # symmetric zero padding, or XLA's "SAME"


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_nhwc(x: torch.Tensor, kernel: int, stride: int,
             pad: Padding) -> torch.Tensor:
    """``x`` (NHWC) zero-padded for a VALID conv: ``pad`` on every side, or
    ``"SAME"`` as XLA pads it (the low side the smaller half)."""
    if pad == "SAME":
        (top, bottom), (left, right) = (same_padding(x.shape[1], kernel, stride),
                                        same_padding(x.shape[2], kernel, stride))
    else:
        top = bottom = left = right = int(pad)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (0, 0, left, right, top, bottom))


def im2col(xq: torch.Tensor, kernel: int, stride: int,
           pad: Padding) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """``(A, (B, Ho, Wo))``: the ``(M, K8)`` patch matrix of the NHWC
    ``xq`` (M = B*Ho*Wo, K = kernel² * cin ordered (kh, kw, cin), zero
    columns up to K8, the next multiple of 8)."""
    xp = pad_nhwc(xq, kernel, stride, pad)
    b, h, w, c = xp.shape
    ho, wo = (h - kernel) // stride + 1, (w - kernel) // stride + 1
    k = kernel * kernel * c
    k8 = _round_up(k, 8)
    if kernel == 1 and stride == 1 and k8 == k:
        return xp.reshape(b * h * w, c), (b, h, w)
    patches = (xp.unfold(1, kernel, stride).unfold(2, kernel, stride)
               .permute(0, 1, 2, 4, 5, 3))  # (B, Ho, Wo, kh, kw, C)
    if k8 == k:
        return patches.reshape(b * ho * wo, k), (b, ho, wo)
    a = xq.new_zeros((b * ho * wo, k8))
    a[:, :k].view(b, ho, wo, kernel, kernel, c).copy_(patches)
    return a, (b, ho, wo)


def _kernel_matrix(w_q: torch.Tensor, k8: int) -> torch.Tensor:
    """The OHWI kernel as ``(N8, K8)``: zero rows and columns up to
    multiples of 8."""
    w = w_q.reshape(w_q.shape[0], -1)
    n, k = w.shape
    n8 = _round_up(n, 8)
    if (n8, k8) != (n, k):
        w = F.pad(w, (0, k8 - k, 0, n8 - n))
    return w


def plain_int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` of int8 ``(M, K)`` and ``(N, K)`` as int32, in float64
    (exact, see the module note)."""
    return (a.double() @ w.double().t()).to(torch.int32)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` of int8 ``(M, K)`` and ``(N, K)`` as int32 ``(M, N)``: on
    a CUDA tensor ``torch._int_mm`` (K and N multiples of 8, as ``im2col``
    and ``_kernel_matrix`` leave them; M padded to 17 where smaller), on a
    CPU tensor the plain version."""
    global LAUNCHES
    if a.device.type == "cpu":
        return plain_int8_matmul(a, w)
    if not a.is_cuda:
        raise ValueError(f"no int8 GEMM for device {a.device}")
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    out = torch._int_mm(a, w.t())
    LAUNCHES += 1
    return out[:m]


def int8_conv2d(xq: torch.Tensor, w_q: torch.Tensor, stride: int,
                pad: Padding) -> torch.Tensor:
    """The NHWC int32 accumulator of the conv of int8 ``xq`` (NHWC) with the
    int8 OHWI kernel ``w_q``, zero-padded by ``pad`` (or ``"SAME"``)."""
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8_conv2d takes int8 operands, got {xq.dtype} "
                         f"and {w_q.dtype}")
    cout, kernel = w_q.shape[0], w_q.shape[1]
    a, (b, ho, wo) = im2col(xq, kernel, stride, pad)
    acc = int8_matmul(a, _kernel_matrix(w_q, a.shape[1]))
    return acc[:, :cout].reshape(b, ho, wo, cout)
