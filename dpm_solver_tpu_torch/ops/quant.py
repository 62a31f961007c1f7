"""Dynamic int8 (W8A8) products for serving.

Port of `dpm_solver_tpu/ops/quant.py`, step for step:

  * weights:      per-output-channel symmetric absmax scales,
  * activations:  per-token (row) symmetric absmax scales computed on the
                  fly (no calibration data), per image for the 3x3 conv,
  * accumulation: int32, rescaled in fp32 (`acc * (sx * sw)`, then the
                  bias), returned in the caller's compute dtype.

The scale is amax / 127 in fp32 (1 where amax <= 1e-12), the codes
clip(round(x / scale), -127, 127) with round half to even (`torch.round`,
as `jnp.round`). Weights stay fp32 in the modules and are quantized inside
every call, as in the JAX package: state dicts and checkpoints do not change.

No hand-written kernel: the JAX package computes these products in XLA
(`dot_general` / `conv_general_dilated` with int32 accumulation, no Pallas),
and the port computes them with `torch._int_mm` (cuBLASLt's int8 product
with int32 accumulation on the card, the same call on the CPU). Its shape
rules on the card (more than 16 rows; K and N multiples of 8) are met by
zero padding, which leaves the int32 result exact; a shape it still refuses
raises, nothing falls back to a float product. The weight goes in as the
transpose of a row-major (N, K) matrix, the "TN" layout cuBLASLt's int8
path takes. Nothing here reads a value back to the host, so the products
run inside a captured CUDA graph.

`w8a8_conv` gathers the 9 taps of the zero-padded int8 input in NHWC into a
(B*H*W, 9*C) int8 matrix, a few images at a time (at most `CONV_CHUNK_BYTES`
of it at once), and multiplies it by the (9*C, CO) int8 weight: the int32
sums equal XLA's int8 convolution's exactly on equal codes.

Weight layouts are the port's: `w8a8_matmul` and `w8a8_geglu` take torch's
Linear layout (N, K) (the JAX functions take the transpose), `w8a8_conv`
the (3, 3, C, CO) HWIO kernel, as `conv3x3` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

QUANT_MODES = (None, "w8a8", "w8a8_conv")
# "w8a8": transformer projections + GEGLU FF only.
# "w8a8_conv": additionally the 3x3 conv trunk (per-image activation
#              scales there: conv outputs mix spatial positions, so per-token
#              scales cannot factor out).

# the largest im2col block `w8a8_conv` builds at once (int8 bytes)
CONV_CHUNK_BYTES = 1 << 30


def check_mode(mode) -> None:
    if mode not in QUANT_MODES:
        raise ValueError(f"Unknown quant mode {mode!r}; one of {QUANT_MODES}")


def wants_dense_quant(mode) -> bool:
    return mode in ("w8a8", "w8a8_conv")


def wants_conv_quant(mode) -> bool:
    return mode == "w8a8_conv"


def _absmax_scale(x: torch.Tensor, dim, eps: float = 1e-12) -> torch.Tensor:
    """Symmetric absmax scale over `dim` (kept dims), fp32; 1 for an
    all-zero slice."""
    amax = x.float().abs().amax(dim=dim, keepdim=True)
    return torch.where(amax > eps, amax / 127.0, torch.ones_like(amax))


def quantize(x: torch.Tensor, dim) -> tuple:
    """Symmetric int8 codes and their fp32 absmax scales over `dim`."""
    scale = _absmax_scale(x, dim)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def int8_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b_t.T, b_t (N, K) int8 -> (M, N) int32, exact.

    `torch._int_mm` on either device, with M padded to 32 rows when it has
    16 or fewer and K and N to multiples of 8, by zeros (the card's rules;
    the zeros add nothing)."""
    m, k = a.shape
    n = b_t.shape[0]
    mp, kp, np_ = (m if m > 16 else 32), _pad_to(k, 8), _pad_to(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b_t = F.pad(b_t, (0, kp - k, 0, np_ - n))
    acc = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return acc[:m, :n] if (mp, np_) != (m, n) else acc


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(..., K) @ w.T, w (N, K), with per-row activation and per-output
    weight int8 codes.

    Exact for integer-valued operands within [-127, 127] (their scales are
    1 when the absmax is 127); for real activations the per-token scales
    bound the relative quantization noise to ~1%."""
    out_dtype = out_dtype or x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    xq, sx = quantize(x.reshape(-1, k), dim=1)       # sx: (M, 1)
    wq, sw = quantize(w, dim=1)                      # sw: (N, 1)
    acc = int8_mm(xq, wq)
    out = acc.float() * (sx * sw.reshape(1, -1))
    if bias is not None:
        out = out + bias.float()
    return out.reshape(*lead, w.shape[0]).to(out_dtype)


def w8a8_conv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """3x3 stride-1 SAME NHWC conv, x (B, H, W, C), w (3, 3, C, CO), with a
    per-image activation scale and per-output-channel weight scales, int32
    accumulation. A zero kernel stays exact (its channels quantize to 0
    under the guarded scale)."""
    out_dtype = out_dtype or x.dtype
    b, h, wd, c = x.shape
    co = w.shape[-1]
    xq, sx = quantize(x, dim=(1, 2, 3))              # (B, 1, 1, 1)
    wq, sw = quantize(w, dim=(0, 1, 2))              # (1, 1, 1, CO)
    w_t = wq.permute(3, 0, 1, 2).reshape(co, 9 * c)  # (CO, 9C): tap-major, then C
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    per_image = h * wd * 9 * c
    step = max(1, CONV_CHUNK_BYTES // per_image)
    accs = []
    for i in range(0, b, step):
        part = xp[i:i + step]
        cols = torch.cat([part[:, dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)],
                         dim=-1)
        accs.append(int8_mm(cols.reshape(-1, 9 * c), w_t))
    acc = (accs[0] if len(accs) == 1 else torch.cat(accs)).reshape(b, h, wd, co)
    out = acc.float() * (sx.reshape(-1, 1, 1, 1) * sw.reshape(1, 1, 1, -1))
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def w8a8_geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
               b2: torch.Tensor) -> torch.Tensor:
    """The int8 twin of `ops.geglu_ff` (the same [h | gate] row halves of w1
    (2 * inner, d); w2 (d, inner)): both projections W8A8, the exact-gelu
    gate in fp32, the gated product cast to x's dtype."""
    from dpm_solver_tpu_torch.ops.geglu import gelu_exact

    inner = w2.shape[1]
    up = w8a8_matmul(x, w1, b1, out_dtype=torch.float32)
    h, gate = up[..., :inner], up[..., inner:]
    hg = (h * gelu_exact(gate)).to(x.dtype)
    return w8a8_matmul(hg, w2, b2, out_dtype=x.dtype)


class QuantLinear(nn.Linear):
    """`nn.Linear` (the same state dict) computed W8A8, the output in
    `compute_dtype`. The input is quantized as it comes (fp32 or the compute
    dtype), as the JAX `QuantDense` does."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return w8a8_matmul(x, self.weight, self.bias, out_dtype=self.compute_dtype)

