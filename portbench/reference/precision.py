"""TF32, the precision one step below the configurations' float32 with
TF32 off: the control of the correctness check runs the reference under
`tf32()`.

TF32 keeps 10 of float32's 23 mantissa bits in the operands of a matrix
product and sums in float32.  `tf32()` rounds the float32 operands of every
matrix product the code under it makes (matmul, `@`, mm, bmm, einsum,
linear, addmm, baddbmm) to 10 bits, to nearest, ties to even, on any
device; on a card it also lets cuBLAS use its own TF32 path.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.mm, torch.Tensor.mm, torch.bmm,
             torch.Tensor.bmm, torch.einsum, torch.nn.functional.linear,
             torch.addmm, torch.baddbmm, torch.tensordot}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 with the low 13 mantissa bits rounded away."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32).reshape(x.shape)


class _Tf32Mode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple([round_tf32(a) for a in a_]
                         if isinstance(a_, (list, tuple)) else round_tf32(a_)
                         for a_ in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def tf32():
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32, torch.backends.cudnn.allow_tf32
    m.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with _Tf32Mode():
            yield
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def fp32():
    """Full float32: TF32 off for the block (the reference's precision)."""
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32, torch.backends.cudnn.allow_tf32
    m.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
