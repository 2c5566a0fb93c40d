"""Batched products with float32 sums over low-precision operands, shared
by the model families and the plain versions of the hand-written kernels.
Nothing here is a kernel of its own: on the card the library's product
takes bfloat16 operands on the tensor cores and writes float32."""

from __future__ import annotations

import torch


class _BmmF32(torch.autograd.Function):
    """Batched product of low-precision CUDA operands with float32 outputs
    at tensor-core speed (``torch.bmm(..., out_dtype=torch.float32)``,
    which has no autograd formula of its own); the backward's products run
    in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.bmm(g, b.transpose(1, 2)), torch.bmm(a.transpose(1, 2), g)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) → float32 (E, M, N), products summed in
    float32. On the card, bfloat16 operands stay bfloat16 (tensor cores);
    on the CPU they are widened first. ``meta`` tensors take the card's
    branch, so a work count on ``meta`` (:mod:`repro_torch.launch`) counts
    the card's operations."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda or a.is_meta:
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())
