"""Triangular inverse of the chunked GDN pipeline (counterpart of the JAX
package's ops/gdn/tri_inv.py). Plain PyTorch, as the JAX package leaves it
to XLA.

The GDN use is always (I - A)^{-1} for a STRICTLY lower-triangular A. A is
nilpotent, so the inverse is the finite Neumann series, taken in
ceil(log2(n)) products by repeated squaring: (I - A)^{-1} = (I + A)(I +
A^2)(I + A^4)... The sequence of products is the JAX package's step for
step (`out + out @ p`, in that order), not torch.linalg's solver, which
rounds otherwise; the chunked GDN compounds any such difference.
"""

from __future__ import annotations

import torch


def inv_unit_lower(a: torch.Tensor) -> torch.Tensor:
    """Inverse of (I - A) for strictly-lower-triangular A ([..., n, n])."""
    n = a.shape[-1]
    out = torch.eye(n, dtype=a.dtype, device=a.device) + a
    p = a
    for _ in range(max(1, (n - 1).bit_length()) - 1):
        p = torch.matmul(p, p)
        out = out + torch.matmul(out, p)
    return out


def tri_inv_col_sweep(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit-diagonal lower-triangular matrix m = I - A_strict
    ([..., n, n])."""
    n = m.shape[-1]
    a = torch.tril(-(m - torch.eye(n, dtype=m.dtype, device=m.device)), diagonal=-1)
    return inv_unit_lower(a)


def solve_tril(a: torch.Tensor) -> torch.Tensor:
    """(I - A)^{-1} of the strict lower triangle of A: the form
    chunk_gated_delta_rule consumes."""
    return inv_unit_lower(torch.tril(a, diagonal=-1))
