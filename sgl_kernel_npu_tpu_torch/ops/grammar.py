"""Grammar-constrained decoding: apply_token_bitmask (counterpart of the JAX
package's ops/grammar.py). Plain PyTorch, as the JAX function is plain jnp.

The xgrammar-style packed int32 bitmask: bit b of word w guards vocab column
w * 32 + b (bit 31 is the sign bit of the int32 word); a 0 bit masks its
logit to -inf.
"""

from __future__ import annotations

import torch


def apply_token_bitmask(logits, bitmask, indices=None):
    """logits [B, V]; bitmask [Bm, ceil(V / 32)] int32; indices [Bm]
    optional: row indices[i] of logits takes bitmask row i, and rows no
    index names stay unmasked (an index of -1 or past B is dropped, as the
    JAX scatter's mode="drop" with wrapped negative indices drops it).
    Returns the masked logits."""
    b, v = logits.shape
    cols = torch.arange(v, dtype=torch.int32, device=logits.device)
    words = bitmask.to(torch.int32)[:, (cols // 32).long()]
    allowed = ((words >> (cols % 32)) & 1).bool()                  # [Bm, V]
    neg = torch.full_like(logits, float("-inf"))
    if indices is None:
        return torch.where(allowed, logits, neg)
    idx = indices.long()
    idx = torch.where(idx < 0, idx + b + 1, idx)
    idx = torch.where((idx >= 0) & (idx <= b), idx, b)   # row b is dropped
    full = torch.ones((b + 1, v), dtype=torch.bool, device=logits.device)
    full[idx] = allowed
    return torch.where(full[:b], logits, neg)
