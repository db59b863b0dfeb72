"""Sampling ops: temperature, top-k, top-p, min-p, penalties (counterpart of
the JAX package's ops/sampling.py). Plain PyTorch, as the JAX functions are
plain jnp: no kernel.

Every mask keeps the JAX rules: a dropped logit becomes -1e30; top-k keeps
every logit >= the k-th largest (ties at the k-th all survive); top-p sorts
stably by descending logit and keeps a token while the exclusive cumulative
probability before it is < p (the top token always survives); min-p drops
tokens whose probability is below min_p times the largest.

`sample` draws with an explicit torch.Generator on the logits' device, by
Gumbel-max: argmax(x + g), g = -log(-log(U)), which is the distribution
`jax.random.categorical` samples (not its random stream). U is kept inside
(0, 1) before the two logs, so g is finite.
"""

from __future__ import annotations

import torch

_NEG = -1e30
# U in [_U_LO, 1 - 2**-24]: -log(-log(U)) finite at both ends
_U_LO = 1e-20
_U_HI = 1.0 - 2.0 ** -24


def apply_temperature(logits, temperature):
    """logits [B, V] / temperature ([B] or scalar), in f32; the temperature
    is held at >= 1e-6 (0 means greedy, which `sample` handles)."""
    t = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    t = t.clamp_min(1e-6)
    if t.dim() == 1:
        t = t[:, None]
    return logits.float() / t


def top_k_mask(logits, k: int):
    """Keep the k highest logits per row, the rest -> -1e30. k <= 0 or
    k >= V keeps everything."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, torch.full_like(logits, _NEG))


def top_p_mask(logits, p: float):
    """Nucleus: keep the smallest prefix of the (stably) sorted distribution
    whose exclusive cumulative probability stays below p."""
    if p >= 1.0:
        return logits
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs          # exclusive
    keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(-1, sort_idx, cum < p)
    return torch.where(keep, logits, torch.full_like(logits, _NEG))


def min_p_mask(logits, min_p: float):
    """Drop tokens with probability < min_p * the largest (llama.cpp min-p)."""
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    thresh = min_p * probs.amax(dim=-1, keepdim=True)
    return torch.where(probs >= thresh, logits, torch.full_like(logits, _NEG))


def sample(logits, generator: torch.Generator, temperature=1.0, top_k: int = 0,
           top_p: float = 1.0, min_p: float = 0.0):
    """Token ids [B] int32 from logits [B, V]: temperature 0 (a Python
    number) is the argmax; otherwise temperature, the masks, then one
    Gumbel-max draw per row from `generator` (on the logits' device)."""
    if isinstance(temperature, (int, float)) and temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = apply_temperature(logits, temperature)
    x = top_k_mask(x, top_k)
    x = top_p_mask(x, top_p)
    x = min_p_mask(x, min_p)
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    g = -torch.log(-torch.log(u.clamp(_U_LO, _U_HI)))
    return torch.argmax(x + g, dim=-1).to(torch.int32)


def apply_penalties(logits, output_ids, output_len, presence_penalty=0.0,
                    frequency_penalty=0.0, repetition_penalty=1.0):
    """Presence / frequency (OpenAI) and repetition (CTRL) penalties over the
    tokens generated so far: logits [B, V]; output_ids [B, T] padded;
    output_len [B] valid counts. Returns f32 logits."""
    b, v = logits.shape
    t = output_ids.shape[1]
    valid = torch.arange(t, device=logits.device)[None, :] < output_len[:, None]
    ids = torch.where(valid, output_ids.long(), v)
    counts = torch.zeros((b, v + 1), dtype=torch.float32, device=logits.device)
    counts.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.float32))
    counts = counts[:, :v]
    seen = counts > 0

    x = logits.float()
    x = x - presence_penalty * seen.float()
    x = x - frequency_penalty * counts
    if repetition_penalty != 1.0:
        x = torch.where(seen, torch.where(x > 0, x / repetition_penalty,
                                          x * repetition_penalty), x)
    return x
