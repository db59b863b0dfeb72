"""mla_preprocess: the MLA pre-attention fusion (counterpart of the JAX
package's ops/mla_preprocess.py).

  RMSNormQuant(hidden; gamma0, beta0; qscale0, qoffset0)  -> int8
  GEMM wdqkv [hidden -> kv_lora + rope + q_lora] + bias0, dequant descale0
  split -> latent [ctkv | krope], cq
  RMSNorm(cq; gamma1) + beta1 -> quant(qscale1, qoffset1)
  GEMM wuq [q_lora -> H * (nope + rope)] + bias1, dequant descale1
  split per head -> q_nope | q_pe
  RMSNorm(ctkv; gamma2); RoPE(q_pe, k_pe) (rotate-half)
  q_nope [H, nope] x wuk [H, nope, kv_lora] -> q_nope' [H, kv_lora]
  reshape_and_cache(ctkv, krope; slot_mapping)

Cache modes (the reference's cache_mode), each writing its caches in place:
  "krope_ctkv"   split caches [pages, ps, kv_lora] + [pages, ps, rope]; q_nope
                 returned [N, H, kv_lora] in hidden's dtype
  "full"         one combined cache [pages, ps, kv_lora + rope] (ctkv | krope,
                 576 wide for DeepSeek); q returned packed [N, H, kv_lora +
                 rope] as q_nope (q_pe also alone), krope_cache None
  "int8_nzcache" split caches with an int8 ctkv cache: ctkv divided by the
                 per-tensor ctkv_scale, q_nope MULTIPLIED by the per-head
                 q_nope_scale [H], each rounded to fp16, clamped to
                 [-128, 127] and rounded half to even there; q_nope returned
                 int8. The reference's NZ layout is an Ascend data format;
                 the logical [pages, ps, D] layout is kept, as in the JAX
                 package.
quant_mode "per_tensor" (static asymmetric, the value rounded to fp16 before
rint: the reference's quant_per_tensor) or "per_token".

With `wdqkv_kn` / `wuq_kn` ([in, out] copies of the two GEMM weights, made
once by models/deepseek_mla.py::fuse_mla_weights), each RMSNormQuant->GEMM
stage runs as one call of the fused GEMM (ops/rmsq_gemm.py: kernel K2 on the
card, its plain version on the CPU). Without them the stages run unfused,
as below: the same formula, but with rstd from torch.rsqrt where K2 takes it
correctly rounded in float64 (ops/rmsq_gemm.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .kvcache import _put_rows, reshape_and_cache_mla
from .quant import per_token_quant_int8
from .rmsq_gemm import rmsnorm_quant_gemm


class MlaPreprocessOut(NamedTuple):
    q_nope: torch.Tensor            # [N, H, kv_lora] (int8 in int8_nzcache; packed
                                    # [N, H, kv_lora + rope] in full)
    q_pe: torch.Tensor              # [N, H, rope]
    kv_cache: torch.Tensor          # the ctkv (or combined) cache, updated in place
    krope_cache: Optional[torch.Tensor]   # None in full
    q_scale: Optional[torch.Tensor]  # always None, as in the JAX package


def _rms(x32, gamma, eps=1e-6):
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return x32 * torch.rsqrt(var + eps) * gamma.float()


def _quant_per_tensor(x32, scale, offset):
    """x / scale + offset, the division by a tensor (PyTorch's CUDA division
    by a Python number multiplies by its reciprocal)."""
    q = x32 / scale.float().reshape(()) + offset.float().reshape(())
    return _fp16_round_int8(q)


def _fp16_round_int8(q32):
    # the reference clamps in fp16, then rounds (quant_per_tensor)
    return torch.round(q32.to(torch.float16).clamp(-128, 127)).to(torch.int8)


def _gemm_dequant(a_int8, w_int8, descale, bias):
    """a [N, K] int8 x w [out, in] int8 (+ bias) -> f32, dequantized. The sum
    is exact in float64 (every partial sum is an integer below 2**53)."""
    acc = a_int8.double() @ w_int8.double().t()
    if bias is not None:
        acc = acc + bias.double()
    return acc.float() * descale.float()


def rotate_half_rope(x, cos, sin):
    """x [..., R] with cos/sin [N, R] broadcast over heads; f32 out."""
    x32 = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return x32 * cos.float() + rot * sin.float()


def mla_preprocess(
    hidden, gamma0, beta0, wdqkv, descale0,
    gamma1, beta1, wuq, descale1, gamma2,
    cos, sin, wuk, kv_cache, krope_cache, slot_mapping,
    quant_scale0, quant_offset0, bias0,
    quant_scale1, quant_offset1, bias1,
    ctkv_scale=None, q_nope_scale=None,
    cache_mode: str = "krope_ctkv", quant_mode: str = "per_tensor",
    apply_norm0: bool = True,
    wdqkv_kn=None, wuq_kn=None,
):
    """hidden [N, hidden]; wdqkv [out, hidden] int8; wuq [H*(nope+rope),
    q_lora] int8; wuk [H, nope, kv_lora]; caches [pages, page_size, D],
    written in place (bf16, or the int8 ctkv cache in int8_nzcache, which
    also takes the scalar ctkv_scale and q_nope_scale [H]). See the module
    docstring."""
    if cache_mode not in ("krope_ctkv", "full", "int8_nzcache"):
        raise ValueError(f"mla_preprocess: unknown cache_mode {cache_mode!r}")
    if quant_mode not in ("per_tensor", "per_token"):
        raise ValueError(f"mla_preprocess: unknown quant_mode {quant_mode!r}")
    n = hidden.shape[0]
    kn = gamma2.shape[0]
    kp = cos.shape[-1]
    qn = wuk.shape[1]
    per_tensor = quant_mode == "per_tensor"
    fused_tier = wdqkv_kn is not None and wuq_kn is not None
    cast = "fp16" if per_tensor else "f32"

    if fused_tier:
        # apply_norm0=False quantises the raw hidden state (no affine either)
        g0 = gamma0 if apply_norm0 else torch.ones_like(gamma0)
        b0 = beta0 if apply_norm0 else torch.zeros_like(beta0)
        fused = rmsnorm_quant_gemm(
            hidden, g0, b0, wdqkv_kn, descale0, bias0 if per_tensor else None,
            quant_scale0, quant_offset0, quant_mode=quant_mode,
            apply_norm=apply_norm0, quant_cast=cast)
    else:
        h32 = hidden.float()
        if apply_norm0:
            h32 = _rms(h32, gamma0) + beta0.float()
        if per_tensor:
            fused = _gemm_dequant(_quant_per_tensor(h32, quant_scale0, quant_offset0),
                                  wdqkv, descale0, bias0)
        else:
            hq, hs = per_token_quant_int8(h32)
            fused = _gemm_dequant(hq, wdqkv, descale0, None) * hs

    latent, cq = fused[:, : kn + kp], fused[:, kn + kp:]
    ctkv = _rms(latent[:, :kn], gamma2)
    k_pe = latent[:, kn:]

    if fused_tier:
        q_out = rmsnorm_quant_gemm(
            cq, gamma1, beta1, wuq_kn, descale1, bias1 if per_tensor else None,
            quant_scale1, quant_offset1, quant_mode=quant_mode, quant_cast=cast)
    else:
        cq = _rms(cq, gamma1) + beta1.float()
        if per_tensor:
            q_out = _gemm_dequant(_quant_per_tensor(cq, quant_scale1, quant_offset1),
                                  wuq, descale1, bias1)
        else:
            cqq, cqs = per_token_quant_int8(cq)
            q_out = _gemm_dequant(cqq, wuq, descale1, None) * cqs

    heads = q_out.shape[-1] // (qn + kp)
    q_out = q_out.reshape(n, heads, qn + kp)
    q_nope, q_pe = q_out[..., :qn], q_out[..., qn:]
    # EinSum wuk: [N, H, nope] x [H, nope, kv_lora] -> [N, H, kv_lora], f32
    q_nope = torch.einsum("nhd,hdk->nhk", q_nope, wuk.float())
    q_pe = rotate_half_rope(q_pe, cos[:, None, :], sin[:, None, :])
    k_pe = rotate_half_rope(k_pe, cos, sin)

    dtype = hidden.dtype
    if cache_mode == "full":
        _put_rows(kv_cache, slot_mapping, torch.cat([ctkv, k_pe], dim=-1).to(dtype))
        return MlaPreprocessOut(torch.cat([q_nope, q_pe], dim=-1).to(dtype), q_pe.to(dtype),
                                kv_cache, None, None)
    if cache_mode == "int8_nzcache":
        # per-head symmetric quant of q_nope: the scale MULTIPLIES here
        q_nope = _fp16_round_int8(q_nope * q_nope_scale.float()[None, :, None])
        ctkv_q = _quant_per_tensor(ctkv, torch.as_tensor(ctkv_scale, device=ctkv.device),
                                   torch.zeros((), device=ctkv.device))
        reshape_and_cache_mla(ctkv_q, k_pe.to(dtype), kv_cache, krope_cache, slot_mapping)
        return MlaPreprocessOut(q_nope, q_pe.to(dtype), kv_cache, krope_cache, None)
    reshape_and_cache_mla(ctkv.to(dtype), k_pe.to(dtype), kv_cache, krope_cache,
                          slot_mapping)
    return MlaPreprocessOut(q_nope.to(dtype), q_pe.to(dtype), kv_cache, krope_cache,
                            None)
