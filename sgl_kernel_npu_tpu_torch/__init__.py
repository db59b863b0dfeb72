"""sgl_kernel_npu_tpu_torch — the PyTorch/CUDA port of sgl_kernel_npu_tpu for
one NVIDIA H100 (sm_90a).

The JAX package beside it is the reference. Each TPU kernel of a ported path
is a hand-written CUDA kernel (csrc/, built by _build.py with nvcc on first
use) with a plain PyTorch version in the same module: a CUDA tensor launches
the kernel, a CPU tensor runs the plain version.

Subpackages:
  ops       W8A8 GEMMs (plain, stacked, pretiled, grouped, fused
            RMSNorm-quant), soft-FP8 W8A16 GEMMs (dense, grouped), int8 and
            block fp8 quant, RoPE, paged attention and appends (Llama tm /
            tm2 pages, MLA combined and split latent pages, head-major
            pages), mla_preprocess, gdn, swiglu_quant, helloworld
  models    Llama-3-class, DeepSeek-V2-class MLA and Qwen3-Next-class W8A8
            decoders, their f32 twins and the quantisation delta (quant_ref)
  parallel  the expert-parallel MoE layer: Buffer, its dispatch / combine
            strategies, the fused layer (composition and one launch)
  runtime   ctypes bindings of the native scheduler (csrc/runtime.cpp)
  serving   LlamaEngine and MlaEngine: continuous batching, radix prefix reuse
  utils     env flags, device selection, H100 roofline numbers
  memsaver  MemorySaver: tag-scoped pause / resume of device tensors
  compat    the reference's op names (the JAX package's compat.py table)
  attic     the retired v4 / v5 / v7 decodes of the repository's attic/
            (not imported here, as the JAX package does not import attic/)
"""

from .version import __version__  # noqa: F401
