"""PyTorch/CUDA port of text2protein_tpu.

A second package beside the JAX one, with the same module names. It imports
torch, numpy and the standard library only; each Pallas kernel of the JAX
package is a CUDA kernel here (`ops/csrc/`), built with nvcc at first use.

Entry points run on the GPU unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default, and an error when
    there is none. The CPU is used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def use_full_f32() -> None:
    """The port's precision policy on the GPU, a process-wide setting: full
    float32 where the JAX package computes in f32 (TF32 off for matmuls and
    cuDNN convolutions), and f32 accumulation of bf16 products (cuBLAS may
    otherwise reduce a bf16 matmul's partial sums in bf16; XLA accumulates
    them in f32), with cuDNN's per-shape algorithm search on. Without the
    search, cuDNN's heuristic takes FFT algorithms for some f32 convolutions
    of the UNet that are ~70x slower on an H100."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
