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
