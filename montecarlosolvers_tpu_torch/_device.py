"""The one place where the port turns `device=None` into a device.

Every public function of the port that takes `device=None` builds on the
CUDA card when it is given no device. On a host without CUDA such a call
raises instead of carrying on on the CPU: the plain PyTorch versions run on
the host only when the caller asks for it with `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve(device):
    """`device` as a torch.device; None means `torch.device("cuda")`, and
    raises RuntimeError when torch sees no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device=None means the CUDA device, and torch sees none; pass "
            "device='cpu' to run the plain PyTorch versions on the host"
        )
    return torch.device("cuda")
