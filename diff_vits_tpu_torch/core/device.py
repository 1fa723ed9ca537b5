"""Device policy of the port's entry points.

Entry points run on the card unless the caller names another device. With
no card and no explicit device they raise: there is no silent CPU path.
Under a ``torch.distributed`` process group the card is the rank's own,
``cuda:LOCAL_RANK`` (torchrun sets ``LOCAL_RANK``).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (the rank's card under a process group);
    anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dist.is_initialized():
            return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        return torch.device("cuda")
    return torch.device(device)
