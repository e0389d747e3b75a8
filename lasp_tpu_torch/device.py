"""Device resolution shared by every entry point of the port.

``device=None`` means CUDA: on a rank of a process group launched with
``LOCAL_RANK`` set, the card ``cuda:(LOCAL_RANK % device_count)``, else the
current card. Without a CUDA device that is an error: the port never
carries on on the CPU unless the caller asked for it with ``device="cpu"``
(the tests do), on a rank or not.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point should allocate on."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lasp_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU"
            )
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            return torch.device("cuda")
        return torch.device("cuda", int(local) % torch.cuda.device_count())
    return torch.device(device)


def same_device(a, b) -> bool:
    """Whether two devices are one (``"cuda"`` is the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.index == b.index:
        return True
    if a.type != "cuda":
        return False
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (
        current if b.index is None else b.index)
