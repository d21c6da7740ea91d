"""Device selection shared by every entry point of the port.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.  Asking
for CUDA on a machine without a GPU raises: the port never carries on on the
CPU by itself.  The CPU runs only when the caller asks for it (the tests do),
and then every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
