"""What the port's exp/ scripts share: the ``--device`` flag beside the JAX
scripts' own arguments, the synchronize before a clock is read, and the
default run directories.

The JAX scripts take their positional arguments from ``sys.argv`` with every
``--flag`` filtered out; the port's scripts keep that, after taking
``--device X`` (or ``--device=X``) out first, so that X is not read as a
positional argument.  Where a JAX script defaults to a directory under
``/tmp``, the port's script takes the same name under
``tempfile.gettempdir()`` (``/tmp`` unless ``TMPDIR`` says otherwise).
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import List, Optional, Tuple

import torch


def split_device(argv: Optional[List[str]] = None) -> Tuple[List[str], str]:
    """(argv less the --device flag and its value, the device: cuda unless
    the flag says otherwise)."""
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    rest: List[str] = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--device":
            if i + 1 >= len(args):
                raise SystemExit("--device takes a value: cuda or cpu")
            device = args[i + 1]
            i += 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return rest, device


def positional(args: List[str]) -> List[str]:
    """The JAX scripts' positional arguments: every one not a --flag."""
    return [a for a in args if not a.startswith("--")]


def sync(dev: torch.device) -> None:
    """Wait for the card before a clock is read (nothing on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tmp_path(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)
