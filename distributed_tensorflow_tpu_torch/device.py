"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run there or raise: the
CPU is used only when a caller names it (``device="cpu"``), as the tests
do, so a host without a card never serves from its CPU by accident.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; pass device='cpu' to "
                "run on the CPU explicitly"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        # "meta": a template with no storage, whose every value the caller
        # loads (the serving engines' models).
        raise ValueError(f"unsupported device {dev} (cuda, cpu or meta)")
    return dev
