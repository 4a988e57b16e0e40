"""The port's device rule: CUDA unless the caller asks for the CPU.

Nothing in the port picks the CPU by itself. An entry point given
`device=None` runs on the CUDA card and raises when there is none; the CPU
is used only when the caller names it (the CPU tests do)."""

from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the torch.device an entry point runs on.

    None means "cuda". A CUDA device without an available card raises a
    RuntimeError instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "libcml_tpu_torch runs on a CUDA device by default, and CUDA is "
            "not available here; pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=256)
def const(values: tuple, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A small constant tensor made once per device and reused.

    Building `torch.tensor([...], device="cuda")` copies from the host and
    waits for it on every call; hot loops take their constants from here.
    The result is shared: never write to it."""
    return torch.tensor(values, dtype=dtype, device=device)
