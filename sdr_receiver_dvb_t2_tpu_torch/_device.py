"""Host constants (tables, weights) copied once to each device they are
used on, and the device check of the port's entry points."""
from __future__ import annotations

import numpy as np
import torch


class DeviceConst:
    """A numpy constant and its copies on the devices that asked for it."""

    def __init__(self, host: np.ndarray):
        self.host = torch.from_numpy(np.ascontiguousarray(host))
        self._on: dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self.host.to(device)
            self._on[device] = t
        return t


def resolve(device, what: str, cli: bool = False) -> torch.device:
    """`device` as a torch.device.  A CUDA device with no card is refused:
    an entry point runs on the card unless its caller asks for the CPU,
    and never moves there on its own.  `what` names the entry point; the
    refusal is a RuntimeError, or with `cli` a SystemExit carrying the
    message (exit code 1)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        msg = (f"no CUDA device: {what} runs on the card, and on the CPU "
               f"only when asked for it")
        raise SystemExit(msg) if cli else RuntimeError(msg)
    return dev
