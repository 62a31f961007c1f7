"""Where the port's models live: on the card unless the caller asks otherwise."""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """`device` as a torch.device.

    A CUDA device with no card present raises: the port never moves a model
    to the CPU behind the caller's back (pass device="cpu" for that).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for, but torch sees no CUDA device; "
                           "pass device='cpu' to run on the CPU")
    return dev
