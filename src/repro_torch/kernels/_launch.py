"""What a kernel wrapper of the port needs around a launch on the host:
the device made current only when it is not, and the raw handle of the
device's current stream.  Decode steps and the simulator's event steps
call the wrappers many times, on the host's clock."""
from __future__ import annotations

import contextlib

import torch


def on_device(dev):
    """The context that makes ``dev`` current for a launch (none when it
    already is)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def raw_stream(dev):
    """The raw handle of ``dev``'s current stream (what
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, without making
    a ``Stream`` object on every call)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)
