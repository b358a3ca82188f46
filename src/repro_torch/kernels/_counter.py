"""The launch counter every kernel wrapper of the port keeps."""
from __future__ import annotations


class LaunchCounter:
    """A plain launch counter: ``count`` goes up by one per launch."""

    def __init__(self):
        self.count = 0

    def reset(self):
        self.count = 0
