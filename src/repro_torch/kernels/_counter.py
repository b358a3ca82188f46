"""The launch counter every kernel wrapper of the port keeps."""
from __future__ import annotations


class LaunchCounter:
    """A plain launch counter: ``count`` goes up by one per launch.  A
    wrapper with several routes names them, and ``routes`` then counts
    the same launches by route."""

    def __init__(self, routes=()):
        self.count = 0
        self.routes = dict.fromkeys(routes, 0)

    def add(self, route=None):
        self.count += 1
        if route is not None:
            self.routes[route] += 1

    def reset(self):
        self.count = 0
        self.routes = dict.fromkeys(self.routes, 0)
