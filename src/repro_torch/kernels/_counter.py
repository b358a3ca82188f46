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

    def mark(self):
        """The counts now, for ``take_since``."""
        return self.count, dict(self.routes)

    def take_since(self, mark):
        """Take off, and return, the launches added since ``mark``.  A
        CUDA graph's capture records launches without running them:
        they come off here, and each replay of the graph adds them back
        (``add_recorded``)."""
        count, routes = mark
        taken = (self.count - count,
                 {r: n - routes[r] for r, n in self.routes.items()})
        self.count = count
        self.routes.update(routes)
        return taken

    def add_recorded(self, taken):
        """Add the launches ``take_since`` took: one replay's worth."""
        count, routes = taken
        self.count += count
        for r, n in routes.items():
            self.routes[r] += n
