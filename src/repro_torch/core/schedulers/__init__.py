"""Scheduler registry (paper §4.3) of the PyTorch port: the reference's
19 names (``repro.core.schedulers``), served by copies of its
framework-free scheduler modules and, for ``genetic-vec``, by the
port's ``GeneticVectorizedScheduler``, which scores its population on
the port's static simulator (``device`` defaults to ``"cuda"``)."""
from .base import SchedulerBase
from .list_schedulers import (BlevelScheduler, TlevelScheduler, MCPScheduler,
                              DLSScheduler, ETFScheduler)
from .gt import BlevelGTScheduler, TlevelGTScheduler, MCPGTScheduler
from .others import (SingleScheduler, RandomScheduler, WorkStealingScheduler,
                     GeneticScheduler)
from .fixed import FixedScheduler
from .det import (DetBlevelScheduler, DetTlevelScheduler, DetMCPScheduler,
                  DetETFScheduler, DetRandomScheduler, GreedyWorkerScheduler)
from .genetic_vectorized import GeneticVectorizedScheduler


SCHEDULERS = {
    "blevel": BlevelScheduler,
    "blevel-det": DetBlevelScheduler,
    "greedy": GreedyWorkerScheduler,
    "blevel-gt": BlevelGTScheduler,
    "tlevel": TlevelScheduler,
    "tlevel-det": DetTlevelScheduler,
    "tlevel-gt": TlevelGTScheduler,
    "mcp": MCPScheduler,
    "mcp-det": DetMCPScheduler,
    "mcp-gt": MCPGTScheduler,
    "dls": DLSScheduler,
    "etf": ETFScheduler,
    "etf-det": DetETFScheduler,
    "genetic": GeneticScheduler,
    "genetic-vec": GeneticVectorizedScheduler,
    "ws": WorkStealingScheduler,
    "single": SingleScheduler,
    "random": RandomScheduler,
    "random-det": DetRandomScheduler,
}


def make_scheduler(name: str, seed: int = 0, **kw) -> SchedulerBase:
    return SCHEDULERS[name](seed=seed, **kw)


__all__ = ["SCHEDULERS", "make_scheduler", "SchedulerBase", "FixedScheduler",
           "BlevelScheduler", "TlevelScheduler", "MCPScheduler",
           "DLSScheduler", "ETFScheduler", "BlevelGTScheduler",
           "TlevelGTScheduler", "MCPGTScheduler", "SingleScheduler",
           "RandomScheduler", "WorkStealingScheduler", "GeneticScheduler",
           "GeneticVectorizedScheduler",
           "DetBlevelScheduler", "DetTlevelScheduler", "DetMCPScheduler",
           "DetETFScheduler", "DetRandomScheduler", "GreedyWorkerScheduler"]
