"""Core of the PyTorch port: task graphs, generators, imodes, cluster
naming, the reference event loop (simulator, workers, network models,
schedulers) and the vectorized simulator (``core.vectorized``)."""
from .taskgraph import TaskGraph, Task, DataObject, MiB, GiB, merge_graphs
from .cluster import parse_cluster, w_bucket
from .netmodels import (SimpleNetModel, MaxMinFlowNetModel, make_netmodel,
                        maxmin_fairness, Flow, NETMODELS)
from .imodes import make_imode, IMODES
from .worker import Worker, Assignment
from .simulator import (Simulator, Report, run_single_simulation,
                        resolve_workers)
from .schedulers import SCHEDULERS, make_scheduler

__all__ = [
    "TaskGraph", "Task", "DataObject", "MiB", "GiB", "merge_graphs",
    "parse_cluster", "w_bucket",
    "SimpleNetModel", "MaxMinFlowNetModel", "make_netmodel",
    "maxmin_fairness", "Flow", "NETMODELS", "make_imode", "IMODES",
    "Worker", "Assignment", "Simulator", "Report", "run_single_simulation",
    "resolve_workers", "SCHEDULERS", "make_scheduler",
]
