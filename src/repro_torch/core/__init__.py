"""Core of the PyTorch port: task graphs, generators, imodes, cluster
naming and the vectorized simulator (``core.vectorized``)."""
from .taskgraph import TaskGraph, Task, DataObject, MiB, GiB, merge_graphs
from .cluster import parse_cluster, w_bucket

__all__ = ["TaskGraph", "Task", "DataObject", "MiB", "GiB", "merge_graphs",
           "parse_cluster", "w_bucket"]
