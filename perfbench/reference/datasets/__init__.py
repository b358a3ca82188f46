"""Datasets that a configuration brings in a file of its own.

A configuration whose ``dataset`` is not one of
``generators.DATASETS`` (the frozen elementary and pegasus generators)
names a file here: ``<dataset>.py``, loaded by path
(``generators.make_graph``).  The file defines ``GRAPHS``, a dict of
``name -> fn(seed) -> TaskGraph``; like the frozen generators, each
function fixes the graph's structure (tasks, objects, edges, cores)
and draws its durations, sizes and ``user`` estimates from ``seed``.
It imports what it needs by absolute name (``perfbench.reference.
taskgraph``, ``perfbench.reference.generators``'s helpers) and nothing
of the program.  Adding a dataset is one new file here, with the
configuration's file and its entry in ``BENCHMARK.json``.
"""
