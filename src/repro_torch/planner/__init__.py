"""Scheduler-in-the-loop pipeline planning for the LM architectures (the
reference package's ``repro.planner``): a pipeline-parallel train step
as a task graph of the port's event-loop simulator, and a grid search
over plans ranked by simulated makespan."""
from .extract import PipelinePlan, plan_graph, plan_assignment
from .autotune import autotune, simulate_plan

__all__ = ["PipelinePlan", "plan_graph", "plan_assignment", "autotune",
           "simulate_plan"]
