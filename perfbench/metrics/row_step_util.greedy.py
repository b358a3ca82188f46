"""Share of a grid call's row-steps that advance a live row: the rows'
own ``n_steps`` over rows x the call's loop steps."""
from perfbench.readers import row_step_util


def read(run):
    return row_step_util(run)
