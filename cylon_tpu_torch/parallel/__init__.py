from .task import LogicalTaskPlan, task_partition  # noqa: F401
