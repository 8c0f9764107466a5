"""Query planning: index selection, execution and refinement."""

from geomesa_tpu_torch.planning.explain import Explainer
from geomesa_tpu_torch.planning.planner import QueryPlan, QueryPlanner

__all__ = ["Explainer", "QueryPlan", "QueryPlanner"]
