"""Load-based and SLA planners (autoscaler; port of `dynamo_tpu/planner/`).

Role of the reference's `components/planner`
(`planner/utils/planner_core.py:241-318`): observe worker load, predict
the near-term value, compute a replica target, and tell a connector to
converge on it.  The LOAD-based planner runs over our
control plane's `load_metrics` stream; the SLA planner's
TTFT/ITL-interpolation layer (`sla.py`, over `profiler.py`'s profile)
builds on the same skeleton.

Scaling rules (reference load-planner semantics,
`docs/architecture/load_planner.md`):
- scale UP by one replica when the predicted per-worker KV-cache usage
  exceeds `kv_high` OR any requests are queued (waiting > 0);
- scale DOWN by one when predicted usage across workers would still stay
  under `kv_low` with one fewer replica and nothing is waiting;
- clamp to [min_replicas, max_replicas]; one move per adjustment
  interval (no thrash).

Graceful scale-down mirrors the reference (`load_planner.md:21`): the
connector SIGTERMs the newest worker; the worker's drain (worker/main.py,
llm/drain.py) leaves routing instantly and hands each in-flight stream
to a peer with its sealed KV, so no stream is dropped.
"""

from dynamo_tpu_torch.planner.core import LoadPlanner, PlannerConfig
from dynamo_tpu_torch.planner.connector import LocalConnector
from dynamo_tpu_torch.planner.predictor import (
    ConstantPredictor,
    ARPredictor,
    MovingAveragePredictor,
    TrendPredictor,
    make_predictor,
)
from dynamo_tpu_torch.planner.sla import (
    PrometheusScraper,
    SlaObservation,
    SlaPlanner,
    SlaPlannerConfig,
)

__all__ = [
    "LoadPlanner",
    "PlannerConfig",
    "LocalConnector",
    "ConstantPredictor",
    "ARPredictor",
    "MovingAveragePredictor",
    "TrendPredictor",
    "make_predictor",
    "SlaPlanner",
    "SlaPlannerConfig",
    "SlaObservation",
    "PrometheusScraper",
]
