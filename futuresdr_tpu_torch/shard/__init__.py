"""Mesh-sharded device plane: fused device programs (``ops/stages.py``
pipelines) over a one-axis mesh of devices.

The counterpart of ``futuresdr_tpu/shard``:

* :func:`plan_shard` / :class:`ShardPlan`: the stage-by-stage plan pass
  (``plan.py``);
* :class:`ShardedProgram` / :class:`ShardRunner`: data sharding, D independent
  stream lanes with one carry and one CUDA graph a device, the whole-mesh
  checkpoint and replay logs a shard (``data.py``);
* :class:`ModelShardedProgram`: one frame's item axis across the mesh
  (``model.py``);
* :func:`shard_pipeline`: plan, then apply; ``off`` or one device returns the
  same pipeline object.

The serving engine's slot axis over devices is ``serve/engine.py``
(``ServeEngine(shard_devices=…)``).
"""

from .data import (ShardRunner, ShardedProgram, collective_ops, rows_to_host, shard_mesh,
                   shard_pipeline)
from .model import ModelShardedProgram
from .plan import (AXIS, MODES, ShardPlan, StageDecision, clear_plans, note_plan,
                   plan_shard, plans_report, resolve_devices)

__all__ = ["ShardPlan", "StageDecision", "plan_shard", "resolve_devices", "note_plan",
           "plans_report", "clear_plans", "MODES", "AXIS", "ShardedProgram", "ShardRunner",
           "shard_pipeline", "shard_mesh", "collective_ops", "rows_to_host",
           "ModelShardedProgram"]
