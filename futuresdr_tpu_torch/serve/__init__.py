"""futuresdr_tpu_torch.serve — multi-tenant serving of one receiver chain.

The port of ``futuresdr_tpu/serve``: N concurrent sessions of the same fused
chain ride one dispatch a frame time. The slot table with ragged admission
and the lane→page permutation (:mod:`.slots`), the engine (:mod:`.engine`:
the paged, lane-batched slot program, one CUDA graph a bucket on a card),
per-tenant fair credits (:mod:`.credits`), the shedding ladder
(:mod:`.overload`), durable session snapshots (:mod:`.persist`), the REST
session plane mounted on the control port (:mod:`.api`) and the
pressure-routed admission router (:mod:`.router`).
"""

from .api import apps, get_app, register_app, routes, unregister_app
from .credits import TenantCreditController
from .engine import (ServeEngine, SlotProgram, build_slot_program, default_buckets,
                     drain_all_apps, install_sigterm_drain, overlap_report)
from .overload import ShedLadder
from .persist import SessionStore
from .router import AdmissionRouter, NoReadyHost
from .slots import ServeDraining, ServeFull, ServeOverload, Session, SlotTable

__all__ = ["ServeEngine", "ServeFull", "ServeDraining", "ServeOverload", "Session",
           "SlotTable", "SessionStore", "ShedLadder", "SlotProgram",
           "TenantCreditController", "build_slot_program", "default_buckets",
           "overlap_report", "install_sigterm_drain", "drain_all_apps", "register_app",
           "unregister_app", "get_app", "apps", "routes", "AdmissionRouter",
           "NoReadyHost"]
