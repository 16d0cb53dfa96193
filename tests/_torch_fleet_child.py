"""A control-port child for the port's live fleet test.

Runs one of the port's control ports (``futuresdr_tpu_torch``, standard
library HTTP) with a duck-typed serving engine registered under app
``app``: the lock-free surface the fleet plane reads (``health()``,
``retry_after_s()``, ``credits.pressure()``, the slot table) and
``admit`` for routed admissions, without building a program.

Usage: ``python -m tests._torch_fleet_child <port> [pressure] [shed_level]``.
Prints ``READY`` once the port listens, then parks until killed.
"""

import os
import sys
import time


class _Credits:
    def __init__(self, p: float):
        self._p = float(p)

    def pressure(self) -> float:
        return self._p


class FakeEngine:
    """What the fleet plane reads of a ServeEngine, and ``admit``."""

    def __init__(self, app: str, pressure: float = 0.0, shed_level: int = 0,
                 capacity: int = 64):
        from futuresdr_tpu_torch.serve.slots import SlotTable
        self.app = app
        self.table = SlotTable(capacity)
        self.credits = _Credits(pressure)
        self.shed_level = int(shed_level)

    def health(self) -> dict:
        return {"ready": True, "compiled": True, "draining": False, "drained": False,
                "shed_level": self.shed_level,
                "shed_rung": "ok" if not self.shed_level else "admission",
                "active": self.table.active, "capacity": self.table.capacity}

    def retry_after_s(self) -> int:
        return 1

    def admit(self, tenant: str = "default", sid=None):
        from futuresdr_tpu_torch.serve.slots import Session
        s = Session(tenant, sid)
        self.table.admit(s)
        return s


class _Handle:
    def flowgraph_ids(self):
        return []

    def get_flowgraph(self, fg):
        return None


def main() -> None:
    port = int(sys.argv[1])
    pressure = float(sys.argv[2]) if len(sys.argv) > 2 else 0.0
    shed = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    # the fleet identity is the control port's address (what the view polls)
    os.environ.setdefault("FUTURESDR_TPU_FLEET_HOST_ID", f"127.0.0.1:{port}")
    from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort
    from futuresdr_tpu_torch.serve import api as serve_api
    serve_api.register_app(FakeEngine("app", pressure, shed), "app")
    cp = ControlPort(_Handle(), bind=f"127.0.0.1:{port}")
    cp.start()
    print("READY", flush=True)
    while True:
        time.sleep(1)


if __name__ == "__main__":
    main()
