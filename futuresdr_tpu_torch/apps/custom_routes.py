"""Own REST routes beside the control port; the port's counterpart of
``examples/custom_routes.py`` (reference: ``examples/custom-routes``,
``Runtime::with_custom_routes``).

``Runtime(extra_routes=…)`` mounts two routes on the control port beside its
``/api/fg/`` families: ``/my_route/`` serves a static HTML page, and
``/start_fg/`` launches a second flowgraph on the same runtime from inside the
handler and answers with its description. The app then requests both, and
``/api/fg/``, which must list both flowgraphs.

Run: ``python -m futuresdr_tpu_torch.apps.custom_routes [--port 18137]``
(port 0 takes a free one).
"""

from __future__ import annotations

import argparse
import json
import urllib.request
from typing import Optional

from ..blocks import MessageSink, MessageSource
from ..config import config
from ..runtime import Flowgraph, Runtime
from ..types import Pmt

__all__ = ["PAGE", "build_beacon", "make_runtime", "main"]

PAGE = """<html>
  <head><meta charset='utf-8'/><title>FutureSDR TPU</title></head>
  <body><h1>My Custom Route</h1></body>
</html>"""


def build_beacon(n_messages: Optional[int] = None) -> Flowgraph:
    fg = Flowgraph()
    fg.connect_message(MessageSource(Pmt.string("foo"), interval=0.1, count=n_messages),
                       "out", MessageSink(), "in")
    return fg


def make_runtime() -> Runtime:
    """A runtime whose control port serves ``/my_route/`` and ``/start_fg/``;
    the flowgraphs the handler launched are in its ``launched`` list."""
    box = {}

    async def my_route(request):
        return PAGE

    async def start_fg(request):
        # launch a second flowgraph on the same runtime from the handler
        running = await box["rt"].start_async(build_beacon(n_messages=50))
        box["rt"].launched.append(running)
        return (await running.handle.describe()).to_json()

    box["rt"] = Runtime(extra_routes=[("GET", "/my_route/", my_route),
                                      ("GET", "/start_fg/", start_fg)])
    box["rt"].launched = []
    return box["rt"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="own REST routes beside the control port")
    p.add_argument("--port", type=int, default=18137)
    a = p.parse_args(argv)
    config().ctrlport_enable = True
    config().ctrlport_bind = f"127.0.0.1:{a.port}"
    rt = make_runtime()
    base = rt.ctrl_port.url
    print(f"custom routes at {base}/my_route/ and {base}/start_fg/")
    running = rt.start(build_beacon(n_messages=20))
    try:
        html = urllib.request.urlopen(base + "/my_route/", timeout=10).read().decode()
        desc = json.loads(urllib.request.urlopen(base + "/start_fg/", timeout=10).read())
        fgs = json.loads(urllib.request.urlopen(base + "/api/fg/", timeout=10).read())
        print("GET /my_route/ ->", html.splitlines()[2].strip())
        print("GET /start_fg/ -> launched a flowgraph of", len(desc["blocks"]), "blocks")
        print("GET /api/fg/   ->", fgs)
        ok = "My Custom Route" in html and "blocks" in desc and fgs == [0, 1]
    finally:
        for r in [running] + rt.launched:
            r.stop_sync()
        rt.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
