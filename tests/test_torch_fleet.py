"""The port's fleet plane (``futuresdr_tpu_torch/telemetry/fleet.py``) and
the admission router over it (``serve/router.py``).

Against the JAX package's plane, the same host exports (an injected fetch,
no sockets) give the same host states, journal story and cross-host
verdicts (down, stale, wedged, pressure skew with its eviction candidates,
a fleet-wide compile storm), and the same expositions merge to the same
text. The port's own: this host's export reads a registered engine and the
planes, the fleet tick is one falsy check with no peers, and a live fleet of
three control-port processes (``tests/_torch_fleet_child.py``) shows three
ready hosts on ``GET /api/fleet/``, merges their metrics, routes admissions
through ``POST /api/fleet/serve/{app}/session/`` to the least pressured one,
and, once that one is killed, reads it down and routes every later
admission to the survivors.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from futuresdr_tpu.telemetry import fleet as J_fleet
from futuresdr_tpu.telemetry import journal as J_journal
from futuresdr_tpu_torch.telemetry import fleet as T_fleet
from futuresdr_tpu_torch.telemetry import journal as T_journal

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _summary(ready=True, shed=0, pressure=0.0, p99=0.01, app="app", occupants=(),
             host="h", storm=False, doctor="ok"):
    return {"host": host, "ready": ready, "pressure": pressure, "shed_level": shed,
            "compile_storm": storm, "sessions": len(occupants),
            "doctor": {"verdict": doctor}, "e2e": {"p50_s": p99 / 2, "p99_s": p99},
            "apps": {app: {"ready": ready, "shed_level": shed, "pressure": pressure,
                           "sessions": len(occupants), "occupants": list(occupants)}}}


def _fetcher(script):
    """``fetch(url, timeout)`` answering each peer from ``script[peer]``: a
    summary, or None for a refused connection."""
    def fetch(url, timeout):
        peer = url.split("//")[1].split("/")[0]
        s = script[peer]
        if s is None:
            raise OSError("connection refused")
        return json.dumps(s).encode()
    return fetch


def _story(fleet_mod, journal_mod):
    script = {"hot:1": _summary(host="hot:1", pressure=0.9, occupants=("s1", "s2", "s3"),
                                storm=True),
              "cold:1": _summary(host="cold:1", pressure=0.1),
              "warm:1": _summary(host="warm:1", pressure=0.3, storm=True),
              "sick:1": _summary(host="sick:1", doctor="deadlocked", storm=True),
              "gone:1": None}
    v = fleet_mod.FleetView(list(script), poll_interval=0.05, down_errors=2, skew=0.5,
                            fetch=_fetcher(script))
    j0 = journal_mod.journal().seq
    out = []
    # ages are clock readings: every comparison leaves them out
    strip = lambda h: {p: {k: x for k, x in d.items() if k != "age_s"}  # noqa: E731
                       for p, d in h.items()}
    nv = lambda vs: [{k: x for k, x in d.items() if k != "age_s"} for d in vs]  # noqa: E731
    for step in range(3):
        v.poll_once()
        out.append((strip(v.hosts()), nv(v.verdicts()) if step else None))
        if step == 1:
            script["gone:1"] = _summary(host="gone:1", pressure=0.2)
            script["warm:1"] = None
    snap = v.snapshot()
    out.append({k: (nv(x) if k == "verdicts" else x) for k, x in snap.items() if k != "hosts"})
    out.append(sorted(v.ready_hosts()))
    evs = [{k: x for k, x in e.items() if k not in ("seq", "t_wall", "t_mono_ns")}
           for e in journal_mod.events(since=j0, cat="fleet")["events"]]
    out.append(evs)
    return out


def test_fleet_view_states_and_verdicts_match_the_reference():
    got = _story(T_fleet, T_journal)
    want = _story(J_fleet, J_journal)
    assert got == want
    verdicts = {x["verdict"]: x for x in got[1][1]}
    assert verdicts["pressure-skew"]["hot"] == "hot:1"
    assert {c["sid"] for c in verdicts["pressure-skew"]["evict_candidates"]} == \
        {"s1", "s2", "s3"}
    assert verdicts["host-wedged"]["host"] == "sick:1"
    assert verdicts["host-down"]["host"] == "gone:1"
    assert verdicts["fleet-compile-storm"]["hosts"] == ["hot:1", "sick:1", "warm:1"]


@pytest.mark.parametrize("texts", [
    {"b:1": "# TYPE z_c counter\nz_c 1\n# TYPE a_g gauge\na_g 2\n",
     "a:1": ("# TYPE fsdr_lat histogram\nfsdr_lat_bucket{le=\"0.5\"} 1\n"
             "fsdr_lat_bucket{le=\"2\"} 3\nfsdr_lat_bucket{le=\"+Inf\"} 3\n"
             "fsdr_lat_sum 1.5\nfsdr_lat_count 3\n")},
    {"x:9": ("# HELP m help text\n# TYPE m gauge\nm{host=\"own\"} 4\nm{a=\"q\"} 5\n"
             "lonely 7\n# EOF\n"),
     "w:2": "# HELP m other help\n# TYPE m gauge\nm 1\n"},
    {}])
def test_merge_metrics_matches_the_reference(texts):
    got = T_fleet.merge_metrics(texts)
    assert got == J_fleet.merge_metrics(texts)
    assert got == T_fleet.merge_metrics(dict(reversed(list(texts.items()))))


def test_age_staleness_between_polls():
    v = T_fleet.FleetView(["p:1"], poll_interval=0.05, stale_s=0.08,
                          fetch=lambda u, t: json.dumps(_summary()).encode())
    v.poll_once()
    assert v.hosts()["p:1"]["state"] == "up"
    time.sleep(0.1)
    v._age_sweep()
    assert v.hosts()["p:1"]["state"] == "stale"


def test_host_summary_reads_a_registered_engine_and_the_planes():
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.serve import ServeEngine, register_app, unregister_app
    pipe = T.Pipeline([T.rotator_stage(0.03)], np.complex64)
    eng = ServeEngine(pipe, frame_size=1024, app="fleet_probe", device="cpu", buckets=(2,))
    register_app(eng)
    try:
        s = eng.admit(tenant="t", sid="sid0")
        eng.submit(s.sid, np.ones(1024, np.complex64))
        eng.step()
        summ = T_fleet.host_summary()
        app = summ["apps"]["fleet_probe"]
        assert app["occupants"] == ["sid0"] and app["sessions"] == 1
        assert summ["ready"] and summ["doctor"]["verdict"] in ("ok",) + \
            tuple(T_fleet._doctor_verdict().values())
        assert summ["journal_seq"] == T_journal.journal().seq
        assert summ["host"] == T_fleet.host_id()
        json.dumps(summ, default=str)
    finally:
        unregister_app("fleet_probe")
        eng.shutdown()


def test_tick_is_one_falsy_check_with_no_peers():
    assert not T_fleet.enabled() and T_fleet._tick_state is None
    assert T_fleet.ensure_started() is None and T_fleet.fleet_section() is None
    T_fleet.tick()                          # a no-op


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.load(r)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.load(r)


def test_live_fleet_kill_one_routes_to_survivors(monkeypatch):
    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort
    specs = [(_free_port(), 0.1), (_free_port(), 0.3), (_free_port(), 0.5)]
    peers = [f"127.0.0.1:{port}" for port, _ in specs]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-m", "tests._torch_fleet_child", str(port),
                               str(p)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True)
             for port, p in specs]
    cp = None
    interval = 0.15
    try:
        for p in procs:
            line = ""
            while "READY" not in line:
                line = p.stdout.readline()
                assert line, "a fleet child died before listening"
        monkeypatch.setattr(config(), "fleet_peers", ",".join(peers))
        monkeypatch.setattr(config(), "fleet_poll_interval", interval)

        class _Handle:
            def flowgraph_ids(self):
                return []

            def get_flowgraph(self, fg):
                return None

        cp = ControlPort(_Handle(), bind="127.0.0.1:0")
        cp.start()
        view = T_fleet.active_view()
        assert view is not None
        base = cp.url
        deadline = time.monotonic() + 15
        snap = {}
        while time.monotonic() < deadline:
            snap = _get(f"{base}/api/fleet/")
            if snap.get("hosts_ready") == 3:
                break
            time.sleep(interval)
        assert snap.get("hosts_ready") == 3 and snap["ready"], snap
        assert snap["hosts"][peers[0]]["summary"]["pressure"] == 0.1
        m1 = urllib.request.urlopen(f"{base}/api/fleet/metrics", timeout=5).read().decode()
        assert f'host="{peers[0]}"' in m1
        status, out = _post(f"{base}/api/fleet/serve/app/session/", {"tenant": "t0"})
        assert status == 201 and out["host"] == peers[0]
        j0 = T_journal.journal().seq
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=10)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and view.hosts()[peers[0]]["state"] != "down":
            time.sleep(interval / 3)
        assert view.hosts()[peers[0]]["state"] == "down"
        evs = [e for e in T_journal.events(since=j0, cat="fleet")["events"]
               if e.get("host") == peers[0]]
        assert [e["event"] for e in evs][:2] == ["host-stale", "host-down"]
        hosts = [_post(f"{base}/api/fleet/serve/app/session/", {"tenant": f"t{i}"})[1]["host"]
                 for i in range(1, 6)]
        assert set(hosts) <= set(peers[1:]) and hosts[0] == peers[1]
        verdicts = _get(f"{base}/api/fleet/")["verdicts"]
        assert any(v["verdict"] == "host-down" and v["host"] == peers[0] for v in verdicts)
    finally:
        if cp is not None:
            cp.stop()
        T_fleet.shutdown()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
            if p.stdout is not None:
                p.stdout.close()
