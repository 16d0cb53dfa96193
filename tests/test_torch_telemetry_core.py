"""The port's telemetry core (``futuresdr_tpu_torch/telemetry``: prom, hist,
journal) against the JAX package's modules of the same names, on the same
operations: the exposition text, the quantiles and the journal's cursor
reads agree exactly."""

import numpy as np
import pytest
import torch

from futuresdr_tpu.telemetry import hist as J_hist
from futuresdr_tpu.telemetry import journal as J_journal
from futuresdr_tpu.telemetry import prom as J_prom
from futuresdr_tpu_torch.telemetry import hist as T_hist
from futuresdr_tpu_torch.telemetry import journal as T_journal
from futuresdr_tpu_torch.telemetry import prom as T_prom

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def _drive(prom, reg):
    c = reg.counter("probe_frames_total", "frames", ("app", "tenant"))
    g = reg.gauge("probe_sessions", "sessions", ("app", "state"))
    h = reg.histogram("probe_latency_seconds", "latency", ("tenant",))
    reg.counter("probe_unlabelled_total", "no labels")     # exposes its zero
    for i, (app, tenant) in enumerate([("z", "t9"), ("a", "t1"), ("m", "t5"), ("a", "t1")]):
        c.inc(app=app, tenant=tenant)
        g.set(float(i), app=app, state="active")
        h.observe(1e-3 * (i + 1) ** 2, tenant=tenant)
    g.set(0.5, app="a", state="active")
    h.observe(200.0, tenant="t9")            # past the top bucket
    h.observe(-1.0, tenant="t9")             # dropped
    return reg.render()


def test_registry_exposition_matches_the_reference_byte_for_byte():
    assert _drive(T_prom, T_prom.Registry()) == _drive(J_prom, J_prom.Registry())


def test_exposition_order_is_stable_under_creation_order():
    a = T_prom.Counter("order_total", "t", ("app", "tenant"))
    b = T_prom.Counter("order_total", "t", ("app", "tenant"))
    for app in ("z", "a", "m"):
        a.inc(app=app, tenant="x")
    for app in ("m", "z", "a"):
        b.inc(app=app, tenant="x")
    assert a.render() == b.render()
    lines = [l for l in a.render() if not l.startswith("#")]
    assert lines == sorted(lines)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_hist_quantiles_match_the_reference(q):
    rng = np.random.default_rng(4)
    vals = np.concatenate([rng.exponential(1e-3, 200), [0.0, 1e-9, 0.5, 0.5, 300.0]])
    th, jh = T_hist.Log2Hist(), J_hist.Log2Hist()
    for v in vals:
        th.observe(float(v))
        jh.observe(float(v))
    assert th.snapshot() == jh.snapshot()
    assert th.quantile(q) == jh.quantile(q)


def test_merged_family_quantile_matches_the_reference():
    th = T_prom.Histogram("merged_seconds", "t", ("tenant",))
    jh = J_prom.Histogram("merged_seconds", "t", ("tenant",))
    for i in range(50):
        for h in (th, jh):
            h.observe(1e-4 * (i + 1), tenant=f"t{i % 3}")
    for q in (0.5, 0.99):
        assert th.quantile(q) == jh.quantile(q)
        assert th.quantile(q, tenant="t1") == jh.quantile(q, tenant="t1")
    assert T_prom.Histogram("empty_seconds", "t", ("a",)).quantile(0.5) is None


def test_metric_label_and_type_contracts():
    reg = T_prom.Registry()
    c = reg.counter("contract_total", "t", ("app",))
    with pytest.raises(ValueError):
        c.inc(tenant="x")
    with pytest.raises(ValueError):
        c.inc(-1.0, app="a")
    with pytest.raises(ValueError):
        reg.gauge("contract_total", "t", ("app",))
    assert reg.counter("contract_total", "t", ("app",)) is c
    c.inc(2.0, app="a")
    assert c.get(app="a") == 2.0


def _journal_story(mod):
    j = mod.Journal(maxlen=4)
    seqs = [j.emit("serve", "admit", session="s1"), j.emit("kernel", "restart"),
            j.emit("serve", "evict", session="s1"), j.emit("serve", "readmit", session="s1"),
            j.emit("serve", "close", session="s1"), j.emit("fleet", "route", host="h")]
    strip = lambda r: {k: [{x: v for x, v in e.items() if x not in ("t_wall", "t_mono_ns")}  # noqa: E731
                           for e in r["events"]] if k == "events" else r[k] for k in r}
    return seqs, [strip(j.events(since=s, cat=c, limit=lim))
                  for s, c, lim in ((0, None, None), (2, "serve", None), (3, None, 1),
                                    (6, None, None))], j.seq


def test_journal_cursor_reads_match_the_reference():
    t_seqs, t_reads, t_seq = _journal_story(T_journal)
    j_seqs, j_reads, j_seq = _journal_story(J_journal)
    assert t_seqs == j_seqs == [1, 2, 3, 4, 5, 6]
    assert t_reads == j_reads
    assert t_seq == j_seq == 6
    assert t_reads[0]["gap"] is True          # the bounded ring dropped seq 1-2


def test_journal_singleton_emit_and_reset():
    T_journal.reset_journal()
    seq = T_journal.emit("serve", "page-admit", app="x", session="s", slot=0, page=0)
    got = T_journal.events(since=seq - 1, cat="serve")["events"]
    assert len(got) == 1 and got[0]["event"] == "page-admit" and got[0]["slot"] == 0
    assert T_journal.journal().seq == seq
    fresh = T_journal.reset_journal()
    assert fresh.seq == 0 and fresh is T_journal.journal()


def test_render_all_carries_the_process_registry():
    c = T_prom.counter("render_all_probe_total", "probe", ("app",))
    c.inc(app="x")
    text = T_prom.render_all()
    assert '# TYPE render_all_probe_total counter' in text
    assert 'render_all_probe_total{app="x"} 1' in text
