"""The host plane's last names, held against the JAX package: config's
``log_level``, ``slab_reserved``, ``stack_size`` and ``misc`` with
``Config.get`` reading it, ``log.init``, the supervisor messages' common base
``FlowgraphMessage``, and ``PpKernel.warmup``."""

import dataclasses
import importlib
import logging

import numpy as np
import pytest
import torch

# the modules (each package's ``config`` name is the accessor function)
jconfig = importlib.import_module("futuresdr_tpu.config")
jruntime = importlib.import_module("futuresdr_tpu.runtime.runtime")
pconfig = importlib.import_module("futuresdr_tpu_torch.config")
plog = importlib.import_module("futuresdr_tpu_torch.log")
pruntime = importlib.import_module("futuresdr_tpu_torch.runtime.runtime")

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

FIELDS = ("log_level", "slab_reserved", "stack_size")


def test_the_informational_fields_default_as_in_the_jax_package():
    port, ref = pconfig.Config(), jconfig.Config()
    for name in FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.misc == ref.misc == {}


@pytest.mark.parametrize("var,value,key,want", [
    ("FUTURESDR_TPU_LOG_LEVEL", "debug", "log_level", "debug"),
    ("FUTURESDR_TPU_SLAB_RESERVED", "256", "slab_reserved", 256),
    ("FUTURESDR_TPU_STACK_SIZE", "1048576", "stack_size", 1048576),
    ("FUTURESDR_TPU_MY_KNOB", "7", "my_knob", "7"),
])
def test_env_and_get_read_fields_and_misc_as_in_the_jax_package(
        var, value, key, want, monkeypatch):
    monkeypatch.setenv(var, value)
    try:
        port, ref = pconfig.reload_config(), jconfig.reload_config()
        assert port.get(key) == ref.get(key) == want
        in_misc = key not in {f.name for f in dataclasses.fields(pconfig.Config)}
        assert (key in port.misc) == (key in ref.misc) == in_misc
    finally:
        monkeypatch.undo()
        pconfig.reload_config()
        jconfig.reload_config()


def test_get_falls_back_to_its_default():
    c = pconfig.Config()
    c.misc["present"] = 3
    assert c.get("present") == 3
    assert c.get("absent", "dflt") == "dflt"
    assert c.get("buffer_size") == c.buffer_size
    assert c.get("misc", "dflt") == "dflt"        # the map itself is no key


@pytest.mark.parametrize("env,cfg,level", [
    (None, "warn", logging.WARNING),
    ("error", "warn", logging.ERROR),             # the variable wins
    (None, "nonsense", logging.INFO),
])
def test_init_sets_the_level_from_env_else_config(env, cfg, level, monkeypatch):
    root = logging.getLogger("futuresdr_tpu_torch")
    saved = (root.level, plog._initialized, pconfig.config().log_level)
    if env is None:
        monkeypatch.delenv("FUTURESDR_TPU_LOG", raising=False)
    else:
        monkeypatch.setenv("FUTURESDR_TPU_LOG", env)
    try:
        pconfig.config().log_level = cfg
        plog._initialized = False
        plog.init()
        assert root.level == level
        assert root.handlers
        pconfig.config().log_level = "debug"
        plog.init()                               # once a process
        assert root.level == level
    finally:
        root.setLevel(saved[0])
        plog._initialized = saved[1]
        pconfig.config().log_level = saved[2]


def test_every_supervisor_message_derives_from_flowgraph_message():
    ref = {n for n, c in vars(jruntime).items()
           if isinstance(c, type) and issubclass(c, jruntime.FlowgraphMessage)
           and c is not jruntime.FlowgraphMessage}
    port = {n for n, c in vars(pruntime).items()
            if isinstance(c, type) and issubclass(c, pruntime.FlowgraphMessage)
            and c is not pruntime.FlowgraphMessage}
    assert port == ref
    assert {n for n in vars(pruntime) if n.endswith("Msg")} == port
    assert pruntime.InitializedMsg(3, ok=True).ok is True
    assert pruntime.FlowgraphMessage.__slots__ == ()


def test_pp_kernel_warmup_runs_a_zero_frame_and_bills_no_link_bytes():
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.ops import xfer
    from futuresdr_tpu_torch.parallel import make_mesh
    from futuresdr_tpu_torch.tpu import PpKernel

    cfg = pconfig.config()
    prev, cfg.virtual_devices = cfg.virtual_devices, 4
    try:
        n_stages, d, mb, n_micro = 4, 8, 3, 5
        rng = np.random.default_rng(0)
        W = (rng.standard_normal((n_stages, d, d)) / 4.0).astype(np.float32)
        mesh = make_mesh(("pp",), shape=(n_stages,), device="cpu")
        data = rng.standard_normal(2 * n_micro * mb * d).astype(np.float32)
        got = []
        for warm in (False, True):
            ppk = PpKernel(lambda w, a: torch.tanh(a @ w), W, mesh, np.float32,
                           np.float32, micro_shape=(mb, d), n_micro=n_micro)
            if warm:
                billed = [xfer._BYTES[k].value for k in ("h2d", "d2h")]
                ppk.warmup()
                assert [xfer._BYTES[k].value for k in ("h2d", "d2h")] == billed
                assert not ppk._inflight
            fg, snk = Flowgraph(), VectorSink(np.float32)
            fg.connect(VectorSource(data), ppk, snk)
            Runtime().run(fg)
            got.append(np.asarray(snk.items()))
        np.testing.assert_array_equal(got[0], got[1])
        assert len(got[0]) == len(data)
    finally:
        cfg.virtual_devices = prev
