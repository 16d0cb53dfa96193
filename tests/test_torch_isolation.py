"""The port stands alone: it loads neither JAX nor the JAX package (nor the
reference's aiohttp and websockets: its control port and websocket sink are
standard library), never picks the CPU by itself, and never counts a kernel
launch for a CPU tensor."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import futuresdr_tpu_torch
from futuresdr_tpu_torch.ops import cuda_kernels as ck
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.tpu import TpuInstance

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

PKG_DIR = Path(futuresdr_tpu_torch.__file__).resolve().parent
REPO = PKG_DIR.parent


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG_DIR)],
                                                        "futuresdr_tpu_torch."))


def test_import_loads_neither_jax_nor_the_jax_package():
    mods = _submodules()
    assert "futuresdr_tpu_torch.ops.cuda_kernels" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or "
            "m == 'futuresdr_tpu' or m.startswith('futuresdr_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_precision_and_tuning_modules_are_walked():
    """The modules of the precision and tuning slice are among those the
    isolation checks import (the planner, the cache, the plan sweep, the
    roofline and the marginal rate)."""
    assert {"futuresdr_tpu_torch.ops.precision", "futuresdr_tpu_torch.tpu.autotune",
            "futuresdr_tpu_torch.tpu.kernel_tune", "futuresdr_tpu_torch.utils.roofline",
            "futuresdr_tpu_torch.utils.measure"} <= set(_submodules())


def test_the_models_load_alone():
    """The models' modules (the WLAN receiver, the Viterbi decoder, MCLDNN,
    M17's trellis) are walked, and decoding a WLAN frame and an M17 one and
    classifying a window on the CPU load neither JAX nor the JAX package (nor
    flax or orbax: the weights are the port's own ``.npz``)."""
    assert {"futuresdr_tpu_torch.models.wlan.phy", "futuresdr_tpu_torch.models.wlan.torch_demod",
            "futuresdr_tpu_torch.ops.viterbi", "futuresdr_tpu_torch.models.mcldnn",
            "futuresdr_tpu_torch.models.modrec",
            "futuresdr_tpu_torch.models.m17.codec"} <= set(_submodules())
    code = ("import sys\n"
            "import numpy as np, torch\n"
            "from futuresdr_tpu_torch.models import wlan, modrec\n"
            "psdu = wlan.Mac().frame(b'alone' * 40)\n"
            "x = np.concatenate([np.zeros(100, np.complex64), wlan.encode_frame(psdu),\n"
            "                    np.zeros(100, np.complex64)])\n"
            "assert [f.psdu for f in wlan.decode_stream_batch(x, device='cpu')] == [psdu]\n"
            "from futuresdr_tpu_torch.models.m17 import codec\n"
            "from futuresdr_tpu_torch.ops import viterbi\n"
            "assert viterbi.scan_viterbi(np.zeros(1024), 512, *codec._M17_PREV,\n"
            "                            device='cpu').shape == (512,)\n"
            "X, _ = modrec.synth_batch(np.random.default_rng(0), 4, 128)\n"
            "with torch.no_grad():\n"
            "    assert modrec.load_pretrained(device='cpu')(torch.from_numpy(X)).shape == (4, 5)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'futuresdr_tpu', 'flax', 'orbax')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_telemetry_plane_is_walked_and_loads_alone():
    """The telemetry plane's modules (spans, lineage, profile, doctor, fleet,
    the extended prom, hist and journal, the latency probes) are walked, and
    driving each of them (a Chrome trace, a flight record and a report, the
    profile view, this host's fleet export, the tail report, the OpenMetrics
    text) loads neither JAX nor the JAX package nor aiohttp."""
    mods = {"futuresdr_tpu_torch.telemetry." + m for m in
            ("spans", "lineage", "profile", "doctor", "fleet", "prom", "hist", "journal")}
    assert mods | {"futuresdr_tpu_torch.utils.trace"} <= set(_submodules())
    code = ("import json, sys\n"
            "from futuresdr_tpu_torch import telemetry as t\n"
            "from futuresdr_tpu_torch.utils import trace\n"
            "t.enable(True)\n"
            "t.recorder().complete('tpu', 'compute', t.recorder().now())\n"
            "json.dumps(t.chrome_trace())\n"
            "d = t.doctor.doctor()\n"
            "json.dumps(d.flight_record('probe'), default=str)\n"
            "json.dumps(d.report([]), default=str)\n"
            "json.dumps(t.profile.plane().snapshot(), default=str)\n"
            "json.dumps(t.fleet.host_summary(), default=str)\n"
            "t.lineage.tail_report()\n"
            "t.registry().render_openmetrics()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'futuresdr_tpu', 'aiohttp', 'websockets')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax_and_no_jax_package():
    offenders = []
    for path in sorted(PKG_DIR.rglob("*.py")) + [REPO / "chip_smoke.py",
                                                 REPO / "port_profile.py",
                                                 REPO / "port_buffers.py",
                                                 REPO / "port_viterbi.py"]:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "futuresdr_tpu", "aiohttp", "websockets"):
                    offenders.append(f"{path.name}: {name}")
    assert offenders == []


def test_control_port_and_websocket_sink_load_no_aiohttp_and_no_websockets():
    """Importing every module, serving a control port and streaming through a
    websocket sink to a client leaves the reference's server packages (and
    JAX) out of ``sys.modules``."""
    mods = _submodules()
    code = ("import importlib, socket, sys, json, urllib.request\n"
            "import numpy as np\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from futuresdr_tpu_torch import Flowgraph, Runtime\n"
            "from futuresdr_tpu_torch.blocks import NullSource, WebsocketSink\n"
            "from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort\n"
            "rt = Runtime(); cp = ControlPort(rt.handle, bind='127.0.0.1:0'); cp.start()\n"
            "fg = Flowgraph(); ws = WebsocketSink(0, np.float32, chunk_items=256)\n"
            "fg.connect(NullSource(np.float32), ws)\n"
            "running = rt.start(fg)\n"
            "s = socket.create_connection(('127.0.0.1', ws.bound_port), timeout=10)\n"
            "s.sendall(b'GET / HTTP/1.1\\r\\nUpgrade: websocket\\r\\n'\n"
            "          b'Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\\r\\n\\r\\n')\n"
            "assert s.recv(12) == b'HTTP/1.1 101'\n"
            "ids = json.load(urllib.request.urlopen(cp.url + '/api/fg/'))\n"
            "running.stop_sync(); cp.stop(); s.close()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'futuresdr_tpu', 'aiohttp', 'websockets')]\n"
            "print(ids, bad)\n"
            "sys.exit(1 if bad or ids != [0] else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_serving_plane_and_telemetry_load_neither_jax_nor_the_jax_package():
    """Importing every module of ``serve`` and ``telemetry``, serving a session
    on the CPU and answering the session routes and ``/metrics`` on the
    control port leave JAX, the JAX package and aiohttp out of
    ``sys.modules``."""
    mods = [m for m in _submodules()
            if m.startswith(("futuresdr_tpu_torch.serve", "futuresdr_tpu_torch.telemetry"))]
    assert {"futuresdr_tpu_torch.serve.engine", "futuresdr_tpu_torch.serve.api",
            "futuresdr_tpu_torch.serve.router", "futuresdr_tpu_torch.serve.persist",
            "futuresdr_tpu_torch.telemetry.prom", "futuresdr_tpu_torch.telemetry.journal",
            "futuresdr_tpu_torch.telemetry.hist"} <= set(mods)
    code = ("import importlib, sys, json, urllib.request\n"
            "import numpy as np\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from futuresdr_tpu_torch import Runtime\n"
            "from futuresdr_tpu_torch.ops import stages as T\n"
            "from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort\n"
            "from futuresdr_tpu_torch.serve import ServeEngine, register_app\n"
            "eng = ServeEngine(T.Pipeline([T.rotator_stage(0.1)], np.complex64), "
            "frame_size=256, app='iso', buckets=(2,), device='cpu')\n"
            "register_app(eng)\n"
            "rt = Runtime(); cp = ControlPort(rt.handle, bind='127.0.0.1:0'); cp.start()\n"
            "s = eng.admit(tenant='t'); eng.submit(s.sid, np.ones(256, np.complex64))\n"
            "eng.step()\n"
            "view = json.load(urllib.request.urlopen(cp.url + '/api/serve/iso/'))\n"
            "text = urllib.request.urlopen(cp.url + '/metrics').read().decode()\n"
            "cp.stop()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'futuresdr_tpu', 'aiohttp')]\n"
            "print(view['frames'], bad)\n"
            "sys.exit(1 if bad or view['frames'] != 1 or 'fsdr_serve_frames_total' not in text "
            "else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_instance_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuInstance()
    assert TpuInstance("cpu").device == torch.device("cpu")


def test_cpu_tensors_never_count_a_launch():
    ck.reset_launches()
    rng = np.random.default_rng(0)
    taps = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    x = torch.from_numpy((rng.standard_normal(1024) + 1j * rng.standard_normal(1024))
                         .astype(np.complex64))
    hist = torch.zeros(15, dtype=torch.complex64)
    ck.fir(x, taps)
    ck.fir_continue(hist, x, taps, precision="bf16")
    ck.fir_fft(hist, x, taps, 256)
    ck.rotator(x, torch.tensor(0.5), torch.tensor(-0.1))
    ck.quad_demod(x[:1].reshape(()), x, 0.5)
    ck.poly_fir(torch.zeros(12, dtype=torch.complex64), x, torch.ones(4, 4))
    ck.poly_fir(torch.zeros(4), x.real.contiguous(), torch.ones(2, 4, 3),
                precision="bf16")
    pipe = T.Pipeline([T.fir_fft_stage(taps.numpy(), 256), T.mag2_stage()], np.complex64)
    pipe.fn()(pipe.init_carry("cpu"), x)
    pipe = T.Pipeline([T.rotator_stage(0.1, impl="pallas"),
                       T.fir_stage(taps.numpy(), decim=4, impl="pallas"),
                       T.quad_demod_stage(impl="pallas"),
                       T.resample_stage(3, 8, impl="pallas")], np.complex64)
    pipe.fn()(pipe.init_carry("cpu"), x)
    ck.pfb(torch.zeros(48, dtype=torch.complex64), x, torch.ones(4, 16))
    for impl in ("pallas", "auto"):
        pipe = T.Pipeline([T.channelizer_stage(16, impl=impl, precision="bf16")],
                          np.complex64)
        pipe.fn()(pipe.init_carry("cpu"), x)
    ck.fir_lanes(None, torch.stack([x, x]), torch.stack([taps, taps]))
    ck.fir_fft_lanes(torch.stack([hist, hist]), torch.stack([x, x]),
                     torch.stack([taps, taps]), 256)
    ck.rotator_lanes(torch.stack([x, x]), torch.zeros(2), torch.ones(2))
    assert set(ck.launches) == {"fir", "fir_fft", "rotator", "poly_fir", "quad_demod",
                                "pfb", "fir_lanes", "fir_fft_lanes", "rotator_lanes"}
    assert all(v == 0 for v in ck.launches.values()), ck.launches


def test_non_cuda_device_tensors_raise_instead_of_falling_back():
    """Only a CPU tensor takes the plain version; any other device must
    launch the kernel or raise."""
    x = torch.empty(1024, dtype=torch.complex64, device="meta")
    taps = torch.empty(16, device="meta")
    hist = torch.empty(15, dtype=torch.complex64, device="meta")
    before = dict(ck.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ck.fir(x, taps)
    with pytest.raises(ValueError, match="CUDA"):
        ck.fir_fft(hist, x, taps, 256)
    with pytest.raises(ValueError, match="CUDA"):
        ck.rotator(x, torch.empty((), device="meta"), torch.empty((), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ck.quad_demod(torch.empty((), dtype=torch.complex64, device="meta"), x, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        ck.poly_fir(torch.empty(12, dtype=torch.complex64, device="meta"), x,
                    torch.empty(4, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ck.pfb(torch.empty(48, dtype=torch.complex64, device="meta"), x,
               torch.empty(4, 16, device="meta"))
    x2, t2, h2 = x.expand(2, -1), taps.expand(2, -1), hist.expand(2, -1)
    with pytest.raises(ValueError, match="CUDA"):
        ck.fir_lanes(h2, x2, t2)
    with pytest.raises(ValueError, match="CUDA"):
        ck.fir_fft_lanes(h2, x2, t2, 256)
    with pytest.raises(ValueError, match="CUDA"):
        ck.rotator_lanes(x2, torch.empty(2, device="meta"), torch.empty(2, device="meta"))
    assert ck.launches == before


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_uplink_modules_load_alone():
    """The uplink plane's modules are the port's own: importing them and
    streaming sc16 through a kernel loads neither JAX, nor the JAX package,
    nor ``ml_dtypes`` (the card's machine has none; the port's bfloat16
    payload is its own bits)."""
    mods = _submodules()
    for m in ("ops.wire", "ops.codec_pool", "ops.ingest", "runtime.faults"):
        assert f"futuresdr_tpu_torch.{m}" in mods
    code = ("import sys\n"
            "import numpy as np\n"
            "from futuresdr_tpu_torch.ops import wire, codec_pool, ingest, xfer, arena\n"
            "from futuresdr_tpu_torch.runtime import faults\n"
            "from futuresdr_tpu_torch import Flowgraph, Runtime\n"
            "from futuresdr_tpu_torch.blocks import VectorSink, VectorSource\n"
            "from futuresdr_tpu_torch.ops import mag2_stage\n"
            "from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel\n"
            "x = np.ones(4096, np.complex64)\n"
            "fg = Flowgraph(); snk = VectorSink(np.float32)\n"
            "fg.connect(VectorSource(x), TpuKernel([mag2_stage()], np.complex64, 1024,\n"
            "           inst=TpuInstance('cpu'), wire='bf16'), snk)\n"
            "Runtime().run(fg)\n"
            "assert len(snk.items()) == 4096\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'futuresdr_tpu', 'ml_dtypes')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_utils_and_recovery_load_alone(tmp_path):
    """The ``utils`` package (the carry snapshots on disk) and the recovery
    path are the port's own: importing ``utils.snapshot`` and recovering a
    kernel from a persisted checkpoint load neither JAX nor the JAX
    package."""
    mods = _submodules()
    assert "futuresdr_tpu_torch.utils" in mods
    assert "futuresdr_tpu_torch.utils.snapshot" in mods
    code = ("import asyncio, sys\n"
            "import numpy as np\n"
            "from futuresdr_tpu_torch.utils import snapshot\n"
            "from futuresdr_tpu_torch.config import config\n"
            "from futuresdr_tpu_torch import BlockPolicy, Mocker\n"
            "from futuresdr_tpu_torch.ops import rotator_stage\n"
            "from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel\n"
            f"config().checkpoint_dir = {str(tmp_path)!r}\n"
            "def kern():\n"
            "    k = TpuKernel([rotator_stage(0.1)], np.complex64, 1024,\n"
            "                  inst=TpuInstance('cpu'), checkpoint_every=1)\n"
            "    k.meta.instance_name = 'k'\n"
            "    k.policy = BlockPolicy(on_error='restart')\n"
            "    return k\n"
            "m = Mocker(kern()); m.input('in', np.ones(4096, np.complex64))\n"
            "m.init_output('out', 4096); m.init(); m.run()\n"
            "snapshot.persist_executor().submit(lambda: None).result()\n"
            "k2 = kern(); asyncio.run(k2.init(k2.mio, k2.meta))\n"
            "assert asyncio.run(k2.recover(RuntimeError('restart')))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'futuresdr_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_device_axis_loads_alone():
    """The multi-device plane (``parallel``, ``shard``, ``tpu.sp_block``,
    ``tpu.pp_block``, ``utils.checkpoint``) is walked, and importing it,
    running a sharded FIR and a data-sharded program on logical CPU devices
    and training one MCLDNN step load neither JAX nor the JAX package."""
    new = {"futuresdr_tpu_torch.parallel", "futuresdr_tpu_torch.parallel.mesh",
           "futuresdr_tpu_torch.parallel.stream_sp", "futuresdr_tpu_torch.parallel.pipeline_pp",
           "futuresdr_tpu_torch.shard", "futuresdr_tpu_torch.shard.plan",
           "futuresdr_tpu_torch.shard.data", "futuresdr_tpu_torch.shard.model",
           "futuresdr_tpu_torch.tpu.sp_block", "futuresdr_tpu_torch.tpu.pp_block",
           "futuresdr_tpu_torch.utils.checkpoint", "futuresdr_tpu_torch.apps.sharded_spectrum"}
    assert new <= set(_submodules())
    code = ("import sys\n"
            "import numpy as np, torch\n"
            "import futuresdr_tpu_torch.parallel, futuresdr_tpu_torch.shard\n"
            "import futuresdr_tpu_torch.tpu.sp_block, futuresdr_tpu_torch.tpu.pp_block\n"
            "import futuresdr_tpu_torch.utils.checkpoint\n"
            "from futuresdr_tpu_torch.config import config\n"
            "from futuresdr_tpu_torch.parallel import make_mesh, sp_fir, to_host\n"
            "from futuresdr_tpu_torch.ops import stages as T\n"
            "from futuresdr_tpu_torch.shard import shard_pipeline, rows_to_host\n"
            "from futuresdr_tpu_torch.models import mcldnn\n"
            "config().virtual_devices = 4\n"
            "m = make_mesh(('sp',), shape=(4,), device='cpu')\n"
            "y = to_host(sp_fir(np.ones(5, np.float32), m)(np.ones(64, np.float32)))\n"
            "p = shard_pipeline(T.Pipeline([T.rotator_stage(0.1)], np.complex64), 'data', 4,\n"
            "                   device='cpu')\n"
            "fn, c = p.compile(256)\n"
            "_, ys = fn(c, np.ones((4, 256), np.complex64))\n"
            "net = mcldnn.init_params(mcldnn.MCLDNN(5, 4, 8), torch.Generator().manual_seed(0))\n"
            "opt = torch.optim.Adam(mcldnn.trainable_parameters(net), 1e-3)\n"
            "loss, _ = mcldnn.make_train_step(net, opt)(torch.zeros(2, 2, 32),\n"
            "                                           torch.zeros(2, dtype=torch.long))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'futuresdr_tpu', 'flax', 'optax', 'orbax')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad or y[-1] != 5 or rows_to_host(ys).shape != (4, 256) else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_a_short_mesh_never_falls_back(monkeypatch):
    """Without a card the mesh raises (no silent CPU), and more devices than
    exist are refused unless ``virtual_devices`` was set."""
    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.parallel import make_mesh, visible_devices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(config(), "virtual_devices", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        visible_devices()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(("sp",))
    with pytest.raises(ValueError, match="refusing"):
        make_mesh(("sp",), shape=(2,), device="cpu")
    monkeypatch.setattr(config(), "virtual_devices", 2)
    assert make_mesh(("sp",), shape=(2,), device="cpu").size == 2


def test_the_mesh_across_processes_the_entry_and_lora_load_alone(tmp_path):
    """``parallel.multihost``, ``parallel.sharded_train``, ``entry``, the LoRa
    model and its loopback app are walked; two rank processes that join a
    gloo group on localhost, build the global mesh, run a sharded FIR across
    it, load LoRa and the entry module, have neither JAX nor the JAX package
    (nor flax, optax, orbax) in ``sys.modules``."""
    import os
    import torch.distributed as dist
    new = {"futuresdr_tpu_torch.parallel.multihost",
           "futuresdr_tpu_torch.parallel.sharded_train", "futuresdr_tpu_torch.entry",
           "futuresdr_tpu_torch.models.lora", "futuresdr_tpu_torch.models.lora.phy",
           "futuresdr_tpu_torch.models.lora.coding", "futuresdr_tpu_torch.models.lora.blocks",
           "futuresdr_tpu_torch.models.lora.meshtastic",
           "futuresdr_tpu_torch.models.lora.forwarder",
           "futuresdr_tpu_torch.models.lora.multichannel",
           "futuresdr_tpu_torch.apps.lora_loopback"}
    assert new <= set(_submodules())
    if not dist.is_gloo_available():
        pytest.skip("this torch has no gloo backend")
    from futuresdr_tpu_torch.parallel import multihost
    script = tmp_path / "rank.py"
    script.write_text(
        "import sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from futuresdr_tpu_torch.config import config\n"
        "from futuresdr_tpu_torch.parallel import multihost, sp_fir, to_host\n"
        "import futuresdr_tpu_torch.entry, futuresdr_tpu_torch.apps.lora_loopback\n"
        "from futuresdr_tpu_torch.models.lora import LoraParams, modulate_frame\n"
        "rank = int(sys.argv[1])\n"
        "config().virtual_devices = 2\n"
        "multihost.initialize(sys.argv[2], 2, rank, device='cpu', timeout_s=60)\n"
        "m = multihost.global_mesh(('sp',))\n"
        "y = to_host(sp_fir(np.ones(5, np.float32), m)(np.ones(64, np.float32)))\n"
        "assert y[-1] == 5 and len(modulate_frame(b'x', LoraParams(sf=7))) > 0\n"
        "multihost.shutdown()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'futuresdr_tpu', 'flax', 'optax', 'orbax')]\n"
        "print('bad', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    results = multihost.launch(lambda r, c: [sys.executable, str(script), str(r), c], 2,
                               120, env=env, cwd=str(REPO))
    for rc, out in results:
        assert rc == 0 and "bad []" in out, out[-3000:]


def test_the_remaining_models_and_their_apps_load_alone():
    """M17, ZigBee, ADS-B, Rattlegram and ``models/misc.py``, and their six
    apps, are walked; loading them all and decoding an M17 frame of 512 steps
    on the CPU, a ZigBee frame and an ADS-B one loads neither JAX nor the JAX
    package."""
    new = {f"futuresdr_tpu_torch.models.{m}" for m in (
        "m17.phy", "m17.blocks", "zigbee", "zigbee.phy", "zigbee.blocks", "adsb",
        "adsb.phy", "adsb.decoder", "adsb.blocks", "rattlegram", "rattlegram.fec",
        "rattlegram.polar", "rattlegram.modem", "misc")}
    apps = {f"futuresdr_tpu_torch.apps.{a}" for a in (
        "m17_loopback", "zigbee_loopback", "adsb_rx", "rattlegram_loopback", "modem_ota",
        "cw_beacon")}
    assert new | apps <= set(_submodules())
    code = ("import importlib, sys\n"
            "import numpy as np\n"
            f"for m in {sorted(new | apps)!r}: importlib.import_module(m)\n"
            "from futuresdr_tpu_torch.models import m17, zigbee, adsb\n"
            "llrs = np.zeros(1024); llrs[::2] = 1.0\n"
            "assert len(m17.viterbi_decode_m17(llrs, 512, device='cpu')) == 512\n"
            "psdu = zigbee.mac_frame(b'alone')\n"
            "assert zigbee.demodulate_stream(np.concatenate([np.zeros(100, np.complex64), "
            "zigbee.modulate_frame(psdu), np.zeros(100, np.complex64)])) == [psdu]\n"
            "f = adsb.build_df17_frame(0xABCDEF, np.zeros(56, np.uint8))\n"
            "assert adsb.decode_frame(f).icao == 0xABCDEF\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'futuresdr_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_host_plane_loads_alone():
    """The host plane this slice ports is walked; loading it all, running a
    fused grid pipe natively and a flowgraph under the threaded scheduler,
    loads neither JAX nor the JAX package, nor ``sounddevice`` (imported only
    when a soundcard stream opens)."""
    new = {f"futuresdr_tpu_torch.{m}" for m in (
        "dsp.fxpt", "dsp.remez", "blocks.io", "blocks.audio", "runtime.dev",
        "runtime.fastchain", "runtime.scheduler.base", "runtime.scheduler.threaded",
        "apps.keyfob_rx", "apps.ssb_rx", "apps.file_trx", "apps.custom_routes")}
    assert new <= set(_submodules())
    code = ("import importlib, sys\n"
            "import numpy as np\n"
            f"for m in {sorted(new)!r}: importlib.import_module(m)\n"
            "from futuresdr_tpu_torch import Flowgraph, Runtime, ThreadedScheduler\n"
            "from futuresdr_tpu_torch.blocks import CopyRand, Fir, Head, NullSink, NullSource\n"
            "from futuresdr_tpu_torch.runtime.fastchain import find_native_chains\n"
            "taps = np.ones(64, np.float32) / 64\n"
            "for sched in (None, ThreadedScheduler(2)):\n"
            "    fg = Flowgraph(); snk = NullSink(np.float32)\n"
            "    fg.connect(NullSource(np.float32), Head(np.float32, 50_000),\n"
            "               CopyRand(np.float32, 4096), Fir(taps), snk)\n"
            "    assert len(find_native_chains(fg)) == 1\n"
            "    Runtime(sched).run(fg); assert snk.n_received == 50_000\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'futuresdr_tpu', 'sounddevice')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
