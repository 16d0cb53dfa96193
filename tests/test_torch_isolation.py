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


def test_sources_import_no_jax_and_no_jax_package():
    offenders = []
    for path in sorted(PKG_DIR.rglob("*.py")) + [REPO / "chip_smoke.py",
                                                 REPO / "port_profile.py",
                                                 REPO / "port_buffers.py"]:
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
    assert set(ck.launches) == {"fir", "fir_fft", "rotator", "poly_fir", "quad_demod",
                                "pfb"}
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
    assert ck.launches == before


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
