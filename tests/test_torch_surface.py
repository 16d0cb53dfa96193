"""The port's public surface holds the JAX package's, module by module.

Both packages are parsed with ``ast`` (neither is imported). For every ``.py``
module of ``futuresdr_tpu/`` there is one case: each public top-level
function, class and assigned name of the module has a counterpart in the
port's module of the same path (four modules are renamed, ``RENAMES``), and
so do each public method and attribute of a public class and each parameter
of a public callable. A name the port's module imports counts as its own.
The only exceptions are the rows of ``BY_DESIGN``, one a difference, each
with its reason; a row that no longer names a difference fails too.
"""

import ast
from pathlib import Path

import pytest
import torch

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "futuresdr_tpu"
PORT = REPO / "futuresdr_tpu_torch"

#: reference module -> the port's module of another name (None: no module)
RENAMES = {
    "models/wlan/jax_demod.py": "models/wlan/torch_demod.py",
    "ops/pallas_kernels.py": "ops/cuda_kernels.py",
    "tpu/pallas_tune.py": "tpu/kernel_tune.py",
    "ops/mxu_fft.py": None,
    "utils/backend.py": None,
}

_FLAX = "flax's parameters-as-argument: the port's model is an nn.Module that owns them"
_TREEDEF = "a jax pytree's treedef: the port's carry is a list of tensors"
_JAX = "JAX or XLA machinery"
_PALLAS = ("Pallas block shapes: the port's kernels take plans "
           "(ops/cuda_kernels.py, tpu/kernel_tune.py)")
_WIRED = ("the wired compile: the port's Pipeline.compile folds the wire in "
          "(futuresdr_tpu_torch/ops/stages.py)")
_BROKER = ("the jax device broker's placement: the port's TpuInstance holds one "
           "torch.device and the transfers live in ops/xfer.py")
_NEVER_READ = "min_items the reference never reads (futuresdr_tpu/runtime/buffer/ring.py)"

#: "module:name" (a top-level name), "module:Class.member", "module:fn(param)"
#: or "module:<module>" -> why the port has no counterpart
BY_DESIGN = {
    # JAX and XLA machinery
    "models/wlan/jax_demod.py:demod_head_jax": f"{_JAX}: a *_jax function "
                                               "(torch_demod.demod_head)",
    "models/wlan/jax_demod.py:demod_body_jax": f"{_JAX}: a *_jax function "
                                               "(torch_demod.demod_body)",
    "ops/wire.py:Wire.encode_jax": f"{_JAX}: a *_jax codec (Wire.encode_torch)",
    "ops/wire.py:Wire.decode_jax": f"{_JAX}: a *_jax codec (Wire.decode_torch)",
    "ops/wire.py:Wire.jit_encode": f"{_JAX}: a jit_* wrapper",
    "ops/wire.py:Wire.jit_decode": f"{_JAX}: a jit_* wrapper",
    "ops/wire.py:F32Wire.encode_jax": f"{_JAX}: a *_jax codec",
    "ops/wire.py:F32Wire.decode_jax": f"{_JAX}: a *_jax codec",
    "ops/wire.py:Bf16Wire.encode_jax": f"{_JAX}: a *_jax codec",
    "ops/wire.py:Bf16Wire.decode_jax": f"{_JAX}: a *_jax codec",
    "ops/xfer.py:PackedLayout.unpack_jax": f"{_JAX}: a *_jax unpack "
                                           "(PackedLayout.unpack_torch)",
    "ops/xfer.py:split_complex_platform": f"{_JAX}: device_put's complex pairs by "
                                          "XLA platform name",
    "ops/xfer.py:h2d_needs_staging": f"{_JAX}: device_put's read of a numpy view "
                                     "by XLA platform name",
    "ops/viterbi.py:backend_ready": f"{_JAX}: whether a jax backend is initialised",
    "ops/viterbi.py:tables_key_store": f"{_JAX}: the trellis tables a jitted "
                                       "lax.scan reads by key",
    "ops/stages.py:Pipeline.carry_matches(treedef)": _TREEDEF,
    "ops/stages.py:Pipeline.restore_carry(treedef)": _TREEDEF,
    "ops/stages.py:FanoutPipeline.donation_mask": f"{_JAX}: buffer donation (a CUDA "
                                                  "graph's carry lives in static buffers)",
    "ops/stages.py:DagPipeline.donation_mask": f"{_JAX}: buffer donation",
    "shard/data.py:collective_ops(compiled_text)": f"{_JAX}: reads an XLA program's "
                                                   "text",
    "shard/data.py:ShardedProgram.compiled_text": f"{_JAX}: an XLA program's text",
    "shard/data.py:ShardedProgram.sharding": f"{_JAX}: a NamedSharding",
    "shard/data.py:ShardedProgram.place": f"{_JAX}: device_put onto a sharding",
    "shard/data.py:ShardedProgram.fn": f"{_JAX}: the shard_map program (the port's "
                                       "program is ShardedProgram itself)",
    "shard/data.py:ShardedProgram.carry_matches(treedef)": _TREEDEF,
    "shard/data.py:ShardedProgram.restore_carry(treedef)": _TREEDEF,
    "shard/model.py:ModelShardedProgram.compiled_text": f"{_JAX}: an XLA program's text",
    "shard/model.py:ModelShardedProgram.place": f"{_JAX}: device_put onto a sharding",
    "tpu/pallas_tune.py:device_key(backend)": f"{_JAX}: a jax backend name",
    "utils/roofline.py:PEAKS": f"{_JAX}: peaks keyed by jax backend name "
                               "(utils/roofline.CHIP_PEAKS)",
    "utils/roofline.py:detect_peaks(backend)": f"{_JAX}: a jax backend name",
    "utils/roofline.py:pipeline_roofline(backend)": f"{_JAX}: a jax backend name",
    "utils/roofline.py:graph_roofline(backend)": f"{_JAX}: a jax backend name",
    "utils/roofline.py:cost_of(fn)": f"{_JAX}: XLA's cost analysis of a jitted fn "
                                     "(the port counts a pipeline analytically)",
    "utils/roofline.py:cost_of(args)": f"{_JAX}: the jitted fn's arguments",
    "utils/roofline.py:cost_of(compiled)": f"{_JAX}: an XLA compiled executable",
    "utils/backend.py:<module>": f"{_JAX}: jax backend probing; the broker "
                                 "(tpu/instance.py) resolves the card itself",
    "ops/mxu_fft.py:<module>": f"{_JAX}: the FFT as MXU matmuls; the port runs "
                               "torch.fft (cuFFT)",
    # the wired compile
    "ops/stages.py:Pipeline.compile_wired": _WIRED,
    "ops/stages.py:Pipeline.packed_wired_fn": _WIRED,
    "ops/stages.py:FanoutPipeline.compile_wired": _WIRED,
    "ops/stages.py:FanoutPipeline.packed_wired_fn": _WIRED,
    "ops/stages.py:DagPipeline.compile_wired": _WIRED,
    "ops/stages.py:DagPipeline.packed_wired_fn": _WIRED,
    # the Pallas names
    "ops/pallas_kernels.py:DEFAULT_BLOCKS": _PALLAS,
    "ops/pallas_kernels.py:tuned_blocks": _PALLAS,
    "ops/pallas_kernels.py:set_tuned_blocks": _PALLAS,
    "ops/pallas_kernels.py:pallas_fir": f"{_PALLAS}; the wrapper is cuda_kernels.fir",
    "ops/pallas_kernels.py:pallas_fir_continue": f"{_PALLAS}; cuda_kernels.fir takes "
                                                 "the history",
    "ops/pallas_kernels.py:pallas_fir_stage": f"{_PALLAS}; fir_stage(impl='pallas')",
    "ops/pallas_kernels.py:pallas_fir_fft": f"{_PALLAS}; cuda_kernels.fir_fft",
    "ops/pallas_kernels.py:pallas_pfb": f"{_PALLAS}; cuda_kernels.pfb",
    "ops/pallas_kernels.py:pallas_poly_fir": f"{_PALLAS}; cuda_kernels.poly_fir",
    "ops/pallas_kernels.py:pallas_rotator": f"{_PALLAS}; cuda_kernels.rotator",
    "ops/pallas_kernels.py:pallas_quad_demod": f"{_PALLAS}; cuda_kernels.quad_demod",
    "tpu/pallas_tune.py:CANDIDATE_BLOCKS": f"{_PALLAS}; the plans' candidates",
    "tpu/pallas_tune.py:sweep_blocks": f"{_PALLAS}; kernel_tune's sweep of plans",
    "tpu/autotune.py:record_pallas_blocks(blocks)": f"{_PALLAS}; it records plans",
    "tpu/autotune.py:autotune_pallas_blocks(frame)": f"{_PALLAS}; the plan sweep "
                                                     "times the main paths' shapes "
                                                     "(shapes=), not one frame",
    # flax's parameters-as-argument
    "models/mcldnn.py:init_params(n)": _FLAX,
    "models/mcldnn.py:init_params(seed)": f"{_FLAX}; weights come from a generator",
    "models/mcldnn.py:loss_fn(params)": _FLAX,
    "models/modrec.py:ModClassifier.__init__(params)": _FLAX,
    # the jax device broker
    "tpu/instance.py:force_cpu_platform": f"{_BROKER}; TpuInstance('cpu') asks "
                                          "for the CPU",
    "tpu/instance.py:TpuInstance.__init__(platform)": _BROKER,
    "tpu/instance.py:TpuInstance.platform": _BROKER,
    "tpu/instance.py:TpuInstance.put": _BROKER,
    "tpu/instance.py:TpuInstance.get": _BROKER,
    "tpu/instance.py:TpuInstance.get_async": _BROKER,
    "runtime/buffer/circular.py:probe_native": "the host library builds through "
                                               "ops/_build.load_host",
    # the reader's min_items, never read
    "runtime/buffer/__init__.py:BufferWriter.add_reader(min_items)": _NEVER_READ,
    "runtime/buffer/circular.py:CircularWriter.add_reader(min_items)": _NEVER_READ,
    "runtime/buffer/ring.py:RingWriter.add_reader(min_items)": _NEVER_READ,
    # structural differences of the port's own, each in ROADMAP.md
    "runtime/buffer/circular.py:CircularReader.__init__(ring_idx)":
        "made only by CircularWriter.add_reader, from the reader state the writer "
        "keeps (the two do not refer to each other)",
    "runtime/buffer/circular.py:CircularReader.__init__(inbox)": "as ring_idx",
    "runtime/buffer/circular.py:CircularReader.__init__(port_index)": "as ring_idx",
    "runtime/buffer/circuit.py:InplaceOutput.put_full(buf)":
        "an in-place frame is a device tensor (frame) with its ready event, not a "
        "host buffer",
    "runtime/buffer/circuit.py:InplaceInput.push(buf)": "as InplaceOutput.put_full",
    "serve/api.py:healthz": "an aiohttp handler: the port's control port is standard "
                            "library, its route is _healthz(method, body)",
    "serve/api.py:readyz": "an aiohttp handler: the port's route is "
                           "_readyz(method, body)",
}

#: the gaps this surface closed in the port (none of them may be a row)
PORTED = (
    "runtime/buffer/__init__.py:StreamOutput.__init__(buffer)",
    "runtime/buffer/__init__.py:StreamOutput.__init__(preferred_buffer_size)",
    "runtime/kernel.py:Kernel.add_stream_output(buffer)",
    "runtime/kernel.py:Kernel.add_stream_output(preferred_buffer_size)",
    "runtime/flowgraph.py:Flowgraph.connect_stream(buffer_size)",
    "runtime/flowgraph.py:StreamEdge.buffer_size",
    "runtime/fastchain.py:run_chain_task(ring_items)",
    "dsp/firdes.py:highpass", "dsp/firdes.py:bandpass", "dsp/firdes.py:bandstop",
    "dsp/firdes.py:hilbert", "dsp/firdes.py:remez",
    "runtime/runtime.py:FlowgraphMessage", "runtime/runtime.py:InitializedMsg.ok",
    "log.py:init", "config.py:Config.log_level", "config.py:Config.slab_reserved",
    "config.py:Config.stack_size", "config.py:Config.misc",
    "tpu/pp_block.py:PpKernel.warmup",
)

_FN = (ast.FunctionDef, ast.AsyncFunctionDef)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _flat(body):
    """A body's statements, with those of ``if`` and ``try`` blocks inlined."""
    for s in body:
        if isinstance(s, ast.If):
            yield from _flat(s.body)
            yield from _flat(s.orelse)
        elif isinstance(s, ast.Try):
            yield from _flat(s.body)
            for h in s.handlers:
                yield from _flat(h.body)
            yield from _flat(s.orelse)
            yield from _flat(s.finalbody)
        else:
            yield s


def _assigned(s):
    """The plain names an assignment binds."""
    if isinstance(s, ast.Assign):
        return [n.id for t in s.targets for n in ast.walk(t) if isinstance(n, ast.Name)]
    if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name):
        return [s.target.id]
    return []


def _members(body) -> dict:
    """name -> node of the functions, classes and assignments of a body."""
    out = {}
    for s in _flat(body):
        if isinstance(s, _FN + (ast.ClassDef,)):
            out[s.name] = s
        for n in _assigned(s):
            out.setdefault(n, s)
    return out


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls") and _public(n)]


class _Module:
    def __init__(self, tree: ast.Module):
        self.names = _members(tree.body)
        self.imported = {(al.asname or al.name).split(".")[0]
                         for s in _flat(tree.body) if isinstance(s, (ast.Import, ast.ImportFrom))
                         for al in s.names}


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text())


def _port_classes() -> dict:
    """Every class of the port by name (a base may live in another module)."""
    out = {}
    for p in sorted(PORT.rglob("*.py")):
        for s in ast.walk(_parse(p)):
            if isinstance(s, ast.ClassDef):
                out.setdefault(s.name, s)
    return out


_PORT_CLASSES = _port_classes()


def _class_surface(cls, seen=()) -> dict:
    """A port class's members with its bases' (looked up by name in the
    port), plus the attributes its methods assign on ``self``."""
    out = {}
    for b in cls.bases:
        name = b.id if isinstance(b, ast.Name) else getattr(b, "attr", None)
        if name in _PORT_CLASSES and name not in seen:
            out.update(_class_surface(_PORT_CLASSES[name], seen + (name,)))
    own = _members(cls.body)
    for fn in own.values():
        if isinstance(fn, _FN):
            for n in ast.walk(fn):
                if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                        and n.value.id == "self" and isinstance(n.ctx, ast.Store):
                    out.setdefault(n.attr, n)
    out.update(own)
    return out


def _init_params(members: dict) -> list:
    """A class's constructor parameters: its ``__init__``'s, else (a
    dataclass) its annotated fields."""
    if isinstance(members.get("__init__"), _FN):
        return _params(members["__init__"])
    return [n for n, s in members.items() if isinstance(s, ast.AnnAssign)]


def _differences(rel: str, port_tree=None) -> list:
    """The reference module's public names, members and parameters that the
    port's module (``port_tree``: that module as parsed, changed) lacks, as
    ``BY_DESIGN`` keys."""
    port_rel = RENAMES.get(rel, rel)
    if port_rel is None or not (PORT / port_rel).is_file():
        return [f"{rel}:<module>"]
    ref = _Module(_parse(REF / rel))
    port = _Module(port_tree if port_tree is not None else _parse(PORT / port_rel))
    out = []
    for name, node in ref.names.items():
        if not _public(name):
            continue
        theirs = port.names.get(name)
        if theirs is None:
            if name not in port.imported:
                out.append(f"{rel}:{name}")
            continue
        if isinstance(node, _FN) and isinstance(theirs, _FN):
            out += [f"{rel}:{name}({p})" for p in _params(node) if p not in _params(theirs)]
        if not (isinstance(node, ast.ClassDef) and isinstance(theirs, ast.ClassDef)):
            continue
        mine, have = _members(node.body), _class_surface(theirs)
        if "__init__" in mine:
            want = _init_params(have)
            out += [f"{rel}:{name}.__init__({p})" for p in _params(mine["__init__"])
                    if p not in want]
        for m, mnode in mine.items():
            if not _public(m):
                continue
            if m not in have:
                out.append(f"{rel}:{name}.{m}")
            elif isinstance(mnode, _FN) and isinstance(have[m], _FN):
                out += [f"{rel}:{name}.{m}({p})" for p in _params(mnode)
                        if p not in _params(have[m])]
    return out


REF_MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
                     if "__pycache__" not in p.parts)


@pytest.mark.parametrize("rel", REF_MODULES)
def test_module_surface_has_its_counterpart(rel):
    found = set(_differences(rel))
    rows = {k for k in BY_DESIGN if k.split(":", 1)[0] == rel}
    missing = sorted(found - rows)
    assert not missing, f"the port lacks these names of futuresdr_tpu/{rel}: {missing}"
    stale = sorted(rows - found)
    assert not stale, f"BY_DESIGN rows that name no difference any more: {stale}"


def test_one_case_per_reference_module():
    assert len(REF_MODULES) == len(set(REF_MODULES)) > 100
    assert {k.split(":", 1)[0] for k in BY_DESIGN} <= set(REF_MODULES)
    assert all(RENAMES[k] is None or (PORT / RENAMES[k]).is_file() for k in RENAMES)


def test_the_ported_gaps_are_no_rows_of_the_table():
    assert not set(PORTED) & set(BY_DESIGN)
    assert all(reason.strip() for reason in BY_DESIGN.values())


@pytest.mark.parametrize("key", PORTED)
def test_a_ported_gap_would_show_if_taken_out(key):
    """The port's module with the ported name (or parameter) taken out of
    its parse reports the gap."""
    rel, name = key.split(":", 1)
    tree = _parse(PORT / RENAMES.get(rel, rel))
    path, _, param = name.rstrip(")").partition("(")
    body = tree.body
    *outer, last = path.split(".")
    for part in outer:
        body = _members(body)[part].body
    node = _members(body)[last]
    if param:
        a = node.args
        for seq in (a.posonlyargs, a.args, a.kwonlyargs):
            seq[:] = [x for x in seq if x.arg != param]
    else:
        body.remove(node)
    assert key not in _differences(rel)
    assert key in _differences(rel, tree)
