"""``tests/test_gui_js.py`` on the port: the widget library the port's
control port serves (``futuresdr_tpu_torch/gui/widgets.js``), validated
structurally and executed by the port's copy of the jsmini interpreter
(``futuresdr_tpu_torch/gui/jsmini.py``) against the port's control port;
then ``tests/test_trace_gui.py``'s GUI cases on the port (the page served
beside an own route, the widgets served and a browser-style retune of the
port's FM app), the port's GUI files byte-equal to the JAX package's, the
same GETs (the page, a widget file, a missing file, traversal paths) given
the same status and body by both control ports, and config
``frontend_path`` served. Every server binds a port the OS found free.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

WIDGETS = Path(__file__).resolve().parent.parent / "futuresdr_tpu_torch/gui/widgets.js"
SRC = WIDGETS.read_text()

EXPORTS = [
    "Handle", "Pmt", "pollPeriodically", "callPeriodically",
    "FlowgraphCanvas", "FlowgraphTable", "MetricsTable", "PmtEditor",
    "DoctorPanel",
    "Slider", "RadioSelector", "ListSelector",
    "GL", "Waterfall", "Waterfall2D", "TimeSink",
    "ConstellationSink", "ConstellationSinkDensity", "ConstellationSinkDensity2D",
    "ArrayView",
]


def _strip(src: str) -> str:
    """Remove comments and string/template literals (leaving brace-free stubs)."""
    out, i, n = [], 0, len(src)
    while i < n:
        c = src[i]
        if c == "/" and i + 1 < n and src[i + 1] == "*":
            j = src.find("*/", i + 2)
            i = (j + 2) if j != -1 else n
        elif c == "/" and i + 1 < n and src[i + 1] == "/":
            j = src.find("\n", i)
            i = j if j != -1 else n
        elif c in "'\"`":
            q, j = c, i + 1
            while j < n and src[j] != q:
                j += 2 if src[j] == "\\" else 1
            out.append("''")
            i = j + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def test_brace_balance():
    stripped = _strip(SRC)
    for o, c in ("{}", "()", "[]"):
        assert stripped.count(o) == stripped.count(c), f"unbalanced {o}{c}"
    # nesting never goes negative (catches transposed closers)
    depth = 0
    for ch in stripped:
        depth += ch == "{"
        depth -= ch == "}"
        assert depth >= 0
    assert depth == 0


def test_widget_inventory_complete():
    for name in EXPORTS:
        assert re.search(rf"FSDR\.{re.escape(name)}\s*=", SRC), f"missing FSDR.{name}"
    assert "module.exports = FSDR" in SRC


def _shader(name: str) -> str:
    """Extract a shader built as FSDR.NAME = [ '...', ... ].join('\\n')."""
    m = re.search(rf"FSDR\.{name}\s*=\s*\[(.*?)\]\.join", SRC, re.S)
    assert m, f"shader {name} not found"
    lines = re.findall(r"'((?:[^'\\]|\\.)*)'", m.group(1))
    return "\n".join(lines)


@pytest.mark.parametrize("frag", ["WATERFALL_FRAG", "DENSITY_FRAG"])
def test_glsl_structure(frag):
    vert, f = _shader("GL.VERT"), _shader(frag)
    for sh in (vert, f):
        assert sh.splitlines()[0].strip() == "#version 300 es"
        assert re.search(r"void\s+main\s*\(\s*\)", sh)
    # vertex out == fragment in (the varying)
    v_outs = set(re.findall(r"out\s+vec\d\s+(\w+)\s*;", vert))
    f_ins = set(re.findall(r"in\s+vec\d\s+(\w+)\s*;", f))
    assert v_outs == f_ins == {"uv"}
    assert "gl_Position" in vert
    # the fragment output is declared and written
    f_out = re.findall(r"out\s+vec4\s+(\w+)\s*;", f)
    assert len(f_out) == 1 and f"{f_out[0]} =" in f
    # every declared uniform is used in the body
    for u in re.findall(r"uniform\s+\w+\s+(\w+)\s*;", f):
        body = f.split("void main()", 1)[1]
        assert u in body, f"uniform {u} declared but unused in {frag}"


@pytest.mark.parametrize("frag,widget", [("WATERFALL_FRAG", "Waterfall"),
                                         ("DENSITY_FRAG", "ConstellationSinkDensity")])
def test_js_uniforms_match_glsl(frag, widget):
    """Every getUniformLocation(...) name in the widget's constructor exists in
    its shader — a renamed uniform fails CI instead of silently returning null."""
    f = _shader(frag)
    declared = set(re.findall(r"uniform\s+\w+\s+(\w+)\s*;", f))
    m = re.search(rf"FSDR\.{widget} = function(.*?)FSDR\.{widget}\.prototype",
                  SRC, re.S)
    assert m, widget
    fetched = set(re.findall(r"getUniformLocation\([^,]+,\s*'(\w+)'\)", m.group(1)))
    assert fetched <= declared, f"{widget} fetches unknown uniforms {fetched - declared}"
    assert declared <= fetched, f"{widget} never binds uniforms {declared - fetched}"


def test_gl_paths_guarded_by_fallback():
    """Both GPU sinks construct AS their canvas-2D sibling when WebGL2 is
    missing (constructor return value — state and controls then operate on the
    object that actually renders)."""
    for widget in ("Waterfall", "ConstellationSinkDensity"):
        m = re.search(rf"FSDR\.{widget} = function(.*?)FSDR\.{widget}\.prototype",
                      SRC, re.S)
        assert re.search(rf"return new FSDR\.\w+2D\(", m.group(1)), \
            f"{widget} lacks a 2D fallback construction"


NODE = shutil.which("node") or shutil.which("nodejs")


@pytest.mark.skipif(NODE is None, reason="no JS runtime in this image")
def test_execution_smoke_under_node():
    r = subprocess.run(
        [NODE, str(Path(__file__).resolve().parent / "gui_smoke.js"), str(WIDGETS)],
        capture_output=True, text=True, timeout=60)
    sys.stdout.write(r.stdout)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# EXECUTION layer (VERDICT r3 item 9): the widget code RUNS in CI through the
# vendored jsmini interpreter (gui/jsmini.py) — no node needed. DOM/canvas/GL
# hosts below are recording stubs; fetch is a SYNCHRONOUS bridge to a real
# control-port server where the test needs one.
# ---------------------------------------------------------------------------
import numpy as np

from futuresdr_tpu_torch.gui.jsmini import Interp, JSObject, UNDEF


class _El:
    """Minimal DOM element: attributes + children + recorded text."""

    def __init__(self, tag="div"):
        self.tag = tag
        self.children = []
        self.textContent = ""
        self.innerHTML = ""
        self.className = ""
        self.value = ""
        self.rows = []
        self._listeners = {}
        self.style = JSObject()          # e.g. the MetricsTable busy bar width

    def appendChild(self, el):
        self.children.append(el)
        return el

    def addEventListener(self, name, fn):
        self._listeners[name] = fn

    def removeEventListener(self, name, fn):
        if self._listeners.get(name) is fn:
            del self._listeners[name]

    def getBoundingClientRect(self):
        o = JSObject()
        o.set("left", 0.0)
        o.set("top", 0.0)
        return o

    def insertRow(self):
        r = _El("tr")
        self.rows.append(r)
        return r

    def deleteRow(self, i):
        del self.rows[int(i)]

    def insertCell(self):
        c = _El("td")
        self.children.append(c)
        return c

    def getContext(self, kind, *a):
        if kind == "2d":
            if not hasattr(self, "_ctx2d"):
                self._ctx2d = _Ctx2D(self)
            return self._ctx2d
        return None                       # no WebGL2 → fallback paths


class _ImageData:
    def __init__(self, w, h):
        self.width, self.height = int(w), int(h)
        self.data = [0.0] * (4 * int(w) * int(h))


class _Ctx2D:
    """Recording canvas-2D context; putImageData keeps the last row/pixels."""

    def __init__(self, cv):
        self.cv = cv
        self.fillStyle = ""
        self.strokeStyle = ""
        self.font = ""
        self.imageSmoothingEnabled = True
        self.ops = []
        self.last_image = None

    def _rec(self, *a):
        self.ops.append(a)

    def fillRect(self, *a):
        self._rec("fillRect", *a)

    def strokeRect(self, *a):
        self._rec("strokeRect", *a)

    def fillText(self, *a):
        self._rec("fillText", *a)

    def beginPath(self, *a):
        self._rec("beginPath")

    def moveTo(self, *a):
        self._rec("moveTo", *a)

    def lineTo(self, *a):
        self._rec("lineTo", *a)

    def bezierCurveTo(self, *a):
        self._rec("bezier", *a)

    def stroke(self, *a):
        self._rec("stroke")

    def fill(self, *a):
        self._rec("fill")

    def setLineDash(self, *a):
        self._rec("dash", *a)

    def drawImage(self, *a):
        self._rec("drawImage", *a)

    def createImageData(self, w, h):
        return _ImageData(w, h)

    def putImageData(self, img, x, y):
        self.last_image = img
        self._rec("putImageData", x, y)


class _Doc:
    def createElement(self, tag):
        return _El(tag)

    def createTextNode(self, text):
        el = _El("#text")
        el.textContent = text
        return el


def _canvas(w=320, h=200):
    cv = _El("canvas")
    cv.width = float(w)
    cv.height = float(h)
    return cv


def _interp(fetch=None):
    i = Interp(hosts={"document": _Doc()})
    if fetch is not None:
        i.genv.vars["fetch"] = fetch
    i.run(SRC)
    return i


def test_exec_pmt_roundtrip():
    """FSDR.Pmt builders + parse() EXECUTE and serialize exactly like the
    Python Pmt JSON wire format (types/pmt.py)."""
    from futuresdr_tpu_torch.types import Pmt
    i = _interp()
    cases = [
        ("FSDR.Pmt.f64(3.25)", Pmt.f64(3.25)),
        ("FSDR.Pmt.u32(7)", Pmt.u32(7)),
        ("FSDR.Pmt.bool_(true)", Pmt.bool_(True)),
        ("FSDR.Pmt.string('hi')", Pmt.string("hi")),
        ("FSDR.Pmt.parse('F64', '2.5')", Pmt.f64(2.5)),
        ("FSDR.Pmt.parse('Usize', '42')", Pmt.usize(42)),
        ("FSDR.Pmt.parse('Bool', 'true')", Pmt.bool_(True)),
        ("FSDR.Pmt.parse('Null', '')", Pmt.null()),
        ("FSDR.Pmt.parse('JSON', '{\"F32\": 1.5}')", Pmt.f32(1.5)),
    ]
    for js, py in cases:
        js_json = i.eval(f"JSON.stringify({js})")
        assert Pmt.from_json(json_mod.loads(js_json)) == py, (js, js_json)
    # u32 wraps like JS >>> 0
    assert i.eval("FSDR.Pmt.u32(4294967296 + 5).U32") == 5.0


import json as json_mod  # noqa: E402


def test_exec_flowgraph_canvas_layout_and_click():
    """FlowgraphCanvas lays out a real describe() JSON by topological rank and
    click dispatch selects the right block — executed, not grepped."""
    desc_py = {
        "id": 0,
        "blocks": [
            {"id": 0, "instance_name": "src", "stream_inputs": [],
             "stream_outputs": ["out"], "message_inputs": [], "blocking": False},
            {"id": 1, "instance_name": "fir", "stream_inputs": ["in"],
             "stream_outputs": ["out"], "message_inputs": ["taps"],
             "blocking": False},
            {"id": 2, "instance_name": "snk", "stream_inputs": ["in"],
             "stream_outputs": [], "message_inputs": [], "blocking": False},
        ],
        "stream_edges": [[0, "out", 1, "in"], [1, "out", 2, "in"]],
        "message_edges": [],
    }
    i = _interp()
    cv = _canvas(300, 120)
    i.genv.vars["__cv"] = cv
    i.run("const fgc = new FSDR.FlowgraphCanvas(__cv, "
          "{onSelect: b => { __sel.push(b.instance_name); }});")
    i.genv.vars["__sel"] = []
    i.run(f"fgc.update(JSON.parse({json_mod.dumps(json_mod.dumps(desc_py))}));")
    fgc = i.get("fgc")
    boxes = fgc.get("boxes")
    assert len(boxes) == 3
    xs = {b.get("blk").get("instance_name"): b.get("x") for b in boxes}
    assert xs["src"] < xs["fir"] < xs["snk"]     # rank order left→right
    # boxes live inside the canvas
    for b in boxes:
        assert 0 <= b.get("x") and b.get("x") + b.get("w") <= 300
        assert 0 <= b.get("y") and b.get("y") + b.get("h") <= 120
    # drawing recorded edges + boxes
    ctx = cv.getContext("2d")
    kinds = [op[0] for op in ctx.ops]
    assert kinds.count("bezier") == 2 and "fillText" in kinds
    # synthetic click on the middle block fires onSelect
    mid = [b for b in boxes if b.get("blk").get("instance_name") == "fir"][0]
    ev = JSObject()
    ev.set("clientX", mid.get("x") + 2.0)
    ev.set("clientY", mid.get("y") + 2.0)
    i.call(cv._listeners["click"], UNDEF, ev)
    assert i.genv.vars["__sel"] == ["fir"]
    assert fgc.get("selected") == 1.0


def test_exec_handle_against_real_rest_server():
    """FSDR.Handle + PmtEditor call path against the REAL control port: the
    fetch bridge is synchronous urllib, the server is a live flowgraph."""
    import time
    import urllib.request

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import MessageSink, MessageSource
    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.types import Pmt as PyPmt

    config().ctrlport_enable = True
    old_bind = config().ctrlport_bind
    config().ctrlport_bind = "127.0.0.1:0"
    running = None
    try:
        fg = Flowgraph()
        src = MessageSource(PyPmt.string("x"), interval=0.05, count=400)
        snk = MessageSink()
        fg.connect_message(src, "out", snk, "in")
        rt = Runtime()
        running = rt.start(fg)
        base = rt.ctrl_port.url
        # readiness poll: the control-port server binds on the scheduler loop
        # asynchronously — a fixed sleep raced it under full-suite load (the
        # one flaky failure of round 5's suite runs)
        deadline = time.time() + 15
        while time.time() < deadline:
            try:
                urllib.request.urlopen(
                    base + "/api/fg/0/", timeout=2).read()
                break
            except Exception:
                time.sleep(0.1)
        else:
            raise RuntimeError("control port never became ready")

        def fetch(url, opts=UNDEF):
            req = urllib.request.Request(url)
            data = None
            if opts is not UNDEF and opts and opts.get("body") is not UNDEF:
                data = opts.get("body").encode()
                req = urllib.request.Request(url, data=data, method="POST")
                req.add_header("Content-Type", "application/json")
            body = urllib.request.urlopen(req, timeout=5).read().decode()
            resp = JSObject()
            resp.set("json", lambda: json_to_js(body))
            return resp

        i = _interp(fetch=fetch)

        def json_to_js(s):
            return i.eval(f"JSON.parse({json_mod.dumps(s)})")

        i.run(f"const h = new FSDR.Handle('{base}/');")
        fgs = i.eval("h.flowgraphs()")
        assert i.eval("JSON.stringify(h.flowgraphs())") == "[0]"
        desc = i.eval("h.describe(0)")
        names = [b.get("instance_name") for b in desc.get("blocks")]
        assert any("MessageSource" in n for n in names)
        # FlowgraphTable renders the real description
        tbl = _El("table")
        tbl.rows.append(_El("tr"))        # header row
        i.genv.vars["__tbl"] = tbl
        i.genv.vars["__desc"] = desc
        i.run("new FSDR.FlowgraphTable(__tbl).update(__desc);")
        assert len(tbl.rows) == 1 + len(names)
        del fgs
    finally:
        if running is not None:
            running.stop_sync()
            rt.shutdown()
        config().ctrlport_enable = False
        config().ctrlport_bind = old_bind


def test_exec_waterfall2d_and_timesink_render():
    """The canvas-2D waterfall + TimeSink paint real pixel rows from data."""
    i = _interp()
    cv = _canvas(64, 32)
    i.genv.vars["__cv"] = cv
    i.run("const wf = new FSDR.Waterfall2D(__cv, {autorange: true});")
    ramp = list(np.linspace(0.0, 1.0, 64))
    i.genv.vars["__data"] = ramp
    for _ in range(30):                   # let autorange converge
        i.run("wf.frame(__data);")
    img = cv.getContext("2d").last_image
    assert img is not None and img.width == 64
    reds = [img.data[4 * x] for x in range(64)]
    assert reds[0] < reds[20] < reds[40]  # ramp maps to increasing intensity
    assert all(img.data[4 * x + 3] == 255 for x in range(64))

    cv2 = _canvas(64, 32)
    i.genv.vars["__cv2"] = cv2
    i.run("const ts = new FSDR.TimeSink(__cv2); ts.frame(__data);")
    ops = [o[0] for o in cv2.getContext("2d").ops]
    assert "lineTo" in ops and "stroke" in ops


def test_exec_density_histogram_finds_qpsk_clusters():
    """ConstellationSinkDensity.accumulate (shared by GL + 2D paths) bins QPSK
    points into exactly 4 hotspots."""
    i = _interp()
    cv = _canvas(64, 64)
    i.genv.vars["__cv"] = cv
    i.run("const cs = new FSDR.ConstellationSinkDensity2D(__cv, {bins: 32});")
    rng = np.random.default_rng(0)
    pts = []
    for _ in range(400):
        s = rng.integers(0, 4)
        re_ = (1 if s & 1 else -1) * 0.7 + rng.normal(0, 0.02)
        im = (1 if s & 2 else -1) * 0.7 + rng.normal(0, 0.02)
        pts += [float(re_), float(im)]
    i.genv.vars["__iq"] = pts
    i.run("cs.frame(__iq);")
    hist = np.asarray(list(i.eval("cs.hist")), dtype=float).reshape(32, 32)
    # 4 clusters: count cells above half-peak, grouped in 4 quadrants
    hot = hist > hist.max() / 2
    quads = [hot[:16, :16].sum(), hot[:16, 16:].sum(),
             hot[16:, :16].sum(), hot[16:, 16:].sum()]
    assert all(q >= 1 for q in quads), quads
    # the renderer paints into its offscreen scratch then blits to the canvas
    off_img = i.eval("cs.off").getContext("2d").last_image
    assert off_img is not None and off_img.width == 32
    assert any(op[0] == "drawImage" for op in cv.getContext("2d").ops)


class _GLRec:
    """Recording WebGL2 stub: enough surface for FSDR.GL + the GPU sinks."""

    def __init__(self):
        for i, name in enumerate(
            ("VERTEX_SHADER", "FRAGMENT_SHADER", "COMPILE_STATUS",
             "LINK_STATUS", "ARRAY_BUFFER", "STATIC_DRAW", "FLOAT",
             "TEXTURE_2D", "TEXTURE_WRAP_S", "TEXTURE_WRAP_T", "CLAMP_TO_EDGE",
             "REPEAT", "TEXTURE_MIN_FILTER", "TEXTURE_MAG_FILTER", "NEAREST",
             "LINEAR", "UNPACK_ALIGNMENT", "R32F", "RED", "RGBA",
             "UNSIGNED_BYTE", "TRIANGLE_STRIP")):
            setattr(self, name, float(i + 1))
        self.TEXTURE0 = 100.0
        self.calls = []
        self.uniforms = {}
        self._shader_srcs = {}

    def _rec(self, *a):
        self.calls.append(a)

    def createShader(self, t):
        sh = _El("shader")
        sh.type = t
        return sh

    def shaderSource(self, sh, src):
        self._shader_srcs[id(sh)] = src

    def compileShader(self, sh):
        self._rec("compile")

    def getShaderParameter(self, sh, p):
        return True

    def getShaderInfoLog(self, sh):
        return ""

    def createProgram(self):
        return _El("prog")

    def attachShader(self, p, sh):
        self._rec("attach")

    def linkProgram(self, p):
        self._rec("link")

    def getProgramParameter(self, p, s):
        return True

    def getProgramInfoLog(self, p):
        return ""

    def useProgram(self, p):
        self._rec("useProgram")

    def createBuffer(self):
        return _El("buf")

    def bindBuffer(self, *a):
        self._rec("bindBuffer")

    def bufferData(self, target, data, usage):
        self._rec("bufferData", list(data))

    def getAttribLocation(self, p, name):
        return 0.0

    def enableVertexAttribArray(self, loc):
        self._rec("enableVA")

    def vertexAttribPointer(self, *a):
        self._rec("vap")

    def createTexture(self):
        return _El("tex")

    def activeTexture(self, unit):
        self._rec("activeTexture", unit)

    def bindTexture(self, *a):
        self._rec("bindTexture")

    def texParameteri(self, *a):
        self._rec("texParameteri", *a)

    def pixelStorei(self, *a):
        self._rec("pixelStorei")

    def texImage2D(self, *a):
        self._rec("texImage2D", *a)

    def texSubImage2D(self, *a):
        self._rec("texSubImage2D", *a)

    def deleteTexture(self, t):
        self._rec("deleteTexture")

    def getUniformLocation(self, p, name):
        return name

    def uniform1i(self, name, v):
        self.uniforms[name] = v

    def uniform1f(self, name, v):
        self.uniforms[name] = v

    def viewport(self, *a):
        self._rec("viewport", *a)

    def drawArrays(self, *a):
        self._rec("drawArrays", *a)


def test_exec_waterfall_gl_path_ring_and_uniforms():
    """The WebGL2 waterfall EXECUTES against a recording GL stub: shaders
    compile+link, the LUT is a monotonic 256-entry ramp, each frame uploads
    one row and advances the ring, and yoffset tracks row/history."""
    i = _interp()
    gl = _GLRec()
    cv = _canvas(128, 64)
    cv.getContext = lambda kind, *a: gl if kind == "webgl2" else None
    i.genv.vars["__cv"] = cv
    i.run("const wf = new FSDR.Waterfall(__cv, {history: 8, autorange: true});")
    wf = i.get("wf")
    assert wf.get("fallback") is UNDEF     # took the GL path
    # LUT uploaded: 256 RGBA texels, alpha opaque, channels within range
    luts = [c for c in gl.calls if c[0] == "texImage2D" and len(c) > 9
            and isinstance(c[-1], list) and len(c[-1]) == 1024]
    assert luts, "LUT texture never uploaded"
    lut = luts[0][-1]
    assert all(lut[4 * k + 3] == 255 for k in range(256))
    assert lut[0] < lut[4 * 255]           # dark → bright ramp (red channel)
    data = [float(v) for v in np.linspace(-3, 3, 32)]
    i.genv.vars["__d"] = data
    n_before = len([c for c in gl.calls if c[0] == "texSubImage2D"])
    for k in range(3):
        i.run("wf.frame(__d);")
        assert wf.get("row") == float((k + 1) % 8)
        assert abs(gl.uniforms["yoffset"] - ((k + 1) % 8) / 8.0) < 1e-9
    uploads = [c for c in gl.calls if c[0] == "texSubImage2D"]
    assert len(uploads) - n_before == 3    # one row per frame
    assert gl.uniforms["u_min"] < gl.uniforms["u_max"]
    draws = [c for c in gl.calls if c[0] == "drawArrays"]
    assert len(draws) == 3


def test_jsmini_language_semantics():
    """The vendored interpreter's core semantics: closures, prototypes,
    switch fall-through, typed arrays, template literals, regex replace."""
    i = Interp()
    i.run("""
      function Counter(start) { this.n = start; }
      Counter.prototype.bump = function (k) { this.n += k; return this.n; };
      const c = new Counter(10);
      c.bump(5);
      const mk = (a) => (b) => a + b;
      const add3 = mk(3);
      let sw = '';
      switch ('B') { case 'A': case 'B': sw += 'ab'; case 'C': sw += 'c';
                     break; default: sw += 'd'; }
      const arr = new Float32Array(4); arr[2] = 7;
      const s = `n=${c.n} f=${(1.5).toFixed(2)}`;
      const trimmed = 'path///'.replace(/\\/+$/, '');
    """)
    assert i.eval("c.n") == 15.0
    assert i.eval("add3(4)") == 7.0
    assert i.eval("sw") == "abc"
    assert list(i.eval("arr")) == [0.0, 0.0, 7.0, 0.0]
    assert i.eval("s") == "n=15 f=1.50"
    assert i.eval("trimmed") == "path"
    assert i.eval("[3,1,2].sort((a,b)=>a-b).join('-')") == "1-2-3"
    assert i.eval("typeof missing") == "undefined"
    assert i.eval("(5 ?? 9)") == 5.0 and i.eval("(null ?? 9)") == 9.0
    # review-locked semantics: delete removes; try/finally re-raises;
    # function replacers run; parseInt takes the maximal numeric prefix
    i.run("const o2 = {a: 1}; delete o2.a;")
    assert i.eval("typeof o2.a") == "undefined"
    i.run("""
      let seen = 'no'; let fin = 0;
      try { try { throw 'E'; } finally { fin = 1; } }
      catch (e) { seen = e; }
    """)
    assert i.eval("seen") == "E" and i.eval("fin") == 1.0
    assert i.eval("'abc'.replace(/b/, m => m.toUpperCase())") == "aBc"
    assert i.eval("parseInt('42px', 10)") == 42.0
    assert i.eval("'a-b'.replace(/(\\w)-(\\w)/, '$2-$1')") == "b-a"


def _mkev(i, **kw):
    ev = JSObject()
    for k, v in kw.items():
        ev.set(k, float(v) if isinstance(v, (int, float)) else v)
    return ev


def test_exec_waterfall_zoom_pan_controls():
    """Frequency zoom (wheel around cursor), drag pan, double-click reset, dB
    mode and live range controls — the prophecy-parity interaction layer,
    executed on both the GL and 2D paths."""
    i = _interp()
    gl = _GLRec()
    cv = _canvas(128, 64)
    cv.getContext = lambda kind, *a: gl if kind == "webgl2" else None
    i.genv.vars["__cv"] = cv
    i.run("const wf = new FSDR.Waterfall(__cv, {history: 8, db: true});")
    wf = i.get("wf")
    assert wf.get("x0") == 0.0 and wf.get("x1") == 1.0
    # wheel-in at the 3/4 point: window shrinks, cursor fraction preserved
    i.call(cv._listeners["wheel"], UNDEF, _mkev(i, clientX=96, deltaY=-1))
    x0, x1 = wf.get("x0"), wf.get("x1")
    assert 0.0 < x0 < x1 < 1.0 and abs((x1 - x0) - 0.8) < 1e-6
    assert abs((0.75 - x0) / (x1 - x0) - 0.75) < 1e-6   # cursor-centred
    # drag pans left within bounds
    i.call(cv._listeners["mousedown"], UNDEF, _mkev(i, clientX=64))
    i.call(cv._listeners["mousemove"], UNDEF, _mkev(i, clientX=32))
    i.call(cv._listeners["mouseup"], UNDEF, _mkev(i))
    x0b = wf.get("x0")
    assert x0b > x0                                     # moved right (pan left)
    assert abs((wf.get("x1") - x0b) - (x1 - x0)) < 1e-9  # width preserved
    # frame uploads dB data and the window uniforms
    i.genv.vars["__d"] = [1.0, 10.0, 100.0, 1000.0] * 8
    i.run("wf.frame(__d);")
    up = [c for c in gl.calls if c[0] == "texSubImage2D"][-1]
    row = list(up[-1])
    assert abs(row[0] - 0.0) < 1e-6 and abs(row[3] - 30.0) < 1e-5  # 10log10
    assert abs(gl.uniforms["u_x0"] - x0b) < 1e-9
    # double-click resets the window
    i.call(cv._listeners["dblclick"], UNDEF, _mkev(i))
    assert wf.get("x0") == 0.0 and wf.get("x1") == 1.0

    # 2D path shares the contract: zoomed window remaps the painted indices
    cv2 = _canvas(64, 32)
    i.genv.vars["__cv2"] = cv2
    i.run("const w2 = new FSDR.Waterfall2D(__cv2, {autorange: false, "
          "min: 0, max: 63});")
    w2 = i.get("w2")
    i.genv.vars["__ramp"] = list(range(64))
    i.run("w2.x0 = 0.5; w2.x1 = 1.0; w2.frame(__ramp);")
    img = cv2.getContext("2d").last_image
    # left edge of the painted row now shows the MIDDLE of the spectrum
    t_left = img.data[0] / 255 / 2            # red = min(1, 2t) inverse for t<0.5
    assert abs(t_left - 32 / 63) < 0.05

    # live controls drive the running sink (prophecy Signal<f32> wiring)
    root = _El("div")
    i.genv.vars["__root"] = root
    i.run("const ctl = new FSDR.WaterfallControls(__root, w2);")
    min_inp = root.children[0].children[0]
    min_inp.value = "-40"
    i.call(min_inp.onchange, UNDEF)
    assert w2.get("min") == -40.0 and w2.get("autorange") is False
    auto_cb = root.children[2].children[0]
    auto_cb.checked = True
    i.call(auto_cb.onchange, UNDEF)
    assert w2.get("autorange") is True
    reset_btn = root.children[3]
    i.run("w2.x0 = 0.25; w2.x1 = 0.75;")
    i.call(reset_btn.onclick, UNDEF)
    assert w2.get("x0") == 0.0 and w2.get("x1") == 1.0


def test_exec_flowgraph_canvas_drag_blocks():
    """Blocks drag with the mouse and the position persists across update()
    (prophecy flowgraph_canvas on_mousedown parity)."""
    desc_py = {
        "id": 0,
        "blocks": [
            {"id": 0, "instance_name": "a", "stream_inputs": [],
             "stream_outputs": ["out"], "message_inputs": [], "blocking": False},
            {"id": 1, "instance_name": "b", "stream_inputs": ["in"],
             "stream_outputs": [], "message_inputs": [], "blocking": False},
        ],
        "stream_edges": [[0, "out", 1, "in"]],
        "message_edges": [],
    }
    i = _interp()
    cv = _canvas(300, 120)
    i.genv.vars["__cv"] = cv
    i.run("const fgc = new FSDR.FlowgraphCanvas(__cv, {});")
    i.run(f"fgc.update(JSON.parse({json_mod.dumps(json_mod.dumps(desc_py))}));")
    fgc = i.get("fgc")
    b0 = fgc.get("boxes")[0]
    ox, oy = b0.get("x"), b0.get("y")
    i.call(cv._listeners["mousedown"], UNDEF, _mkev(i, clientX=ox + 5,
                                                    clientY=oy + 5))
    i.call(cv._listeners["mousemove"], UNDEF, _mkev(i, clientX=ox + 45,
                                                    clientY=oy + 25))
    i.call(cv._listeners["mouseup"], UNDEF, _mkev(i))
    nb = fgc.get("boxes")[0]
    assert abs(nb.get("x") - (ox + 40)) < 1e-6
    assert abs(nb.get("y") - (oy + 20)) < 1e-6
    # the dragged position survives a fresh update()
    i.run(f"fgc.update(JSON.parse({json_mod.dumps(json_mod.dumps(desc_py))}));")
    nb2 = fgc.get("boxes")[0]
    assert abs(nb2.get("x") - (ox + 40)) < 1e-6


def test_exec_waterfall_fallback_is_the_renderer():
    """Without WebGL2, new FSDR.Waterfall() IS the 2D sink (constructor return)
    so zoom state + WaterfallControls operate on the rendering object."""
    i = _interp()
    cv = _canvas(64, 32)                  # getContext('webgl2') -> None
    i.genv.vars["__cv"] = cv
    i.run("const wf = new FSDR.Waterfall(__cv, {min: 1, max: 9});")
    assert i.eval("wf instanceof FSDR.Waterfall2D") is True
    root = _El("div")
    i.genv.vars["__root"] = root
    i.run("const c = new FSDR.WaterfallControls(__root, wf);")
    min_inp = root.children[0].children[0]
    min_inp.value = "3.5"
    i.call(min_inp.onchange, UNDEF)
    assert i.eval("wf.min") == 3.5        # the control reached the renderer
    min_inp.value = "garbage"
    i.call(min_inp.onchange, UNDEF)
    assert i.eval("wf.min") == 3.5        # NaN guard held
    # stuck-drag guard: after a block... (waterfall) pan drag ends on mouseup
    i.call(cv._listeners["mousedown"], UNDEF, _mkev(i, clientX=10))
    i.call(cv._listeners["mouseup"], UNDEF, _mkev(i))
    x0 = i.eval("wf.x0")
    i.call(cv._listeners["mousemove"], UNDEF, _mkev(i, clientX=50))
    assert i.eval("wf.x0") == x0          # no pan without a held button


def test_exec_waterfall2d_zoom_is_retroactive_and_disposable():
    """Zooming repaints the WHOLE 2D history in the new window (GL-path parity),
    and dispose() detaches the global mouseup listener."""
    i = _interp()
    cv = _canvas(32, 8)
    i.genv.vars["__cv"] = cv
    i.run("const wf = new FSDR.Waterfall2D(__cv, {autorange: false, "
          "min: 0, max: 31});")
    ramp = list(range(32))
    i.genv.vars["__r"] = ramp
    for _ in range(4):
        i.run("wf.frame(__r);")
    ctx = cv.getContext("2d")
    n_paints_before = len([o for o in ctx.ops if o[0] == "putImageData"])
    # zoom to the right half, then ONE frame must repaint history rows
    i.run("wf.x0 = 0.5; wf.x1 = 1.0; wf.frame(__r);")
    paints = [o for o in ctx.ops if o[0] == "putImageData"][n_paints_before:]
    assert len(paints) == 5                  # 5 stored rows, all repainted
    img = ctx.last_image
    t_left = img.data[0] / 255 / 2           # red channel inverse for t < 0.5
    assert abs(t_left - 16 / 31) < 0.06      # left edge shows mid-spectrum
    # steady-state zoomed frames go back to incremental painting
    i.run("wf.frame(__r);")
    paints2 = [o for o in ctx.ops if o[0] == "putImageData"][n_paints_before:]
    assert len(paints2) == 6                 # just one more row
    # dispose detaches the pan listener
    assert i.eval("typeof wf.dispose") == "function"
    i.run("wf.dispose();")
    assert "mouseup" not in cv._listeners
    # dB scratch is reused across frames (no per-frame allocation)
    i.run("const wd = new FSDR.Waterfall2D(__cv, {db: true});")
    i.run("wd.frame(__r); const b1 = wd._dbBuf; wd.frame(__r);")
    assert i.eval("b1 === wd._dbBuf") is True


def test_exec_metrics_table_busy_share_against_fused_chain():
    """FSDR.MetricsTable EXECUTES against a live control port serving a FUSED
    chain: the per-block rows render real counters, and the busy-share bars
    derive from the native driver's busy_ns — the FIR row must dominate its
    neighboring copy stage, matching what /metrics/ reports."""
    import json as json_mod
    import time
    import urllib.request

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Copy, Fir, Head, NullSink, NullSource
    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.dsp import firdes

    config().ctrlport_enable = True
    old_bind = config().ctrlport_bind
    config().ctrlport_bind = "127.0.0.1:0"
    running = None
    try:
        fg = Flowgraph()
        fg.connect(NullSource(np.float32), Head(np.float32, 600_000_000),
                   Fir(firdes.lowpass(0.2, 64).astype(np.float32)),
                   Copy(np.float32), NullSink(np.float32))
        rt = Runtime()
        running = rt.start(fg)
        base = rt.ctrl_port.url
        deadline = time.time() + 15
        while time.time() < deadline:
            try:
                urllib.request.urlopen(
                    base + "/api/fg/0/", timeout=2).read()
                break
            except Exception:
                time.sleep(0.1)
        else:
            raise RuntimeError("control port never became ready")
        time.sleep(0.3)                       # let busy_ns accumulate

        def fetch(url, opts=UNDEF):
            body = urllib.request.urlopen(url, timeout=5).read().decode()
            resp = JSObject()
            resp.set("json", lambda: i.eval(
                f"JSON.parse({json_mod.dumps(body)})"))
            return resp

        i = _interp(fetch=fetch)
        i.run(f"const h = new FSDR.Handle('{base}/');")
        tbl = _El("table")
        tbl.rows.append(_El("tr"))            # header row
        i.genv.vars["__tbl"] = tbl
        i.run("new FSDR.MetricsTable(__tbl).update(h.metrics(0));")
        assert len(tbl.rows) == 1 + 5         # one row per block
        shares = {}
        for r in tbl.rows[1:]:
            cells = [c for c in r.children]
            name = cells[0].textContent
            bar_cell = cells[4]
            if bar_cell.children:             # busy bar rendered
                width = bar_cell.children[0].style.get("width")
                shares[name] = int(str(width).rstrip("%"))
        assert shares, "no busy bars rendered"
        fir_share = next(v for k, v in shares.items() if "Fir" in k)
        copy_share = next(v for k, v in shares.items() if "Copy_" in k
                          or k.startswith("Copy"))
        assert fir_share > copy_share, shares
        assert fir_share > 30, shares         # the FIR owns the chain's time
    finally:
        if running is not None:
            running.stop_sync()
            rt.shutdown()
        config().ctrlport_enable = False
        config().ctrlport_bind = old_bind


def test_exec_doctor_panel_renders_flight_record_markdown():
    """FSDR.DoctorPanel against the REAL doctor endpoint
    (GET /api/fg/{fg}/doctor/?md=1): the fetched flight-record markdown
    renders into headings + preformatted body — the ROADMAP 'wire the doctor
    endpoint into the browser GUI' follow-up, executed."""
    import time
    import urllib.request

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import MessageSink, MessageSource
    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.types import Pmt as PyPmt

    config().ctrlport_enable = True
    old_bind = config().ctrlport_bind
    config().ctrlport_bind = "127.0.0.1:0"
    running = None
    try:
        fg = Flowgraph()
        src = MessageSource(PyPmt.string("x"), interval=0.05, count=400)
        snk = MessageSink()
        fg.connect_message(src, "out", snk, "in")
        rt = Runtime()
        running = rt.start(fg)
        base = rt.ctrl_port.url
        deadline = time.time() + 15
        while time.time() < deadline:
            try:
                urllib.request.urlopen(
                    base + "/api/fg/0/", timeout=2).read()
                break
            except Exception:
                time.sleep(0.1)
        else:
            raise RuntimeError("control port never became ready")

        fetched_urls = []

        def fetch(url, opts=UNDEF):
            fetched_urls.append(url)
            body = urllib.request.urlopen(url, timeout=5).read().decode()
            resp = JSObject()
            resp.set("text", lambda: body)
            resp.set("json", lambda: i.eval(
                f"JSON.parse({json_mod.dumps(body)})"))
            return resp

        i = _interp(fetch=fetch)
        root = _El("div")
        i.genv.vars["__root"] = root
        i.run(f"const h = new FSDR.Handle('{base}/');"
              "const dp = new FSDR.DoctorPanel(__root, h, 0);"
              "dp.refresh();")
        assert any(u.endswith("/api/fg/0/doctor/?md=1") for u in fetched_urls)
        # panel scaffold: refresh button + status + body
        assert root.children[0].tag == "button"
        body = root.children[2]
        tags = [c.tag for c in body.children]
        assert "h3" in tags and "pre" in tags, tags     # headings + body
        text = "".join(c.textContent for c in body.children)
        assert "flight record" in text.lower() or "doctor" in text.lower() \
            or "watchdog" in text.lower(), text[:200]
        # error path: unreachable endpoint reports, never throws (ValueError:
        # one of the Python exception kinds jsmini's try/catch translates)
        def bad_fetch(url, opts=UNDEF):
            raise ValueError("down")
        i2 = _interp(fetch=bad_fetch)
        root2 = _El("div")
        i2.genv.vars["__root"] = root2
        i2.run("const h = new FSDR.Handle('http://127.0.0.1:1/');"
               "const dp = new FSDR.DoctorPanel(__root, h, 0);"
               "dp.refresh();")
        assert "unavailable" in root2.children[1].textContent
    finally:
        if running is not None:
            running.stop_sync()
            rt.shutdown()
        config().ctrlport_enable = False
        config().ctrlport_bind = old_bind


# ---------------------------------------------------------------------------
# the GUI on the port's control port: tests/test_trace_gui.py's GUI cases,
# the files against the JAX package's, and the same GETs to both ports
# ---------------------------------------------------------------------------
import http.client  # noqa: E402
import socket  # noqa: E402
import urllib.request  # noqa: E402

from futuresdr_tpu_torch import Runtime  # noqa: E402
from futuresdr_tpu_torch.config import config as tconfig  # noqa: E402
from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort  # noqa: E402
from futuresdr_tpu_torch.runtime.runtime import RuntimeHandle  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
GUI_FILES = ("index.html", "widgets.js", "jsmini.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port: int, path: str) -> tuple:
    """``(status, content type, body)`` of a GET sent with ``path`` as is
    (no client-side normalisation of dots or escapes)."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


def test_gui_files_are_the_jax_packages():
    for name in GUI_FILES:
        assert (REPO / "futuresdr_tpu_torch/gui" / name).read_bytes() == \
            (REPO / "futuresdr_tpu/gui" / name).read_bytes(), name


def test_gui_served_from_ctrl_port():
    def my_route(request):
        return {"custom": True}

    from futuresdr_tpu_torch import AsyncScheduler
    cp = ControlPort(RuntimeHandle(AsyncScheduler()), bind="127.0.0.1:0",
                     extra_routes=[("GET", "/my/app/", my_route)])
    cp.start()
    try:
        html = urllib.request.urlopen(cp.url + "/").read().decode()
        assert "waterfall" in html
        ids = json_mod.load(urllib.request.urlopen(cp.url + "/api/fg/"))
        assert ids == []
        # custom-routes extension point (reference: examples/custom-routes)
        r = json_mod.load(urllib.request.urlopen(cp.url + "/my/app/"))
        assert r == {"custom": True}
    finally:
        cp.stop()


def test_gui_widgets_and_interactive_retune():
    """The GUI's widget library is served, and the slider/PmtEditor call path
    (a typed-Pmt POST to the call route) retunes the port's running FM app."""
    import time

    from futuresdr_tpu_torch.apps.fm_receiver import build_flowgraph

    fg, xlate, _ = build_flowgraph(input_rate=1_000_000.0, n_samples=2_000_000,
                                   use_tpu=False)
    rt = Runtime()
    running = rt.start(fg)
    cp = ControlPort(rt.handle, bind="127.0.0.1:0")
    cp.start()
    try:
        base = cp.url
        js = urllib.request.urlopen(base + "/static/widgets.js").read().decode()
        for widget in ("FlowgraphCanvas", "PmtEditor", "ConstellationSinkDensity",
                       "Slider", "RadioSelector", "ListSelector", "Waterfall",
                       "TimeSink", "ArrayView"):
            assert widget in js, f"widget {widget} missing from widgets.js"
        html = urllib.request.urlopen(base + "/").read().decode()
        assert "widgets.js" in html and "PmtEditor".lower() in html.lower()

        # the flowgraph description feeds the canvas: blocks + edges present
        desc = json_mod.load(urllib.request.urlopen(base + "/api/fg/0/"))
        assert desc["blocks"] and desc["stream_edges"]
        xlate_id = next(b["id"] for b in desc["blocks"]
                        if "XlatingFir" in b["instance_name"])
        assert "freq" in next(b for b in desc["blocks"]
                              if b["id"] == xlate_id)["message_inputs"]

        # what the Slider widget sends: POST {"F64": offset} to .../call/freq/
        before = xlate.rotator.phase_inc
        req = urllib.request.Request(
            f"{base}/api/fg/0/block/{xlate_id}/call/freq/",
            data=json_mod.dumps({"F64": 250_000.0}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        r = json_mod.load(urllib.request.urlopen(req))
        assert r == "Ok"
        for _ in range(100):
            if xlate.rotator.phase_inc != before:
                break
            time.sleep(0.02)
        assert xlate.rotator.phase_inc != before, "retune did not reach the block"
    finally:
        running.stop_sync()
        cp.stop()
        rt.shutdown()


GETS = ["/", "/static/widgets.js", "/static/index.html", "/static/./widgets.js",
        "/static/sub/../widgets.js", "/static/nope.js", "/static/..\\config.py",
        "/static/", "/static", "/index.html", "/static/../config.py",
        "/static/%2e%2e/config.py", "/static/%2E%2E/config.py", "/static/..%2fconfig.py",
        "/static/%2e%2e%2fconfig.py", "/static/%2e%2e/%2e%2e/etc/passwd",
        "/static//etc/passwd", "/static/%2fetc%2fpasswd", "/static/%00"]


@pytest.fixture(scope="module")
def both_ports():
    """The port's control port and the JAX package's, each serving its own
    ``gui/``; yields their ports."""
    from futuresdr_tpu import AsyncScheduler as JaxScheduler
    from futuresdr_tpu.runtime.ctrl_port import ControlPort as JaxControlPort
    from futuresdr_tpu.runtime.runtime import RuntimeHandle as JaxHandle
    from futuresdr_tpu_torch import AsyncScheduler
    t_cp = ControlPort(RuntimeHandle(AsyncScheduler()), bind="127.0.0.1:0")
    j_port = _free_port()
    j_cp = JaxControlPort(JaxHandle(JaxScheduler()), bind=f"127.0.0.1:{j_port}")
    t_cp.start()
    j_cp.start()
    try:
        yield t_cp.port, j_port
    finally:
        t_cp.stop()
        j_cp.stop()


@pytest.mark.parametrize("path", GETS)
def test_gui_gets_match_the_jax_control_port(both_ports, path):
    t_port, j_port = both_ports
    t, j = _get(t_port, path), _get(j_port, path)
    assert (t[0], t[2]) == (j[0], j[2]), (path, t[:2], j[:2])
    if t[0] == 200:
        assert t[1] == j[1]
    assert t[0] in (200, 403, 404)
    if "config" in path or "etc" in path:
        assert t[0] == 404 and b"import" not in t[2]   # nothing outside gui/


def test_frontend_path_serves_a_directory_of_its_own(tmp_path, monkeypatch):
    """Config ``frontend_path`` points both packages' control ports at one
    directory; a symbolic link in it that leads out is not followed."""
    from futuresdr_tpu import AsyncScheduler as JaxScheduler
    from futuresdr_tpu.config import config as jconfig
    from futuresdr_tpu.runtime.ctrl_port import ControlPort as JaxControlPort
    from futuresdr_tpu.runtime.runtime import RuntimeHandle as JaxHandle
    from futuresdr_tpu_torch import AsyncScheduler
    site = tmp_path / "site"
    (site / "css").mkdir(parents=True)
    (site / "index.html").write_text("<html>my own page</html>")
    (site / "css" / "app.css").write_text("body { color: red }")
    (site / "app.js").write_text("console.log(1);")
    (tmp_path / "secret.txt").write_text("outside")
    (site / "out.txt").symlink_to(tmp_path / "secret.txt")
    monkeypatch.setattr(tconfig(), "frontend_path", str(site))
    monkeypatch.setattr(jconfig(), "frontend_path", str(site))
    t_cp = ControlPort(RuntimeHandle(AsyncScheduler()), bind="127.0.0.1:0")
    j_port = _free_port()
    j_cp = JaxControlPort(JaxHandle(JaxScheduler()), bind=f"127.0.0.1:{j_port}")
    t_cp.start()
    j_cp.start()
    try:
        assert _get(t_cp.port, "/") == (200, "text/html", b"<html>my own page</html>")
        assert _get(t_cp.port, "/static/css/app.css")[:2] == (200, "text/css")
        assert _get(t_cp.port, "/static/widgets.js")[0] == 404
        for path in ("/", "/static/css/app.css", "/static/app.js", "/static/css",
                     "/static/out.txt", "/static/widgets.js", "/static/../secret.txt"):
            t, j = _get(t_cp.port, path), _get(j_port, path)
            assert (t[0], t[2]) == (j[0], j[2]), (path, t, j)
        assert _get(t_cp.port, "/static/out.txt")[0] == 404
    finally:
        t_cp.stop()
        j_cp.stop()
    monkeypatch.setattr(tconfig(), "frontend_path", str(tmp_path / "nothing"))
    with pytest.raises(ValueError, match="not a directory"):
        ControlPort(RuntimeHandle(AsyncScheduler()), bind="127.0.0.1:0")
