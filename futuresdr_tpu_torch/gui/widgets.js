/* futuresdr_tpu browser widget library.
 *
 * Role of the reference's `prophecy` leptos/WASM crate (crates/prophecy/src/lib.rs:9-52):
 * the same widget inventory — FlowgraphHandle + poll/call_periodically, FlowgraphCanvas
 * (blocks + stream/message edges), FlowgraphTable, PmtEditor/PmtInput, Slider,
 * RadioSelector, ListSelector, TimeSink, Waterfall, ConstellationSink,
 * ConstellationSinkDensity, ArrayView — as plain ES5-ish canvas/DOM code, no build step.
 * Widgets talk to the REST control plane (runtime/ctrl_port.py routes) and to
 * WebsocketSink binary float32 frames.
 */
'use strict';
const FSDR = {};

/* ---------------- handle: REST control plane ------------------------------ */
FSDR.Handle = function (base) { this.base = base.replace(/\/$/, ''); };
FSDR.Handle.prototype.flowgraphs = async function () {
  return (await fetch(this.base + '/api/fg/')).json();
};
FSDR.Handle.prototype.describe = async function (fg) {
  return (await fetch(this.base + '/api/fg/' + fg + '/')).json();
};
FSDR.Handle.prototype.metrics = async function (fg) {
  return (await fetch(this.base + '/api/fg/' + fg + '/metrics/')).json();
};
FSDR.Handle.prototype.doctor = async function (fg, md) {
  /* flight-recorder dump (runtime/ctrl_port.py GET /api/fg/{fg}/doctor/):
   * md=true fetches the rendered markdown, else the JSON record */
  const url = this.base + '/api/fg/' + fg + '/doctor/' + (md ? '?md=1' : '');
  const r = await fetch(url);
  /* fetch resolves on ANY completed HTTP exchange — a 404 (stale fg id) or
   * 500 must not render its error body as a flight record */
  if (r.ok === false) throw new Error('doctor endpoint HTTP ' + r.status);
  return md ? r.text() : r.json();
};
FSDR.Handle.prototype.call = async function (fg, blk, handler, pmt) {
  const r = await fetch(
    this.base + '/api/fg/' + fg + '/block/' + blk + '/call/' + handler + '/',
    {method: 'POST', headers: {'Content-Type': 'application/json'},
     body: JSON.stringify(pmt)});
  return r.json();
};
FSDR.pollPeriodically = function (fn, ms) {
  let live = true;
  (async function loop() {
    while (live) { try { await fn(); } catch (e) {} await new Promise(r => setTimeout(r, ms)); }
  })();
  return () => { live = false; };
};
FSDR.callPeriodically = function (handle, fg, blk, handler, pmt, ms) {
  return FSDR.pollPeriodically(() => handle.call(fg, blk, handler, pmt), ms);
};

/* ---------------- Pmt helpers (externally-tagged JSON, serde style) -------- */
FSDR.Pmt = {
  null_: () => 'Null',
  f64: v => ({F64: +v}), f32: v => ({F32: +v}),
  u32: v => ({U32: v >>> 0}),
  u64: v => ({U64: Math.round(Math.abs(+v))}),     // 53-bit safe (>>>0 truncates)
  usize: v => ({Usize: Math.round(Math.abs(+v))}),
  isize: v => ({Isize: Math.round(+v)}),
  bool_: v => ({Bool: !!v}), string: v => ({String: '' + v}),
  parse(kind, text) {
    switch (kind) {
      case 'Null': return 'Null';
      case 'Bool': return {Bool: text === 'true' || text === '1'};
      case 'String': return {String: text};
      case 'F32': case 'F64': return {[kind]: parseFloat(text)};
      case 'U32': case 'U64': case 'Usize': case 'Isize':
        return {[kind]: parseInt(text, 10)};
      default: return JSON.parse(text);     // raw JSON escape hatch (maps, vecs)
    }
  },
};

/* ---------------- FlowgraphCanvas: graph with edges ------------------------ */
/* Blocks laid out by topological rank over the stream edges; stream edges solid,
 * message edges dashed. Click a block to select it (fires opts.onSelect(block)). */
FSDR.FlowgraphCanvas = function (canvas, opts) {
  this.cv = canvas; this.ctx = canvas.getContext('2d');
  this.opts = opts || {}; this.desc = null; this.boxes = [];
  this.selected = null;
  this.custom = {};                      // user-dragged positions, by block id
  canvas.addEventListener('click', (ev) => {
    if (this._suppressClick) { this._suppressClick = false; return; }
    const r = canvas.getBoundingClientRect();
    const x = ev.clientX - r.left, y = ev.clientY - r.top;
    for (const b of this.boxes) {
      if (x >= b.x && x <= b.x + b.w && y >= b.y && y <= b.y + b.h) {
        this.selected = b.blk.id;
        if (this.opts.onSelect) this.opts.onSelect(b.blk);
        this.draw();
        return;
      }
    }
  });
  /* draggable blocks (prophecy flowgraph_canvas.rs:597 on_mousedown): dragged
   * positions persist across update() via this.custom; a drag that moved
   * beyond the click threshold suppresses the synthesized click so moving a
   * block never rewrites the selection/editor panel */
  let drag = null;
  canvas.addEventListener('mousedown', (ev) => {
    const r = canvas.getBoundingClientRect();
    const x = ev.clientX - r.left, y = ev.clientY - r.top;
    for (const b of this.boxes) {
      if (x >= b.x && x <= b.x + b.w && y >= b.y && y <= b.y + b.h) {
        drag = {b, dx: x - b.x, dy: y - b.y, moved: 0, px: x, py: y};
        return;
      }
    }
  });
  canvas.addEventListener('mousemove', (ev) => {
    if (!drag) return;
    const r = canvas.getBoundingClientRect();
    const x = ev.clientX - r.left, y = ev.clientY - r.top;
    const b = drag.b;
    drag.moved += Math.abs(x - drag.px) + Math.abs(y - drag.py);
    drag.px = x; drag.py = y;
    b.x = Math.min(Math.max(x - drag.dx, 0), this.cv.width - b.w);
    b.y = Math.min(Math.max(y - drag.dy, 0), this.cv.height - b.h);
    this.custom[b.blk.id] = {x: b.x, y: b.y};
    this.draw();
  });
  this.dispose = FSDR.onGlobalMouseUp(canvas, () => {
    this._suppressClick = !!(drag && drag.moved > 3);
    drag = null;
  });
};
FSDR.FlowgraphCanvas.prototype.update = function (desc) {
  this.desc = desc; this.layout(); this.draw();
};
FSDR.FlowgraphCanvas.prototype.layout = function () {
  const blocks = this.desc.blocks, edges = this.desc.stream_edges || [];
  const rank = {};                       // topological rank along stream edges
  blocks.forEach(b => rank[b.id] = 0);
  for (let pass = 0; pass < blocks.length; pass++) {
    let moved = false;
    for (const [s, , d] of edges.map(e => [e[0], e[1], e[2]])) {
      if (rank[d] < rank[s] + 1) { rank[d] = rank[s] + 1; moved = true; }
    }
    if (!moved) break;
  }
  const cols = {};
  blocks.forEach(b => { (cols[rank[b.id]] = cols[rank[b.id]] || []).push(b); });
  const W = this.cv.width, H = this.cv.height;
  const ncol = Math.max(...Object.keys(cols).map(Number)) + 1;
  const cw = W / ncol;
  this.boxes = [];
  for (const [c, bs] of Object.entries(cols)) {
    const rh = H / bs.length;
    bs.forEach((b, i) => {
      const w = Math.min(cw - 24, 150), h = Math.min(rh - 14, 44);
      const cust = this.custom[b.id];
      this.boxes.push({blk: b,
                       x: cust ? cust.x : c * cw + (cw - w) / 2,
                       y: cust ? cust.y : i * rh + (rh - h) / 2, w, h});
    });
  }
};
FSDR.FlowgraphCanvas.prototype.draw = function () {
  const ctx = this.ctx, cv = this.cv;
  ctx.fillStyle = '#101418'; ctx.fillRect(0, 0, cv.width, cv.height);
  const at = {};
  this.boxes.forEach(b => at[b.blk.id] = b);
  const edge = (s, d, dashed) => {
    const a = at[s], b = at[d];
    if (!a || !b) return;
    ctx.beginPath();
    ctx.setLineDash(dashed ? [5, 4] : []);
    ctx.strokeStyle = dashed ? '#ffb74d' : '#4fc3f7';
    const x0 = a.x + a.w, y0 = a.y + a.h / 2, x1 = b.x, y1 = b.y + b.h / 2;
    ctx.moveTo(x0, y0);
    ctx.bezierCurveTo(x0 + 28, y0, x1 - 28, y1, x1, y1);
    ctx.stroke();
    ctx.setLineDash([]);
    ctx.beginPath();                      // arrow head
    ctx.moveTo(x1, y1); ctx.lineTo(x1 - 7, y1 - 4); ctx.lineTo(x1 - 7, y1 + 4);
    ctx.fillStyle = ctx.strokeStyle; ctx.fill();
  };
  for (const e of this.desc.stream_edges || []) edge(e[0], e[2], false);
  for (const e of this.desc.message_edges || []) edge(e[0], e[2], true);
  for (const b of this.boxes) {
    ctx.fillStyle = b.blk.id === this.selected ? '#263b4a' : '#1c252b';
    ctx.strokeStyle = b.blk.id === this.selected ? '#4fc3f7' : '#37474f';
    ctx.fillRect(b.x, b.y, b.w, b.h); ctx.strokeRect(b.x, b.y, b.w, b.h);
    ctx.fillStyle = '#cfd8dc'; ctx.font = '11px system-ui';
    ctx.fillText(b.blk.instance_name, b.x + 6, b.y + 17, b.w - 12);
    ctx.fillStyle = '#78909c';
    ctx.fillText('#' + b.blk.id + (b.blk.message_inputs.length ?
      '  msg: ' + b.blk.message_inputs.join(',') : ''), b.x + 6, b.y + 32, b.w - 12);
  }
};

/* ---------------- FlowgraphTable ------------------------------------------- */
FSDR.FlowgraphTable = function (tbl) { this.tbl = tbl; };
FSDR.FlowgraphTable.prototype.update = function (desc) {
  const tbl = this.tbl;
  while (tbl.rows.length > 1) tbl.deleteRow(1);
  for (const b of desc.blocks) {
    const r = tbl.insertRow();
    for (const v of [b.id, b.instance_name, b.stream_inputs.join(','),
                     b.stream_outputs.join(','), b.message_inputs.join(',')])
      r.insertCell().textContent = v;
  }
};

/* ---------------- MetricsTable: live per-block counters -------------------- */
/* One row per block from /api/fg/N/metrics/: work calls, summed per-port
 * in/out items, and — for natively fused members — the driver's busy_ns
 * attribution rendered as a busy-share bar across the fused chain (where a
 * pipe spends its thread; the 64-tap FIR visibly dominating its copies).
 * Poll with FSDR.pollPeriodically(() => handle.metrics(0).then(m =>
 * table.update(m)), 500). */
FSDR.MetricsTable = function (tbl) { this.tbl = tbl; };
FSDR.MetricsTable.prototype.update = function (metrics) {
  const tbl = this.tbl;
  while (tbl.rows.length > 1) tbl.deleteRow(1);
  const sum = (obj) => {
    let s = 0;
    for (const k of Object.keys(obj)) s += obj[k];
    return s;
  };
  let totalBusy = 0;
  for (const name of Object.keys(metrics)) totalBusy += metrics[name].busy_ns || 0;
  for (const name of Object.keys(metrics)) {
    const m = metrics[name];
    const r = tbl.insertRow();
    r.insertCell().textContent = name;
    r.insertCell().textContent = m.work_calls;
    r.insertCell().textContent = sum(m.items_in || {});
    r.insertCell().textContent = sum(m.items_out || {});
    const c = r.insertCell();
    if (m.busy_ns !== undefined && totalBusy > 0) {
      const share = (m.busy_ns || 0) / totalBusy;
      const bar = document.createElement('div');
      bar.className = 'busybar';
      bar.style.width = Math.round(share * 100) + '%';
      const label = document.createElement('span');
      label.textContent = ' ' + Math.round(share * 100) + '% (' +
                          ((m.busy_ns || 0) / 1e6).toFixed(1) + ' ms)';
      c.appendChild(bar);
      c.appendChild(label);
    } else {
      c.textContent = m.fused_native ? '' : '—';
    }
  }
};

/* ---------------- DoctorPanel: flight-record markdown tab ------------------ */
/* Fetches GET /api/fg/{fg}/doctor/?md=1 (telemetry/doctor.py render_markdown:
 * watchdog verdict, per-block metrics + live port state, bottleneck lanes,
 * e2e latency percentiles, thread stacks) on demand and renders the markdown
 * with a minimal line renderer — headings and fenced code blocks styled, the
 * rest preformatted (stack frames and metric tables stay aligned). */
FSDR.DoctorPanel = function (root, handle, fgId) {
  this.root = root; this.handle = handle; this.fgId = fgId;
  const btn = document.createElement('button');
  btn.textContent = 'refresh';
  btn.onclick = () => this.refresh();
  this.status = document.createElement('span');
  this.status.className = 'doctor-status';
  this.body = document.createElement('div');
  this.body.className = 'doctor-body';
  root.appendChild(btn);
  root.appendChild(this.status);
  root.appendChild(this.body);
};
FSDR.DoctorPanel.prototype.refresh = async function () {
  try {
    const md = await this.handle.doctor(this.fgId, true);
    this.render(md);
    this.status.textContent = '';
  } catch (e) {
    this.status.textContent = ' doctor endpoint unavailable';
  }
};
FSDR.DoctorPanel.prototype.render = function (md) {
  const body = this.body;
  body.innerHTML = '';
  let pre = null, fence = false;
  const flush = () => { pre = null; };
  for (const line of ('' + md).split('\n')) {
    if (line.slice(0, 3) === '```') { fence = !fence; flush(); continue; }
    if (!fence && line.slice(0, 2) === '# ') {
      flush();
      const h = document.createElement('h3');
      h.textContent = line.slice(2);
      body.appendChild(h);
    } else if (!fence && line.slice(0, 3) === '## ') {
      flush();
      const h = document.createElement('h4');
      h.textContent = line.slice(3);
      body.appendChild(h);
    } else {
      if (!pre) {
        pre = document.createElement('pre');
        body.appendChild(pre);
      }
      pre.textContent += line + '\n';
    }
  }
};

/* ---------------- PmtEditor: typed Pmt forms → POST call ------------------- */
/* One row per message handler of the selected block: kind selector + value input +
 * send; the reply renders next to the row (`prophecy/src/pmt.rs` PmtEditor role). */
FSDR.PmtEditor = function (root, handle, fgId) {
  this.root = root; this.handle = handle; this.fgId = fgId;
};
FSDR.PmtEditor.prototype.show = function (blk) {
  const root = this.root;
  root.innerHTML = '';
  const title = document.createElement('h3');
  title.textContent = blk.instance_name + ' — message handlers';
  root.appendChild(title);
  if (!blk.message_inputs.length) {
    root.appendChild(document.createTextNode('(no message handlers)'));
    return;
  }
  const kinds = ['F64', 'F32', 'U32', 'U64', 'Usize', 'Isize', 'Bool', 'String',
                 'Null', 'JSON'];
  for (const h of blk.message_inputs) {
    const row = document.createElement('div');
    row.className = 'pmt-row';
    const name = document.createElement('code');
    name.textContent = h;
    const sel = document.createElement('select');
    kinds.forEach(k => { const o = document.createElement('option');
                         o.textContent = k; sel.appendChild(o); });
    const val = document.createElement('input');
    val.size = 14;
    const btn = document.createElement('button');
    btn.textContent = 'call';
    const out = document.createElement('span');
    out.className = 'pmt-reply';
    btn.onclick = async () => {
      try {
        const pmt = FSDR.Pmt.parse(sel.value, val.value);
        const reply = await this.handle.call(this.fgId, blk.id, h, pmt);
        out.textContent = ' → ' + JSON.stringify(reply);
      } catch (e) { out.textContent = ' → error: ' + e; }
    };
    [name, sel, val, btn, out].forEach(el => row.appendChild(el));
    root.appendChild(row);
  }
};

/* ---------------- parameter widgets: Slider / RadioSelector / ListSelector - */
FSDR.Slider = function (root, handle, fgId, blkId, handler, opts) {
  opts = opts || {};
  const wrap = document.createElement('label');
  wrap.className = 'fsdr-slider';
  wrap.textContent = opts.label || handler;
  const inp = document.createElement('input');
  inp.type = 'range';
  inp.min = opts.min ?? 0; inp.max = opts.max ?? 100; inp.step = opts.step ?? 1;
  inp.value = opts.value ?? inp.min;
  const val = document.createElement('span');
  val.textContent = inp.value;
  inp.oninput = () => { val.textContent = inp.value; };
  inp.onchange = () => handle.call(fgId, blkId, handler, FSDR.Pmt.f64(inp.value));
  wrap.appendChild(inp); wrap.appendChild(val);
  root.appendChild(wrap);
  return inp;
};
FSDR.RadioSelector = function (root, handle, fgId, blkId, handler, options) {
  const wrap = document.createElement('span');
  for (const o of options) {                  // [{label, pmt}]
    const lab = document.createElement('label');
    const rb = document.createElement('input');
    rb.type = 'radio'; rb.name = 'rs-' + blkId + '-' + handler;
    rb.onchange = () => handle.call(fgId, blkId, handler, o.pmt);
    lab.appendChild(rb); lab.appendChild(document.createTextNode(o.label));
    wrap.appendChild(lab);
  }
  root.appendChild(wrap);
};
FSDR.ListSelector = function (root, handle, fgId, blkId, handler, options) {
  const sel = document.createElement('select');
  for (const o of options) {
    const opt = document.createElement('option');
    opt.textContent = o.label; sel.appendChild(opt);
  }
  sel.onchange = () => handle.call(fgId, blkId, handler, options[sel.selectedIndex].pmt);
  root.appendChild(sel);
  return sel;
};

/* ---------------- interaction: frequency zoom / pan / range controls ------- */
/* Prophecy counterpart: the leptos waterfall takes reactive min/max Signals and
 * re-uploads them per frame (crates/prophecy/src/waterfall.rs:40-162); its
 * flowgraph canvas drags blocks with on:mousedown (flowgraph_canvas.rs:597).
 * Same capabilities here: wheel zooms the frequency axis around the cursor,
 * drag pans, double-click resets; WaterfallControls wires live min/max/auto/dB
 * inputs to a running sink. */
/* Register a mouseup listener on window (browser) or the canvas (headless
 * stubs); returns an unsubscribe so widgets are disposable — window-level
 * listeners otherwise pin discarded widgets for the page lifetime. */
FSDR.onGlobalMouseUp = function (canvas, fn) {
  const t = (typeof window !== 'undefined' && window
             && window.addEventListener) ? window : canvas;
  t.addEventListener('mouseup', fn);
  return () => { if (t.removeEventListener) t.removeEventListener('mouseup', fn); };
};
FSDR.attachZoom = function (wf, canvas) {
  canvas.addEventListener('wheel', (ev) => {
    const r = canvas.getBoundingClientRect();
    const denom = (r.width || canvas.width || 1);
    const f = Math.min(Math.max((ev.clientX - r.left) / denom, 0), 1);
    const c = wf.x0 + f * (wf.x1 - wf.x0);
    const scale = ev.deltaY > 0 ? 1.25 : 0.8;
    let w = (wf.x1 - wf.x0) * scale;
    w = Math.min(1, Math.max(1 / 64, w));
    wf.x0 = Math.min(Math.max(c - f * w, 0), 1 - w);
    wf.x1 = wf.x0 + w;
    if (ev.preventDefault) ev.preventDefault();
  });
  let drag = null;
  canvas.addEventListener('mousedown', (ev) => {
    drag = {x: ev.clientX, x0: wf.x0, x1: wf.x1};
  });
  canvas.addEventListener('mousemove', (ev) => {
    if (!drag) return;
    const r = canvas.getBoundingClientRect();
    const w = drag.x1 - drag.x0;
    const dx = (ev.clientX - drag.x) / (r.width || canvas.width || 1) * w;
    wf.x0 = Math.min(Math.max(drag.x0 - dx, 0), 1 - w);
    wf.x1 = wf.x0 + w;
  });
  // releasing OUTSIDE the canvas must still end the pan
  wf.dispose = FSDR.onGlobalMouseUp(canvas, () => { drag = null; });
  canvas.addEventListener('dblclick', () => { wf.x0 = 0; wf.x1 = 1; });
};
FSDR.toDb = function (data, scratchOwner) {
  // per-sink scratch: a fresh Float32Array per frame would churn the GC on
  // full-rate feeds (same rule as the density sink's offscreen surfaces)
  let out = scratchOwner && scratchOwner._dbBuf;
  if (!out || out.length !== data.length) {
    out = new Float32Array(data.length);
    if (scratchOwner) scratchOwner._dbBuf = out;
  }
  for (let i = 0; i < data.length; i++)
    out[i] = 10 * Math.log10(Math.max(data[i], 1e-12));
  return out;
};
/* Live display controls for a running Waterfall/Waterfall2D — the reactive
 * min/max wiring of the prophecy waterfall as plain DOM inputs. */
FSDR.WaterfallControls = function (root, wf) {
  const mk = (label, value, onchange) => {
    const lab = document.createElement('label');
    lab.textContent = label;
    const inp = document.createElement('input');
    inp.size = 6; inp.value = value;
    inp.onchange = () => onchange(inp);
    lab.appendChild(inp); root.appendChild(lab);
    return inp;
  };
  const setRange = (field) => (i) => {
    const v = parseFloat(i.value);
    if (!Number.isFinite(v)) return;     // don't poison the render range
    wf[field] = v;
    wf.autorange = false;
    this.autoInp.checked = false;
  };
  this.minInp = mk('min', wf.min, setRange('min'));
  this.maxInp = mk('max', wf.max, setRange('max'));
  const lab = document.createElement('label');
  lab.textContent = 'auto';
  const cb = document.createElement('input');
  cb.type = 'checkbox'; cb.checked = !!wf.autorange;
  cb.onchange = () => { wf.autorange = !!cb.checked; };
  lab.appendChild(cb); root.appendChild(lab);
  this.autoInp = cb;
  const btn = document.createElement('button');
  btn.textContent = 'reset zoom';
  btn.onclick = () => { wf.x0 = 0; wf.x1 = 1; };
  root.appendChild(btn);
};

/* ---------------- WebGL2 plumbing ------------------------------------------ */
/* Shared helpers for the GPU sinks (the prophecy crate renders its Waterfall and
 * ConstellationSinkDensity with WebGL2 shaders, crates/prophecy/src/waterfall.rs /
 * constellation_sink_density.rs — same capability here, independent design:
 * scalar fields live in R32F textures, color is applied by sampling a 256x1
 * colormap LUT texture in the fragment shader, so colormaps are swappable
 * without touching GLSL). */
FSDR.GL = {};
FSDR.GL.context = function (canvas) {
  try {
    return canvas.getContext('webgl2', {antialias: false, depth: false,
                                        premultipliedAlpha: false});
  } catch (e) { return null; }
};
FSDR.GL.program = function (gl, vertSrc, fragSrc) {
  const mk = (type, src) => {
    const sh = gl.createShader(type);
    gl.shaderSource(sh, src); gl.compileShader(sh);
    if (!gl.getShaderParameter(sh, gl.COMPILE_STATUS))
      throw new Error('shader: ' + gl.getShaderInfoLog(sh));
    return sh;
  };
  const prog = gl.createProgram();
  gl.attachShader(prog, mk(gl.VERTEX_SHADER, vertSrc));
  gl.attachShader(prog, mk(gl.FRAGMENT_SHADER, fragSrc));
  gl.linkProgram(prog);
  if (!gl.getProgramParameter(prog, gl.LINK_STATUS))
    throw new Error('link: ' + gl.getProgramInfoLog(prog));
  return prog;
};
FSDR.GL.quad = function (gl, prog, attrib) {
  const buf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  gl.bufferData(gl.ARRAY_BUFFER,
                new Float32Array([-1, -1, 1, -1, -1, 1, 1, 1]), gl.STATIC_DRAW);
  const loc = gl.getAttribLocation(prog, attrib);
  gl.enableVertexAttribArray(loc);
  gl.vertexAttribPointer(loc, 2, gl.FLOAT, false, 0, 0);
};
FSDR.GL.fieldTexture = function (gl, unit, w, h) {
  const tex = gl.createTexture();
  gl.activeTexture(gl.TEXTURE0 + unit);
  gl.bindTexture(gl.TEXTURE_2D, tex);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_S, gl.CLAMP_TO_EDGE);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_T, gl.REPEAT);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.NEAREST);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.NEAREST);
  gl.pixelStorei(gl.UNPACK_ALIGNMENT, 1);
  gl.texImage2D(gl.TEXTURE_2D, 0, gl.R32F, w, h, 0, gl.RED, gl.FLOAT,
                new Float32Array(w * h));
  return tex;
};
/* Default colormap: a perceptually-ordered dark-violet -> teal -> yellow ramp
 * built procedurally (piecewise-linear through anchor colors, then gamma-eased),
 * uploaded as a 256x1 RGBA LUT. opts.colormap may replace it with any
 * [[r,g,b],...] 0..255 anchor list. */
FSDR.GL.lutTexture = function (gl, unit, anchors) {
  anchors = anchors || [[13, 8, 65], [84, 39, 143], [35, 110, 145],
                        [28, 170, 128], [122, 209, 81], [253, 231, 37]];
  const n = 256, data = new Uint8Array(4 * n);
  for (let i = 0; i < n; i++) {
    const t = i / (n - 1), f = t * (anchors.length - 1);
    const a = Math.min(Math.floor(f), anchors.length - 2), u = f - a;
    for (let c = 0; c < 3; c++)
      data[4 * i + c] = Math.round(anchors[a][c] * (1 - u) + anchors[a + 1][c] * u);
    data[4 * i + 3] = 255;
  }
  const tex = gl.createTexture();
  gl.activeTexture(gl.TEXTURE0 + unit);
  gl.bindTexture(gl.TEXTURE_2D, tex);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_S, gl.CLAMP_TO_EDGE);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_T, gl.CLAMP_TO_EDGE);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.LINEAR);
  gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA, n, 1, 0, gl.RGBA, gl.UNSIGNED_BYTE, data);
  return tex;
};
FSDR.GL.VERT = [
  '#version 300 es',
  'in vec2 pos;',
  'out vec2 uv;',
  'void main() { uv = pos * 0.5 + 0.5; gl_Position = vec4(pos, 0.0, 1.0); }',
].join('\n');

/* ---------------- stream sinks -------------------------------------------- */
/* Waterfall: scrolling spectrogram. WebGL2 path keeps the full history in an
 * R32F ring texture (one texSubImage2D row upload per frame; the scroll is a
 * yoffset uniform + REPEAT wrap — zero row copies, sustains 2048-bin full-rate
 * feeds). Falls back to the canvas-2D implementation where WebGL2 is missing. */
FSDR.WATERFALL_FRAG = [
  '#version 300 es',
  /* highp: the ring lookup needs 1/history (1/1024) y-resolution, below the
   * fp16 precision step on mobile GPUs where mediump is 16-bit */
  'precision highp float;',
  'in vec2 uv;',
  'uniform sampler2D field;',
  'uniform sampler2D lut;',
  'uniform float u_min;',
  'uniform float u_max;',
  'uniform float yoffset;',
  'uniform float u_x0;',
  'uniform float u_x1;',
  'out vec4 rgba;',
  'void main() {',
  '  float fx = u_x0 + uv.x * (u_x1 - u_x0);',
  '  float v = texture(field, vec2(fx, uv.y + yoffset)).r;',
  '  float t = clamp((v - u_min) / (u_max - u_min), 0.0, 1.0);',
  '  rgba = vec4(texture(lut, vec2(t, 0.5)).rgb, 1.0);',
  '}',
].join('\n');
FSDR.Waterfall = function (canvas, opts) {
  opts = opts || {};
  this.cv = canvas;
  this.history = opts.history || 1024;
  this.autorange = opts.autorange !== false;
  this.min = opts.min ?? 0; this.max = opts.max ?? 1;
  this.db = !!opts.db;                   // display 10·log10(v) like prophecy
  this.x0 = 0; this.x1 = 1;              // frequency zoom window (fractions)
  const gl = FSDR.GL.context(canvas);
  if (!gl || !gl.texImage2D) {
    // no WebGL2: construct AS the canvas-2D sink (constructor return value)
    // so zoom state and WaterfallControls operate on the object that renders
    return new FSDR.Waterfall2D(canvas, opts);
  }
  this.gl = gl; this.bins = 0; this.row = 0;
  this.prog = FSDR.GL.program(gl, FSDR.GL.VERT, FSDR.WATERFALL_FRAG);
  gl.useProgram(this.prog);
  FSDR.GL.quad(gl, this.prog, 'pos');
  this.lut = FSDR.GL.lutTexture(gl, 1, opts.colormap);
  gl.uniform1i(gl.getUniformLocation(this.prog, 'field'), 0);
  gl.uniform1i(gl.getUniformLocation(this.prog, 'lut'), 1);
  this.uMin = gl.getUniformLocation(this.prog, 'u_min');
  this.uMax = gl.getUniformLocation(this.prog, 'u_max');
  this.uOff = gl.getUniformLocation(this.prog, 'yoffset');
  this.uX0 = gl.getUniformLocation(this.prog, 'u_x0');
  this.uX1 = gl.getUniformLocation(this.prog, 'u_x1');
  FSDR.attachZoom(this, canvas);
};
FSDR.Waterfall.prototype.frame = function (data) {
  if (this.db) data = FSDR.toDb(data, this);
  const gl = this.gl;
  if (this.bins !== data.length) {       // (re)size the ring to the feed
    this.bins = data.length; this.row = 0;
    if (this.tex) gl.deleteTexture(this.tex);   // don't leak the old ring
    this.tex = FSDR.GL.fieldTexture(gl, 0, this.bins, this.history);
  }
  if (this.autorange) {                  // smoothed auto-range (decays ~1s)
    let lo = Infinity, hi = -Infinity;
    for (const v of data) { if (v < lo) lo = v; if (v > hi) hi = v; }
    this.min = this.min * 0.97 + lo * 0.03;
    this.max = this.max * 0.97 + (hi + 1e-9) * 0.03;
  }
  gl.activeTexture(gl.TEXTURE0);
  gl.texSubImage2D(gl.TEXTURE_2D, 0, 0, this.row, this.bins, 1, gl.RED, gl.FLOAT,
                   data instanceof Float32Array ? data : new Float32Array(data));
  this.row = (this.row + 1) % this.history;
  gl.viewport(0, 0, this.cv.width, this.cv.height);
  gl.uniform1f(this.uMin, this.min);
  gl.uniform1f(this.uMax, this.max);
  gl.uniform1f(this.uOff, this.row / this.history);
  gl.uniform1f(this.uX0, this.x0);
  gl.uniform1f(this.uX1, this.x1);
  gl.drawArrays(gl.TRIANGLE_STRIP, 0, 4);
};
/* canvas-2D waterfall (fallback + headless CI) — honors the same
 * min/max/autorange contract as the GL path so a calibrated display renders
 * identically with or without a GPU */
FSDR.Waterfall2D = function (canvas, opts) {
  opts = opts || {};
  this.cv = canvas; this.ctx = canvas.getContext('2d');
  this.autorange = opts.autorange !== false;
  this.min = opts.min ?? 0; this.max = opts.max ?? 1;
  this.db = !!opts.db;
  this.x0 = 0; this.x1 = 1;
  // raw row history (canvas-height rows): zoom/pan repaints RETROACTIVELY so
  // the whole spectrogram shows one frequency window, matching the GL path
  // (which remaps the full ring texture per draw)
  this.rows = []; this._paintedX = [0, 1];
  FSDR.attachZoom(this, canvas);
};
FSDR.Waterfall2D.prototype._paintRow = function (data, y, lo, span) {
  const cv = this.cv, ctx = this.ctx;
  const img = ctx.createImageData(cv.width, 1);
  for (let x = 0; x < cv.width; x++) {
    const fx = this.x0 + (x / cv.width) * (this.x1 - this.x0);
    const i = Math.min(Math.floor(fx * data.length), data.length - 1);
    const t = (data[i] - lo) / span;
    img.data[4 * x] = 255 * Math.min(1, 2 * t);
    img.data[4 * x + 1] = 255 * Math.max(0, 2 * t - 1);
    img.data[4 * x + 2] = 96 * (1 - t);
    img.data[4 * x + 3] = 255;
  }
  ctx.putImageData(img, 0, y);
};
FSDR.Waterfall2D.prototype.frame = function (data) {
  const cv = this.cv, ctx = this.ctx;
  if (this.db) data = FSDR.toDb(data, this);
  this.rows.push(data instanceof Float32Array ? data.slice() :
                 Float32Array.from(data));
  if (this.rows.length > cv.height) this.rows.shift();
  let lo = this.min, hi = this.max;
  if (this.autorange) {
    lo = Infinity; hi = -Infinity;
    for (const v of data) { if (v < lo) lo = v; if (v > hi) hi = v; }
    this.min = this.min * 0.97 + lo * 0.03;
    this.max = this.max * 0.97 + hi * 0.03;
    lo = this.min; hi = this.max;
  }
  const span = Math.max(hi - lo, 1e-9);
  const zoomed = this._paintedX[0] !== this.x0 || this._paintedX[1] !== this.x1;
  if (zoomed) {
    // window changed: repaint the WHOLE history in the new mapping
    this._paintedX = [this.x0, this.x1];
    for (let k = 0; k < this.rows.length; k++)
      this._paintRow(this.rows[k], cv.height - this.rows.length + k, lo, span);
    return;
  }
  ctx.drawImage(cv, 0, -1);
  this._paintRow(data, cv.height - 1, lo, span);
};
FSDR.TimeSink = function (canvas, mode) {     // mode: 'line' | 'dots'
  this.cv = canvas; this.ctx = canvas.getContext('2d'); this.mode = mode || 'line';
};
FSDR.TimeSink.prototype.frame = function (data) {
  const cv = this.cv, ctx = this.ctx;
  ctx.fillStyle = '#101418'; ctx.fillRect(0, 0, cv.width, cv.height);
  let lo = Infinity, hi = -Infinity;
  for (const v of data) { if (v < lo) lo = v; if (v > hi) hi = v; }
  const span = Math.max(hi - lo, 1e-9);
  ctx.strokeStyle = ctx.fillStyle = '#4fc3f7';
  ctx.beginPath();
  for (let x = 0; x < cv.width; x++) {
    const i = Math.floor(x * data.length / cv.width);
    const y = cv.height - 4 - (data[i] - lo) / span * (cv.height - 8);
    if (this.mode === 'dots') ctx.fillRect(x, y, 2, 2);
    else if (x === 0) ctx.moveTo(x, y); else ctx.lineTo(x, y);
  }
  if (this.mode !== 'dots') ctx.stroke();
};
FSDR.ConstellationSink = function (canvas) {
  this.cv = canvas; this.ctx = canvas.getContext('2d');
};
FSDR.ConstellationSink.prototype.frame = function (iq) {
  const cv = this.cv, ctx = this.ctx;
  ctx.fillStyle = 'rgba(16,20,24,0.35)';
  ctx.fillRect(0, 0, cv.width, cv.height);
  ctx.fillStyle = '#80deea';
  let peak = 1e-9;
  for (let i = 0; i < iq.length; i++) peak = Math.max(peak, Math.abs(iq[i]));
  const s = cv.width / (2.2 * peak);
  for (let i = 0; i + 1 < iq.length; i += 2)
    ctx.fillRect(cv.width / 2 + iq[i] * s, cv.height / 2 - iq[i + 1] * s, 2, 2);
};
/* Density mode: 2D histogram with exponential decay, rendered by the GPU
 * (`constellation_sink_density.rs` role): the histogram lives in an R32F
 * texture, the fragment shader normalizes by the peak, sqrt-eases for
 * perceptual density, and samples the colormap LUT. Canvas-2D fallback kept
 * for WebGL2-less environments. */
FSDR.DENSITY_FRAG = [
  '#version 300 es',
  'precision highp float;',
  'in vec2 uv;',
  'uniform sampler2D field;',
  'uniform sampler2D lut;',
  'uniform float u_peak;',
  'out vec4 rgba;',
  'void main() {',
  '  float h = texture(field, uv).r;',
  '  float t = sqrt(clamp(h / u_peak, 0.0, 1.0));',
  '  rgba = vec4(texture(lut, vec2(t, 0.5)).rgb, 1.0);',
  '}',
].join('\n');
FSDR.ConstellationSinkDensity = function (canvas, opts) {
  opts = opts || {};
  this.cv = canvas;
  const gl = FSDR.GL.context(canvas);
  if (!gl || !gl.texImage2D) {           // construct AS the 2D sink (see Waterfall)
    return new FSDR.ConstellationSinkDensity2D(canvas, opts);
  }
  this.n = opts.bins || 128;
  this.decay = opts.decay ?? 0.9;
  this.hist = new Float32Array(this.n * this.n);
  this.gl = gl;
  this.prog = FSDR.GL.program(gl, FSDR.GL.VERT, FSDR.DENSITY_FRAG);
  gl.useProgram(this.prog);
  FSDR.GL.quad(gl, this.prog, 'pos');
  this.tex = FSDR.GL.fieldTexture(gl, 0, this.n, this.n);
  this.lut = FSDR.GL.lutTexture(gl, 1, opts.colormap);
  gl.uniform1i(gl.getUniformLocation(this.prog, 'field'), 0);
  gl.uniform1i(gl.getUniformLocation(this.prog, 'lut'), 1);
  this.uPeak = gl.getUniformLocation(this.prog, 'u_peak');
};
FSDR.ConstellationSinkDensity.prototype.accumulate = function (iq) {
  const n = this.n, h = this.hist;
  for (let i = 0; i < h.length; i++) h[i] *= this.decay;
  let peak = 1e-9;
  for (let i = 0; i < iq.length; i++) peak = Math.max(peak, Math.abs(iq[i]));
  const s = n / (2.2 * peak);
  for (let i = 0; i + 1 < iq.length; i += 2) {
    const x = Math.round(n / 2 + iq[i] * s), y = Math.round(n / 2 - iq[i + 1] * s);
    if (x >= 0 && x < n && y >= 0 && y < n) h[y * n + x] += 1;
  }
  let hi = 1e-9;
  for (let i = 0; i < h.length; i++) if (h[i] > hi) hi = h[i];
  return hi;
};
FSDR.ConstellationSinkDensity.prototype.frame = function (iq) {
  const gl = this.gl, peak = this.accumulate(iq);
  gl.activeTexture(gl.TEXTURE0);
  gl.texSubImage2D(gl.TEXTURE_2D, 0, 0, 0, this.n, this.n, gl.RED, gl.FLOAT,
                   this.hist);
  gl.viewport(0, 0, this.cv.width, this.cv.height);
  gl.uniform1f(this.uPeak, peak);
  gl.drawArrays(gl.TRIANGLE_STRIP, 0, 4);
};
/* canvas-2D density (fallback + headless CI) */
FSDR.ConstellationSinkDensity2D = function (canvas, opts) {
  opts = opts || {};
  this.cv = canvas; this.ctx = canvas.getContext('2d');
  this.n = opts.bins || 128;
  this.decay = opts.decay ?? 0.9;
  this.hist = new Float32Array(this.n * this.n);
  // scratch surfaces allocated once (a per-frame canvas would churn the GC)
  if (typeof OffscreenCanvas !== 'undefined') {
    this.off = new OffscreenCanvas(this.n, this.n);
  } else {
    this.off = document.createElement('canvas');
    this.off.width = this.n; this.off.height = this.n;
  }
  this.offCtx = this.off.getContext('2d');
  this.img = this.offCtx.createImageData(this.n, this.n);
};
FSDR.ConstellationSinkDensity2D.prototype.accumulate =
  FSDR.ConstellationSinkDensity.prototype.accumulate;
FSDR.ConstellationSinkDensity2D.prototype.frame = function (iq) {
  const n = this.n, h = this.hist, hi = this.accumulate(iq);
  const img = this.img;
  for (let i = 0; i < h.length; i++) {
    const t = Math.pow(h[i] / hi, 0.5);         // sqrt for perceptual density
    img.data[4 * i] = 255 * Math.min(1, 1.6 * t);
    img.data[4 * i + 1] = 255 * Math.max(0, 1.8 * t - 0.55);
    img.data[4 * i + 2] = 80 + 175 * Math.max(0, 3 * t - 2);
    img.data[4 * i + 3] = 255;
  }
  this.offCtx.putImageData(img, 0, 0);
  this.ctx.imageSmoothingEnabled = false;
  this.ctx.drawImage(this.off, 0, 0, this.cv.width, this.cv.height);
};
FSDR.ArrayView = function (root, n) { this.root = root; this.n = n || 8; };
FSDR.ArrayView.prototype.frame = function (data) {
  let lo = Infinity, hi = -Infinity, sum = 0;
  for (const v of data) { if (v < lo) lo = v; if (v > hi) hi = v; sum += v; }
  const head = Array.from(data.slice(0, this.n)).map(v => v.toFixed(3)).join(', ');
  this.root.textContent =
    `len=${data.length} min=${lo.toFixed(3)} max=${hi.toFixed(3)} ` +
    `mean=${(sum / data.length).toFixed(3)}  [${head}, …]`;
};

/* eslint-disable-next-line no-unused-vars */
if (typeof module !== 'undefined') module.exports = FSDR;   // node tests
