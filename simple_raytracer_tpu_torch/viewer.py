"""Interactive progressive viewer: a local web client over the engine.

The port's copy of ``simple_raytracer_tpu.viewer``, over the port's
``Renderer`` on the card.  The reference is an interactive SDL2/ImGui app
(src/main.cpp): a fly camera (WASD/Space/C and mouse-look,
main.cpp:161-240), mouse-wheel fov zoom (183-193), progressive
accumulation that restarts on any movement or edit (time_not_moved,
270-348), a 'p' screenshot key (319-322), frame-time readouts
(interface.cpp:486-532), the ImGui editor windows (interface.cpp:106-480)
and tiny-gizmo translate/rotate/scale of the selected shape
(interface.cpp:13-104).

The engine is headless, so the window becomes a browser page served by a
stdlib HTTP server on localhost.  The client is not on the device path:
it posts input state and editor commands and pulls tonemapped PNG frames,
as SDL pulled the readback buffer.  The editor's verbs live in
``editor.SceneEditor``, the handles in ``gizmo.py``; this module adds the
render loop, the HTTP surface (``/``, ``/frame.png``, ``/state``,
``/scene``, ``/input``, ``/edit``, ``/pick``) and the page.  Every edit
resets accumulation and sends the scene to the device again; a transform
edit refits the BVH, and a full build follows once the drag settles.

Run:  python -m simple_raytracer_tpu_torch.viewer --config 2 --port 8008

The viewer renders on the card (``--device cuda``, the default); without
CUDA it exits non-zero unless it is given ``--device cpu``, which renders
with the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from math import cos, degrees, radians, sin, tan

from .editor import EditError, SceneEditor
from .engine import Renderer, RenderOptions
from .models.camera import Camera
from .utils.metrics import FrameTimer

PROG = "srt-viewer-torch"

_PAGE = """<!doctype html>
<html><head><title>simple_raytracer_tpu_torch</title><style>
 body { margin:0; background:#111; color:#ccc; font:12px monospace;
        display:flex; flex-direction:row; height:100vh; overflow:hidden }
 #main { flex:1; display:flex; flex-direction:column; align-items:center;
         overflow:auto }
 #hud { padding:6px; color:#9ab }
 img  { image-rendering:pixelated; margin-top:4px; outline:1px solid #333;
        cursor:crosshair }
 #panel { width:330px; background:#191c1f; overflow-y:auto; padding:8px;
          border-left:1px solid #333 }
 h3 { margin:10px 0 4px; color:#8cf; font-size:12px; border-bottom:1px
      solid #333 }
 .row { display:flex; align-items:center; gap:4px; margin:2px 0 }
 .row.sel { background:#2a3540 }
 button { background:#2a2e33; color:#ccc; border:1px solid #444;
          font:11px monospace; cursor:pointer; padding:1px 6px }
 button:hover { background:#3a4450 }
 input, select { background:#23262a; color:#ddd; border:1px solid #444;
                 font:11px monospace; width:52px }
 input[type=text] { width:90px }
 input[type=range] { width:70px }
 input[type=color] { width:28px; padding:0; height:16px }
 label { color:#889; min-width:78px; display:inline-block }
 #error { color:#f77; min-height:14px }
 .matbox { border:1px solid #2a2e33; margin:3px 0; padding:3px }
</style></head><body>
<div id=main>
 <div id=hud>click image: select shape &middot; dblclick: capture mouse
  (WASD/Space/C fly &middot; wheel zoom) &middot; drag selected:
  <span id=modehud>move</span> (G move / R rotate / E scale;
  X/Y/Z or click a handle: axis lock)
  &middot; arrows/PgUp/PgDn nudge &middot; drag a material onto a shape to
  assign &middot; drag shape rows to reorder &middot; P screenshot &middot;
  <span id=stats></span></div>
 <div id=viewwrap style="position:relative">
  <img id=view width=%(w)s height=%(h)s>
  <svg id=gizmo width=%(w)s height=%(h)s
       style="position:absolute;left:0;top:4px;pointer-events:none"></svg>
 </div>
 <div id=error></div>
</div>
<div id=panel>
 <h3>Shapes</h3>
 <div class=row>
  <button onclick="edit({op:'add_sphere',position:[0,0,-3]})">+sphere</button>
  <button onclick="edit({op:'add_plane',position:[0,-1,0]})">+plane</button>
  <button onclick="edit({op:'add_box',position:[0,0,-3]})">+box</button>
 </div>
 <div class=row><input type=text id=importpath placeholder="model.stl/.obj">
  <button onclick="edit({op:'import_model',path:val('importpath')})">import
  </button></div>
 <div id=shapes></div>
 <h3>Selected</h3>
 <div id=selected>nothing selected</div>
 <h3>Materials</h3>
 <div id=materials></div>
 <div class=row><button onclick="edit({op:'add_material'})">+material
 </button></div>
 <h3>Scene lighting</h3>
 <div id=sky></div>
 <h3>Render</h3>
 <div id=render></div>
 <h3>Frame time</h3>
 <svg id=framehist width=230 height=48
      style="background:#14141c;display:block"></svg>
 <div id=framestats style="color:#776"></div>
 <h3>Camera</h3>
 <div id=camera></div>
</div>
<script>
const keys = {}; let dx = 0, dy = 0, wheel = 0;
let S = null;                 // /scene state
let sel = null;               // {kind, index}
let dragging = false, lastDrag = null;
let dragMode = 'translate';   // gizmo mode: translate | rotate | scale
let dragAxis = null;          // null (free) | 'x' | 'y' | 'z'
function setMode(m) {
  dragMode = m;
  updateModeHud();
  renderSelected();
}
function updateModeHud() {
  document.getElementById('modehud').textContent =
    {translate:'move', rotate:'rotate', scale:'scale'}[dragMode] +
    (dragAxis ? ' [' + dragAxis.toUpperCase() + ']' : '');
}
const img = document.getElementById('view');
const W = %(w)s, H = %(h)s;

function val(id) { return document.getElementById(id).value; }
function err(m) { document.getElementById('error').textContent = m || ''; }

async function edit(cmd) {
  // ship the current selection: the SERVER repairs it against
  // structural index shifts (delete/reorder/duplicate —
  // editor.repair_selection, unit-tested Python) and the response
  // carries the result; the client just adopts it
  const r = await fetch('/edit', {method:'POST',
    body:JSON.stringify({...cmd, sel})});
  const j = await r.json();
  if (j.ok && 'sel' in j) sel = j.sel;
  err(j.ok ? '' : j.error);
  await refresh();
  return j;
}

async function refresh() {
  S = await (await fetch('/scene')).json();
  renderShapes(); renderSelected(); renderMaterials(); renderSky();
  renderRender(); renderCamera(); renderGizmo();
}

function shapeName(s) {
  const n = {sphere:'Sphere', plane:'Plane', model:'Model'}[s.kind];
  return `${n} ${s.index}` + (s.triangles ? ` (${s.triangles} tris)` : '');
}

function renderShapes() {
  const div = document.getElementById('shapes');
  div.innerHTML = '';
  for (const s of S.shapes) {
    const row = document.createElement('div');
    row.className = 'row' + (sel && sel.kind === s.kind &&
                             sel.index === s.index ? ' sel' : '');
    const name = document.createElement('span');
    name.textContent = shapeName(s);
    name.style.flex = '1'; name.style.cursor = 'pointer';
    name.onclick = () => { sel = {kind:s.kind, index:s.index};
                           renderShapes(); renderSelected(); };
    const mat = document.createElement('select');
    for (const m of S.materials) {
      const o = document.createElement('option');
      o.value = m.index; o.textContent = m.name;
      if (m.index === s.material) o.selected = true;
      mat.appendChild(o);
    }
    mat.onchange = () => edit({op:'set_shape_material', kind:s.kind,
                               index:s.index, material:+mat.value});
    const dup = document.createElement('button');
    dup.textContent = 'dup';
    dup.onclick = () => edit({op:'duplicate_shape', kind:s.kind,
                              index:s.index});
    const del = document.createElement('button');
    del.textContent = 'x';
    // the delete's selection shift comes back repaired from the server
    del.onclick = () => edit({op:'remove_shape', kind:s.kind,
                              index:s.index});
    // drag source for list reorder (interface.cpp:203-216)
    row.draggable = true;
    row.ondragstart = ev => ev.dataTransfer.setData(
      'text/plain', JSON.stringify({shape:{kind:s.kind, index:s.index}}));
    // drop target for material drag-assign (interface.cpp:231-247) and
    // for shape-row reorder
    row.ondragover = ev => ev.preventDefault();
    row.ondrop = async ev => {
      ev.preventDefault();
      const data = ev.dataTransfer.getData('text/plain');
      let src = null;
      try { src = JSON.parse(data).shape; } catch (e) {}
      if (src && src.kind === s.kind) {
        // A move shifts the index of EVERY same-kind shape between the
        // source and destination rows, not just the dragged one — the
        // server repairs whichever selection the shift touched (via
        // edit()'s sel round trip) so later gizmo drags / nudges /
        // material drops keep editing the same shape.
        await edit({op:'reorder_shape', kind:src.kind,
                    index:src.index, to:s.index});
        return;
      }
      const mi = parseInt(data);
      if (!isNaN(mi)) edit({op:'set_shape_material', kind:s.kind,
                            index:s.index, material:mi});
    };
    row.append(name, mat, dup, del);
    div.appendChild(row);
  }
}

function vecRow(label, v, oncommit, step=0.1) {
  const row = document.createElement('div'); row.className = 'row';
  const l = document.createElement('label'); l.textContent = label;
  row.appendChild(l);
  const inputs = v.map((x, i) => {
    const inp = document.createElement('input');
    inp.type = 'number'; inp.step = step; inp.value = (+x).toFixed(3);
    inp.onchange = () => oncommit(inputs.map(e => +e.value));
    row.appendChild(inp);
    return inp;
  });
  return row;
}

function numRow(label, x, oncommit, step=0.05) {
  const row = document.createElement('div'); row.className = 'row';
  const l = document.createElement('label'); l.textContent = label;
  const inp = document.createElement('input');
  inp.type = 'number'; inp.step = step; inp.value = (+x).toFixed(3);
  inp.onchange = () => oncommit(+inp.value);
  row.append(l, inp);
  return row;
}

function findSel() {
  if (!sel) return null;
  return S.shapes.find(s => s.kind === sel.kind && s.index === sel.index)
         || null;
}

function renderSelected() {
  const div = document.getElementById('selected');
  div.innerHTML = '';
  const s = findSel();
  if (!s) { div.textContent = 'nothing selected'; return; }
  div.appendChild(Object.assign(document.createElement('div'),
                                {textContent: shapeName(s)}));
  const modes = document.createElement('div'); modes.className = 'row';
  for (const [m, lbl] of [['translate','move'], ['rotate','rotate'],
                          ['scale','scale']]) {
    const b = document.createElement('button');
    b.textContent = lbl;
    if (m === dragMode) b.style.background = '#3a5570';
    b.onclick = () => setMode(m);
    modes.appendChild(b);
  }
  div.appendChild(modes);
  const set = f => edit(Object.assign({op:'set_shape', kind:s.kind,
                                       index:s.index}, f));
  if (s.kind === 'sphere') {
    div.appendChild(vecRow('position', s.position,
                           v => set({position:v})));
    div.appendChild(numRow('radius', s.radius, v => set({radius:v})));
  } else if (s.kind === 'plane') {
    div.appendChild(vecRow('position', s.position,
                           v => set({position:v})));
    div.appendChild(vecRow('normal', s.normal, v => set({normal:v})));
  } else {
    div.appendChild(vecRow('translation', s.translation,
                           v => set({translation:v})));
    div.appendChild(vecRow('rotation', s.rotation,
                           v => set({rotation:v}), 0.05));
    div.appendChild(vecRow('scale', s.scale, v => set({scale:v}), 0.05));
  }
}

function matColorRow(m, field) {
  const row = document.createElement('div'); row.className = 'row';
  const l = document.createElement('label'); l.textContent = field;
  const c = document.createElement('input'); c.type = 'color';
  const hex = v => ('0' + Math.round(Math.min(1, Math.max(0, v)) * 255)
                    .toString(16)).slice(-2);
  c.value = '#' + m[field].map(hex).join('');
  c.onchange = () => {
    const v = [1, 3, 5].map(i => parseInt(c.value.slice(i, i + 2), 16) / 255);
    edit({op:'update_material', index:m.index, fields:{[field]:v}});
  };
  row.append(l, c);
  return row;
}

function renderMaterials() {
  const div = document.getElementById('materials');
  div.innerHTML = '';
  for (const m of S.materials) {
    const box = document.createElement('div'); box.className = 'matbox';
    const head = document.createElement('div'); head.className = 'row';
    // drag source lives on a GRIP, not the whole box: a draggable
    // ancestor hijacks press-and-drag text selection in the rename
    // input on Firefox/WebKit.  Drop onto a shape row to assign
    // (interface.cpp:425-433).
    const grip = document.createElement('span');
    grip.textContent = '≡';
    grip.title = 'drag onto a shape to assign';
    grip.style.cursor = 'grab';
    grip.draggable = true;
    grip.ondragstart = ev =>
      ev.dataTransfer.setData('text/plain', String(m.index));
    const name = document.createElement('input');
    name.type = 'text'; name.value = m.name;
    name.onchange = () => edit({op:'rename_material', index:m.index,
                                name:name.value});
    const del = document.createElement('button'); del.textContent = 'x';
    del.onclick = () => edit({op:'remove_material', index:m.index});
    head.append(grip, name, del);
    box.appendChild(head);
    box.appendChild(matColorRow(m, 'color'));
    for (const f of ['smoothness', 'metallic', 'specular', 'transmittance'])
      box.appendChild(numRow(f, m[f], v => edit(
        {op:'update_material', index:m.index, fields:{[f]:v}})));
    if (m.transmittance > 0)   // conditional IOR (interface.cpp:461-470)
      box.appendChild(numRow('refraction', m.refraction_index, v => edit(
        {op:'update_material', index:m.index,
         fields:{refraction_index:v}})));
    box.appendChild(matColorRow(m, 'emission'));
    box.appendChild(numRow('emit strength', m.emission_strength, v => edit(
      {op:'update_material', index:m.index,
       fields:{emission_strength:v}}), 0.5));
    div.appendChild(box);
  }
}

function renderSky() {
  const div = document.getElementById('sky');
  div.innerHTML = '';
  const set = (f, v) => edit({op:'set_sky', fields:{[f]:v}});
  div.appendChild(numRow('sun focus', S.sky.sun_focus,
                         v => set('sun_focus', v), 1));
  div.appendChild(numRow('sun intensity', S.sky.sun_intensity,
                         v => set('sun_intensity', v)));
  div.appendChild(vecRow('sun direction', S.sky.sun_direction,
                         v => set('sun_direction', v)));
  for (const f of ['sun_color', 'horizon_color', 'zenith_color',
                   'ground_color'])
    div.appendChild(vecRow(f.replace('_', ' '), S.sky[f],
                           v => set(f, v), 0.05));
}

function renderRender() {
  const div = document.getElementById('render');
  div.innerHTML = '';
  div.appendChild(numRow('samples', S.render.samples, v => edit(
    {op:'set_render', samples:Math.max(1, Math.round(v))}), 1));
  div.appendChild(numRow('bounces', S.render.bounces, v => edit(
    {op:'set_render', bounces:Math.max(1, Math.round(v))}), 1));
  const row = document.createElement('div'); row.className = 'row';
  const cb = document.createElement('input');
  cb.type = 'checkbox'; cb.checked = S.render.show_normals;
  cb.style.width = '16px';
  cb.onchange = () => edit({op:'set_render', show_normals:cb.checked});
  const l = document.createElement('label');
  l.textContent = 'show normals';
  const rr = document.createElement('button');
  rr.textContent = 'Re-render';
  rr.onclick = () => edit({op:'rerender'});
  row.append(cb, l, rr);
  div.appendChild(row);
  const note = document.createElement('div');
  note.style.color = '#776';
  note.textContent = 'samples/bounces changes recompile the step';
  div.appendChild(note);
}

function renderCamera() {
  const div = document.getElementById('camera');
  div.innerHTML = '';
  div.appendChild(vecRow('position', S.camera.position,
                         v => edit({op:'set_camera', position:v})));
  div.appendChild(numRow('yaw', S.camera.yaw,
                         v => edit({op:'set_camera', yaw:v})));
  div.appendChild(numRow('pitch', S.camera.pitch,
                         v => edit({op:'set_camera', pitch:v})));
  div.appendChild(numRow('fov', S.camera.fov,
                         v => edit({op:'set_camera', fov:v}), 1));
  const row = document.createElement('div'); row.className = 'row';
  const shot = document.createElement('button');
  shot.textContent = 'Screenshot (PPM)';
  shot.onclick = () => edit({op:'screenshot'});
  row.appendChild(shot);
  div.appendChild(row);
}

// -- selection picking + drag manipulation (the gizmo analog) ------------
// Depth-correct 3-D handles: the SERVER generates world-space handle
// geometry (arrows / rings per mode, gizmo.py — tiny-gizmo lathes the
// same sets, tiny-gizmo.cpp:309-327), hit-tests mouse rays against it
// with exact occlusion, and ships projected per-vertex polylines +
// occlusion masks in every /input response; the client only draws.
const AXIS_COLOR = {x:'#e55', y:'#5d5', z:'#59f'};
let gizmoData = null;     // last /input response's "gizmo" overlay

function gizmoSel() {
  return sel ? {kind: sel.kind, index: sel.index, mode: dragMode} : null;
}

function renderGizmo() {
  const svg = document.getElementById('gizmo');
  if (!gizmoData || !sel) { svg.innerHTML = ''; return; }
  let h = '';
  for (const ax of ['x','y','z']) {
    const a = gizmoData[ax];
    if (!a) continue;
    const wdt = dragAxis === ax ? 3.5 : 2;
    // consecutive visible vertices form segments; spans the scene
    // occludes draw dimmed (hidden-line style), like tiny-gizmo's
    // depth-tested handle rendering
    let lastPt = null;
    for (let i = 0; i < a.pts.length; i++) {
      const p = a.pts[i];
      if (p && lastPt) {
        const dim = a.occ[i] || a.occ[i-1];
        h += `<line x1=${lastPt[0]} y1=${lastPt[1]} x2=${p[0]} ` +
             `y2=${p[1]} stroke="${AXIS_COLOR[ax]}" ` +
             `stroke-width=${dim ? 1 : wdt} ` +
             `stroke-opacity=${dim ? 0.3 : 1} ` +
             (dim ? 'stroke-dasharray="3 3" ' : '') + '/>';
      }
      lastPt = p;
    }
    const lbl = a.pts[a.pts.length - 1] || a.pts[0];
    if (lbl) h += `<text x=${lbl[0]+3} y=${lbl[1]-3} ` +
                  `fill="${AXIS_COLOR[ax]}" font-size=11>${ax}</text>`;
  }
  svg.innerHTML = h;
}

img.ondblclick = () => img.requestPointerLock();
let pressActive = false;   // physical button state: the /pick await can
                           // outlive a fast click's mouseup
let dragMoved = false;     // a drag happened: refresh panels on release
img.onmousedown = async e => {
  if (document.pointerLockElement === img) return;
  pressActive = true;
  const r = img.getBoundingClientRect();
  const x = (e.clientX - r.left) * W / r.width;
  const y = (e.clientY - r.top) * H / r.height;
  // ONE round trip resolves both the handle and the shape: the server
  // raycasts the 3-D handle geometry first (visible-handle-wins hit
  // priority with real occlusion, tiny-gizmo.cpp:115-134), so a
  // grabbed handle starts an axis-constrained drag of the selection
  const hit = await (await fetch('/pick', {method:'POST',
    body:JSON.stringify({x, y, gizmo: gizmoSel()})})).json();
  if (hit.gizmo_axis && sel && pressActive) {
    dragAxis = hit.gizmo_axis; dragging = true;
    lastDrag = [e.clientX, e.clientY];
    updateModeHud(); renderGizmo();
    return;
  }
  const same = hit.shape && sel && hit.shape.kind === sel.kind &&
               hit.shape.index === sel.index;
  if (hit.shape) sel = hit.shape;
  renderShapes(); renderSelected(); renderGizmo();
  // only engage the drag if the button is STILL down — a fast click's
  // mouseup can fire during the /pick round trip, and engaging after
  // it would leave a sticky drag with no button held
  if (same && pressActive) { dragging = true;
                             lastDrag = [e.clientX, e.clientY]; }
};
document.onmouseup = () => {
  pressActive = false;
  dragging = false;
  if (dragMoved) {
    dragMoved = false;
    refresh();   // re-sync S/panels/handles with the dragged transform
  }
};
document.onmousemove = e => {
  if (document.pointerLockElement === img) {
    dx += e.movementX; dy += e.movementY;
  } else if (dragging && sel) {
    const [lx, ly] = lastDrag; lastDrag = [e.clientX, e.clientY];
    const body = {op:'drag_shape', kind:sel.kind, index:sel.index,
                  mode:dragMode,
                  dx:(e.clientX - lx) / img.getBoundingClientRect().width,
                  dy:(e.clientY - ly) / img.getBoundingClientRect().height};
    if (dragAxis) body.axis = dragAxis;
    dragMoved = true;
    // raw fetch (no per-mousemove refresh), but honor the error-line
    // contract: e.g. scale-dragging a plane raises a real EditError
    fetch('/edit', {method:'POST', body:JSON.stringify(body)})
      .then(r => r.json()).then(j => { if (!j.ok) err(j.error); })
      .catch(() => {});
  }
};

document.onkeydown = e => {
  // form fields keep their own keyboard: arrows must navigate a material
  // <select>, not nudge the selected shape
  if (['INPUT', 'SELECT', 'TEXTAREA'].includes(e.target.tagName)) return;
  const k = e.key.toLowerCase();
  if (k === 'g') setMode('translate');
  else if (k === 'r') setMode('rotate');
  else if (k === 'e') setMode('scale');
  // Blender-style axis constraint: x/y/z toggles the world-axis lock
  // for drags (same key again releases it)
  else if (sel && ['x','y','z'].includes(k) &&
           document.pointerLockElement !== img) {
    dragAxis = dragAxis === k ? null : k;
    updateModeHud(); renderGizmo();
  }
  keys[e.key.toLowerCase()] = true;
  if (sel && ['arrowleft','arrowright','arrowup','arrowdown','pageup',
              'pagedown'].includes(e.key.toLowerCase())) {
    const step = e.shiftKey ? 0.02 : 0.2;
    const d = {arrowleft:[-step,0,0], arrowright:[step,0,0],
               arrowup:[0,step,0], arrowdown:[0,-step,0],
               pageup:[0,0,-step], pagedown:[0,0,step]}[e.key.toLowerCase()];
    edit({op:'translate_shape', kind:sel.kind, index:sel.index, delta:d});
    e.preventDefault();
  }
};
document.onkeyup = e => { keys[e.key.toLowerCase()] = false; };
// a key held across focus loss never gets its keyup: clear everything,
// or the camera keeps flying while the tab is backgrounded
window.onblur = () => { for (const k in keys) keys[k] = false; };
document.onvisibilitychange = () => {
  if (document.hidden) for (const k in keys) keys[k] = false;
};
// wheel zoom only over the IMAGE: scrolling the side panel must scroll
// the panel, not drift the camera fov (main.cpp:183 gates on
// accepting_input the same way)
img.onwheel = e => { wheel += Math.sign(e.deltaY); e.preventDefault(); };

// frame-time history sparkline: the PlotLines window of the reference
// (interface.cpp:486-510) — server sends the last ~120 step times (ms),
// the polyline scales to their min..max like ImGui's autoscale
function renderFrameHist(hist, avgMs) {
  if (!hist || hist.length < 2) return;
  const svg = document.getElementById('framehist');
  const w = svg.width.baseVal.value, h = svg.height.baseVal.value;
  const lo = Math.min(...hist), hi = Math.max(...hist);
  const span = (hi - lo) || 1;
  const pts = hist.map((v, i) =>
    `${(i / (hist.length - 1) * w).toFixed(1)},` +
    `${(h - 3 - (v - lo) / span * (h - 6)).toFixed(1)}`).join(' ');
  svg.innerHTML = `<polyline points="${pts}" fill="none" ` +
                  `stroke="#8ac" stroke-width="1"/>`;
  document.getElementById('framestats').textContent =
    `min ${lo.toFixed(1)}  avg ${avgMs.toFixed(1)}  ` +
    `max ${hi.toFixed(1)} ms (${hist.length} steps)`;
}

let last = performance.now();
let lastCamJson = '';
let serverErrShown = false;
async function tick() {
  const now = performance.now(); const dt = (now - last) / 1000; last = now;
  const body = {keys: Object.keys(keys).filter(k => keys[k]),
                dx, dy, wheel, dt, gizmo: gizmoSel()};
  dx = 0; dy = 0; wheel = 0;
  try {
    const r = await fetch('/input', {method:'POST',
                                     body: JSON.stringify(body)});
    const s = await r.json();
    document.getElementById('stats').textContent =
      `steps ${s.steps}  ${s.ms.toFixed(1)} ms/step  ${s.fps.toFixed(1)} fps`;
    renderFrameHist(s.hist, s.ms);
    img.src = '/frame.png?t=' + s.frame;
    if (S && s.camera) {
      S.camera = s.camera;
      // keep the Camera panel's inputs in sync with flying, or a later
      // single-field edit commits the stale siblings and teleports the
      // camera; skip while the user is typing in that panel
      const cj = JSON.stringify(s.camera);
      if (cj !== lastCamJson && !document.getElementById('camera')
            .contains(document.activeElement)) {
        lastCamJson = cj;
        renderCamera();
      }
    }
    gizmoData = s.gizmo || null;
    renderGizmo();   // track camera motion
    // show live server errors; CLEAR the line when the server recovers
    // (a later successful compile resets loop.error) — but never clobber
    // a client-side message from edit() that the server never saw
    if (s.error) { err(s.error); serverErrShown = true; }
    else if (serverErrShown) { err(''); serverErrShown = false; }
  } catch (e) {}
  setTimeout(tick, 33);
}
refresh().then(tick);
</script></body></html>"""


class RenderLoop:
    """Background progressive render loop with the reference's
    movement/edit-resets-accumulation contract."""

    def __init__(self, renderer: Renderer, camera: Camera,
                 movement_speed: float = 15.0, look_speed: float = 25.0,
                 fps_limit: float = 60.0, screenshot_path: str = "out.ppm",
                 scene=None):
        self.renderer = renderer
        self.camera = camera
        self.scene = scene
        self.editor = (SceneEditor(scene, on_change=self._scene_changed)
                       if scene is not None else None)
        self.movement_speed = movement_speed
        self.look_speed = look_speed
        self.fps_limit = fps_limit  # 60 like the reference (main.cpp:153-155)
        self.screenshot_path = screenshot_path
        # 120-step ring so the frame-time plot has the same history the
        # reference's PlotLines window shows (interface.cpp:486-510)
        self.timer = FrameTimer(window=120)
        # the frame's parts on the same ring: the step's launches, image()
        # (the wait for the card, the tonemap and the copy to the host)
        # and the PNG encode
        self.part_timers = {part: FrameTimer(window=120)
                            for part in ("step", "image", "encode")}
        self._lock = threading.Lock()
        self._dirty = True
        self._frame_id = 0
        self.reset_count = 0   # accumulation restarts (observability)
        self.screenshot_count = 0
        self._png: bytes = b""
        self._screenshot_requested = False
        self._p_held = False   # edge-trigger: one press = one screenshot
        self._refit_at = None  # monotonic time of the last refit sync
        self._pending_opts = None   # set_render target while it warms
        self._render_gen = 0
        self.error: Exception = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # -- editing (held lock required: see handle_edit) ---------------------
    _TRANSFORM_OPS = frozenset(
        {"translate_shape", "rotate_shape", "scale_shape"})

    def _scene_changed(self, op=None):
        """SceneEditor on_change hook: re-upload + reset accumulation
        (the update_scene + clear_canvas pair, main.cpp:277-280).

        Transform-only edits (gizmo drags) re-sync with a cheap BVH
        refit so per-frame drags never pay the SAH rebuild; the render
        loop schedules a full-quality rebuild shortly after the drag
        settles (only the cluster order differs: ties between triangles at
        one t may resolve to another of them).

        The render thread may be in a pass on the old scene meanwhile:
        ``Renderer.step`` reads its scenes once, and ``update_scene``
        swaps them whole, so a pass never mixes two scenes.  The old
        scene's memory goes back to the caching allocator when its last
        reference drops, possibly while its pass still runs on the card;
        that is safe because both threads launch on the device's default
        stream (neither sets a stream of its own), and the allocator
        hands a freed block only to work queued after it on that stream:
        the new scene's upload waits for the pass."""
        refit = op in self._TRANSFORM_OPS
        self.renderer.update_scene(self.scene, refit=refit)
        self._dirty = True
        self._refit_at = time.monotonic() if refit else None

    def handle_edit(self, cmd: dict) -> dict:
        """Apply one editor/loop command under the loop lock.  When the
        client ships its current selection ("sel"), the response carries
        the repaired one (editor.repair_selection) so structural edits
        never leave the browser pointing at a shifted index."""
        out = self._handle_edit(cmd)
        if "sel" in cmd and out.get("ok"):
            from .editor import repair_selection
            out = dict(out)
            out["sel"] = repair_selection(cmd.get("sel"), cmd, out)
        return out

    def _handle_edit(self, cmd: dict) -> dict:
        with self._lock:
            op = cmd.get("op")
            if op == "rerender":           # interface.cpp:381-383
                self._dirty = True
                return {"ok": True, "changed": True}
            if op == "screenshot":
                self._screenshot_requested = True
                return {"ok": True, "changed": False}
            if op == "set_camera":
                if "position" in cmd:
                    x, y, z = (float(v) for v in cmd["position"])
                    self.camera.position = (x, y, z)
                for f in ("yaw", "pitch"):
                    if f in cmd:
                        setattr(self.camera, f, float(cmd[f]))
                if "fov" in cmd:   # HTTP API speaks degrees
                    self.camera.fov = radians(float(cmd["fov"]))
                self._dirty = True
                return {"ok": True, "changed": True}
            if op == "set_render":
                return self._set_render(cmd)
            if op == "drag_shape":
                return self._drag_shape(cmd)
            if self.editor is None:
                raise EditError("this viewer was started without an "
                                "editable scene")
            return self.editor.apply(cmd)

    def _set_render(self, cmd: dict) -> dict:
        """Render params panel (interface.cpp:369-385).  Samples, bounces
        and the normals view are fixed when a Renderer is made, so a
        change makes a new one, on the live renderer's devices.

        The new renderer takes its first pass on a BACKGROUND thread (the
        kernels build at their first use, ops/cuda/build.py): the loop
        keeps rendering with the old one until then, then swaps
        atomically; a renderer superseded by a newer edit (rapid slider
        movement) is discarded by generation.  The two threads' passes
        may overlap on the card: every whole-trace launch owns its path
        counter and the kernels' launch counts take a lock, so neither
        disturbs the other."""
        base = self._pending_opts or self.renderer.options
        o = self.renderer.options
        # dataclasses.replace: every field the panel does NOT edit
        # (all_devices, tri_backend, ray_tile, ...) carries over — a
        # field-list rebuild here once silently dropped all_devices,
        # downgrading a sharded viewer to one device on any param edit
        opts = dataclasses.replace(
            base,
            num_samples=max(1, int(cmd.get("samples", base.num_samples))),
            num_bounces=max(1, int(cmd.get("bounces", base.num_bounces))),
            show_normals=bool(cmd.get("show_normals", base.show_normals)))
        if opts == o:
            # reverted to the live options: invalidate any in-flight
            # renderer by bumping the generation, or the stale one
            # would still swap in when it finishes
            if self._pending_opts is not None:
                self._render_gen += 1
                self._pending_opts = None
            return {"ok": True, "changed": False}
        self._render_gen += 1
        gen = self._render_gen
        self._pending_opts = opts
        renderer = Renderer(opts, device=(list(self.renderer.devices)
                                          if opts.all_devices
                                          else self.renderer.device))
        self._share_scene(renderer)
        cam = Camera(position=self.camera.position, yaw=self.camera.yaw,
                     pitch=self.camera.pitch, fov=self.camera.fov)

        def warm():
            try:
                renderer.step(cam, time=1)      # builds what it launches
                renderer.clear_canvas()
                with self._lock:
                    if self._render_gen != gen:
                        return                  # superseded by a newer edit
                    self._share_scene(renderer)
                    self.renderer = renderer
                    self._pending_opts = None
                    self._dirty = True
                    self.error = None   # a working renderer clears old ones
            except Exception as e:              # surfaced via /state
                with self._lock:
                    if self._render_gen != gen:
                        return  # superseded — its failure is irrelevant
                    # clear the never-applied opts so /state stops saying
                    # compiling and the next edit doesn't base off them
                    self._pending_opts = None
                    self.error = e

        threading.Thread(target=warm, daemon=True,
                         name="srt-render-warm").start()
        return {"ok": True, "changed": True, "compiling": True}

    def _share_scene(self, renderer: Renderer) -> None:
        """Hand ``renderer`` the live renderer's device scene (lock
        held).  Bands over several devices take a build of the host scene
        instead: ``set_device_scene`` takes one device's scene."""
        if len(set(renderer.devices)) > 1 and self.scene is not None:
            renderer.update_scene(self.scene)
        else:
            renderer.set_device_scene(self.renderer.device_scene)

    _WORLD_AXES = {"x": (1.0, 0.0, 0.0), "y": (0.0, 1.0, 0.0),
                   "z": (0.0, 0.0, 1.0)}

    def _drag_shape(self, cmd: dict) -> dict:
        """Mouse-drag manipulation of the selected shape — the gizmo
        analog, in the reference's three modes (interface.cpp:539-561,
        tiny-gizmo.cpp:373+):

        translate (default): screen-relative (dx, dy) move the shape along
        the camera's right/up axes, scaled by its distance so the shape
        tracks the cursor.
        rotate: horizontal drag spins about world up, vertical about the
        camera's right axis (small increments compose as rotation-vector
        addition).
        scale: vertical drag scales uniformly (up = bigger).

        cmd["axis"] ("x"|"y"|"z") constrains any mode to ONE axis — the
        per-axis dragger of tiny-gizmo's handle state machine
        (tiny-gizmo.cpp:309-327): translate projects the free-space cursor
        delta onto the WORLD axis, rotate spins about exactly that world
        axis, scale stretches the model's LOCAL axis (tiny-gizmo scales a
        per-axis scale vec3 in the object frame; a world-axis stretch on
        a rotated model would shear).  Spheres scale their radius — the
        reference maps any scale handle to radius, interface.cpp:13-34.
        """
        if self.editor is None:
            raise EditError("no editable scene")
        kind, index = cmd.get("kind"), cmd.get("index")
        mode = cmd.get("mode", "translate")
        axis_name = cmd.get("axis")
        if axis_name is not None and axis_name not in self._WORLD_AXES:
            raise EditError(f"unknown drag axis {axis_name!r}")
        dx = float(cmd.get("dx", 0))
        dy = float(cmd.get("dy", 0))
        cam = self.camera
        cy, sy = cos(cam.yaw), sin(cam.yaw)
        cp, sp = cos(cam.pitch), sin(cam.pitch)
        right = (cy, 0.0, -sy)                 # camera-space +x in world
        up = (sy * sp, cp, cy * sp)            # camera-space +y in world
        fwd = (-sy * cp, sp, -cy * cp)         # camera-space -z in world

        if mode == "rotate":
            if axis_name is not None:
                axis = self._WORLD_AXES[axis_name]
                angle = (dx - dy) * 6.28       # either drag direction spins
            else:
                ax = dx * 6.28                 # full drag ~ full turn
                ay = dy * 3.14
                axis = tuple(ax * u + ay * r
                             for u, r in zip((0.0, 1.0, 0.0), right))
                angle = (ax * ax + ay * ay) ** 0.5
            if angle == 0.0:
                return {"ok": True, "changed": False}
            return self.editor.apply({"op": "rotate_shape", "kind": kind,
                                      "index": index, "axis": axis,
                                      "angle": angle})
        if mode == "scale":
            out = {"op": "scale_shape", "kind": kind, "index": index,
                   "factor": 2.0 ** (-dy * 4.0)}
            if axis_name is not None:
                out["axis"] = axis_name
            return self.editor.apply(out)
        if mode != "translate":
            raise EditError(f"unknown drag mode {mode!r}")

        desc = [s for s in self.editor.describe()["shapes"]
                if s["kind"] == kind and s["index"] == index]
        if not desc:
            raise EditError(f"no {kind} with index {index!r}")
        pos = desc[0].get("position") or desc[0].get("translation")
        rel = tuple(p - c for p, c in zip(pos, cam.position))
        depth = max(sum(r * f for r, f in zip(rel, fwd)), 0.5)
        fov_scale = tan(cam.fov / 2.0)   # fov is radians on the model
        o = self.renderer.options
        kx = 2.0 * dx * depth * fov_scale * (o.width / o.height)
        ky = -2.0 * dy * depth * fov_scale
        delta = tuple(kx * r + ky * u for r, u in zip(right, up))
        if axis_name is not None:
            # project the free-space delta onto the world axis: dragging
            # along the axis' screen direction moves the shape, orthogonal
            # drag does nothing (and a view-aligned axis moves ~0 — the
            # same degeneracy tiny-gizmo's snap guards against)
            a = self._WORLD_AXES[axis_name]
            amount = sum(d * c for d, c in zip(delta, a))
            delta = tuple(amount * c for c in a)
        return self.editor.apply({"op": "translate_shape", "kind": kind,
                                  "index": index, "delta": delta})

    def describe_scene(self) -> dict:
        """Everything the panels render: scene + render params + camera."""
        with self._lock:
            d = self.editor.describe() if self.editor else {
                "shapes": [], "materials": [], "sky": {}}
            # while a set_render warms in the background the panels
            # show the TARGET params (the user's slider position)
            o = self._pending_opts or self.renderer.options
            d["render"] = {"samples": o.num_samples,
                           "bounces": o.num_bounces,
                           "show_normals": o.show_normals,
                           "width": o.width, "height": o.height,
                           "compiling": self._pending_opts is not None}
            d["camera"] = {"position": list(self.camera.position),
                           "yaw": self.camera.yaw,
                           "pitch": self.camera.pitch,
                           "fov": degrees(self.camera.fov)}
            return d

    def _pixel_ray(self, x: float, y: float):
        """World-space primary ray through pixel (x, y), with the same
        NDC math as generate_rays (render.cl:498-516).  Caller holds
        the lock."""
        o = self.renderer.options
        cam = self.camera
        fov_scale = tan(cam.fov / 2.0)
        aspect = o.width / o.height
        sx = (2.0 * (x + 0.5) / o.width - 1.0) * aspect * fov_scale
        sy = (1.0 - 2.0 * (y + 0.5) / o.height) * fov_scale
        cy_, sy_ = cos(cam.yaw), sin(cam.yaw)
        cp, sp = cos(cam.pitch), sin(cam.pitch)
        return cam.position, (cy_ * sx + sy_ * sp * sy - sy_ * cp,
                              cp * sy + sp,
                              -sy_ * sx + cy_ * sp * sy - cy_ * cp)

    def _shape_center(self, kind, index):
        desc = [s for s in self.editor.describe()["shapes"]
                if s["kind"] == kind and s["index"] == index]
        if not desc:
            return None
        return desc[0].get("position") or desc[0].get("translation")

    def pick(self, x: float, y: float, gizmo_sel: dict = None) -> dict:
        """Shape (or gizmo handle) under pixel (x, y).

        `gizmo_sel` = {"kind", "index", "mode"} describes the current
        selection's handle set; when given, the ray is hit-tested
        against the WORLD-SPACE 3-D handle geometry first (gizmo.py —
        tiny-gizmo raycasts its real handle meshes the same way,
        tiny-gizmo.cpp:115-134) with exact occlusion: the handle wins
        only where its hit is nearer than the scene's own nearest hit
        along this very ray, so a handle behind a wall (or inside the
        selected shape) cannot be grabbed.  Returns
        {"shape": ..., "gizmo_axis": "x"|"y"|"z"|None}."""
        if self.editor is None:
            return {"shape": None, "gizmo_axis": None}
        from . import gizmo as _gz
        with self._lock:
            origin, d = self._pixel_ray(x, y)
            t_scene, shape = self.editor.pick_with_t(origin, d)
            if gizmo_sel:
                center = self._shape_center(gizmo_sel.get("kind"),
                                            gizmo_sel.get("index"))
                if center is not None:
                    s = _gz.handle_scale(center, origin, self.camera.fov)
                    hit = _gz.ray_hit(origin, d, center,
                                      gizmo_sel.get("mode", "translate"),
                                      s)
                    if hit is not None and hit[1] <= t_scene + 1e-9:
                        return {"shape": shape, "gizmo_axis": hit[0]}
            return {"shape": shape, "gizmo_axis": None}

    def gizmo_overlay(self, gizmo_sel: dict):
        """Projected 3-D handle polylines for the SVG overlay: per axis
        a vertex chain [[px, py], ...] (null where the vertex is behind
        the near plane) and a parallel occlusion mask (true where the
        scene blocks the camera's view of that vertex — the client dims
        those spans, the analog of tiny-gizmo rendering its handles
        with real depth)."""
        if self.editor is None or not gizmo_sel:
            return None
        from . import gizmo as _gz
        import numpy as np
        with self._lock:
            center = self._shape_center(gizmo_sel.get("kind"),
                                        gizmo_sel.get("index"))
            if center is None:
                return None
            cam = self.camera
            o = self.renderer.options
            s = _gz.handle_scale(center, cam.position, cam.fov)
            polys = _gz.polylines(center,
                                  gizmo_sel.get("mode", "translate"), s)
            cy_, sy_ = cos(cam.yaw), sin(cam.yaw)
            cp, sp = cos(cam.pitch), sin(cam.pitch)
            right = np.array([cy_, 0.0, -sy_])
            up = np.array([sy_ * sp, cp, cy_ * sp])
            fwd = np.array([-sy_ * cp, sp, -cy_ * cp])
            fs = tan(cam.fov / 2.0)
            aspect = o.width / o.height
            cpos = np.asarray(cam.position, np.float64)
            out = {}
            for ax, pts in polys.items():
                rel = pts - cpos[None, :]
                px = rel @ right
                py = rel @ up
                pz = rel @ fwd
                dist = np.linalg.norm(rel, axis=1)
                vis = pz > 0.05
                # exact inverse of _pixel_ray's NDC mapping INCLUDING
                # its half-pixel center offset: a click on a drawn
                # vertex must rebuild the ray through that very vertex
                sxs = (px / np.maximum(pz, 1e-9) / (fs * aspect) + 1.0) \
                    / 2.0 * o.width - 0.5
                sys_ = (1.0 - py / np.maximum(pz, 1e-9) / fs) / 2.0 \
                    * o.height - 0.5
                occ = []
                for i in range(pts.shape[0]):
                    if not vis[i]:
                        occ.append(True)
                        continue
                    t = self.editor.pick_t(cpos, rel[i])
                    occ.append(bool(t + 1e-6 < dist[i]))
                out[ax] = {
                    "pts": [[round(float(sxs[i]), 1),
                             round(float(sys_[i]), 1)]
                            if vis[i] else None
                            for i in range(pts.shape[0])],
                    "occ": occ}
            return out

    # -- input (mirrors main.cpp:161-240) ---------------------------------
    def apply_input(self, keys, dx, dy, wheel, dt):
        with self._lock:
            moved = False
            h = (1.0 if "d" in keys else 0.0) - (1.0 if "a" in keys else 0.0)
            t = (1.0 if "s" in keys else 0.0) - (1.0 if "w" in keys else 0.0)
            v = (1.0 if " " in keys or "space" in keys else 0.0) - (
                1.0 if "c" in keys else 0.0)
            if h or t or v:
                self.camera.move(h, t, v, dt, self.movement_speed)
                moved = True
            if dx or dy:
                self.camera.look(dx, dy, dt, self.look_speed)
                moved = True
            if wheel:
                self.camera.zoom(-wheel)
                moved = True
            if moved:
                self._dirty = True  # time_not_moved = 1 (main.cpp:270-272)
            # 'p' screenshot (main.cpp:319-322): edge-triggered, and only a
            # FLAG is set here — the render thread saves after its step so
            # the HTTP thread never reads the canvas mid-mutation.
            p_now = "p" in keys
            if p_now and not self._p_held:
                self._screenshot_requested = True
            self._p_held = p_now

    def snapshot(self):
        with self._lock:
            hist = [round(t * 1e3, 2) for t in self.timer.times]
            return (self._png, self._frame_id, self.renderer.num_steps,
                    self.timer.avg * 1e3, self.timer.fps, hist)

    def _run(self):
        try:
            self._run_inner()
        except Exception as e:  # surfaced via /state and tests
            self.error = e

    def _run_inner(self):
        from PIL import Image

        while not self._stop.is_set():
            with self._lock:
                renderer = self.renderer
                if (self._refit_at is not None
                        and time.monotonic() - self._refit_at > 0.5):
                    # drag settled: restore full BVH quality (same image,
                    # better culling; no accumulation reset needed)
                    self.renderer.update_scene(self.scene)
                    self._refit_at = None
                if self._dirty:
                    renderer.clear_canvas()
                    self._dirty = False
                    self.reset_count += 1
                cam = Camera(position=self.camera.position,
                             yaw=self.camera.yaw, pitch=self.camera.pitch,
                             fov=self.camera.fov)
            t0 = time.perf_counter()
            # wall-clock RNG seed like the reference (main.cpp:287)
            seed = int(time.time() * 1000) & 0xFFFFFFFF or 1
            renderer.step(cam, time=seed)
            t1 = time.perf_counter()
            img = renderer.image()      # waits for the pass
            t2 = time.perf_counter()
            self.timer.record(t2 - t0)
            buf = io.BytesIO()
            Image.fromarray(img, "RGB").save(buf, "PNG")
            for part, seconds in (("step", t1 - t0), ("image", t2 - t1),
                                  ("encode", time.perf_counter() - t2)):
                self.part_timers[part].record(seconds)
            with self._lock:
                self._png = buf.getvalue()
                self._frame_id += 1
                shoot = self._screenshot_requested
                self._screenshot_requested = False
            if shoot:
                from .io.image import save_ppm
                try:
                    save_ppm(self.screenshot_path, img)
                    self.screenshot_count += 1
                except OSError as e:
                    # a bad --screenshot-path must not stop rendering;
                    # report it like any other recoverable error
                    self.error = e
            # FPS limiter (main.cpp:345-346: SDL_Delay to the cap)
            if self.fps_limit > 0:
                budget = 1.0 / self.fps_limit - (time.perf_counter() - t0)
                if budget > 0:
                    time.sleep(budget)


def make_handler(loop: RenderLoop, width: int, height: int):
    page = (_PAGE % {"w": width, "h": height}).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _read_json(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(200, page, "text/html")
            elif self.path.startswith("/frame.png"):
                png, *_ = loop.snapshot()
                if not png:
                    self._send(503, b"no frame yet", "text/plain")
                else:
                    self._send(200, png, "image/png")
            elif self.path.startswith("/state"):
                _, frame, steps, ms, fps, hist = loop.snapshot()
                self._send_json(
                    {"frame": frame, "steps": steps, "ms": ms, "fps": fps,
                     "hist": hist,
                     "resets": loop.reset_count,
                     "screenshots": loop.screenshot_count,
                     "error": repr(loop.error) if loop.error else None})
            elif self.path.startswith("/scene"):
                self._send_json(loop.describe_scene())
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            try:
                data = self._read_json()
            except (ValueError, UnicodeDecodeError):
                self._send(400, b"bad json", "text/plain")
                return
            if self.path == "/input":
                try:
                    loop.apply_input(set(data.get("keys", [])),
                                     float(data.get("dx", 0)),
                                     float(data.get("dy", 0)),
                                     float(data.get("wheel", 0)),
                                     float(data.get("dt", 0.016)))
                except (TypeError, ValueError) as e:
                    self._send_json({"ok": False,
                                     "error": f"bad payload: {e!r}"},
                                    code=400)
                    return
                _, frame, steps, ms, fps, hist = loop.snapshot()
                cam = loop.camera
                gz = data.get("gizmo") or None
                overlay = None
                if isinstance(gz, dict):
                    try:
                        # depth-correct handle polylines, re-projected
                        # against the live camera every tick (flying
                        # must not desync the overlay)
                        overlay = loop.gizmo_overlay(gz)
                    except (TypeError, ValueError, KeyError):
                        overlay = None
                self._send_json(
                    {"frame": frame, "steps": steps, "ms": ms, "fps": fps,
                     "hist": hist,
                     "camera": {"position": [float(v) for v in
                                             cam.position],
                                "yaw": float(cam.yaw),
                                "pitch": float(cam.pitch),
                                "fov": degrees(cam.fov)},
                     "gizmo": overlay,
                     "error": repr(loop.error) if loop.error else None})
            elif self.path == "/edit":
                try:
                    self._send_json(loop.handle_edit(data))
                except EditError as e:
                    # the import popup's error-line contract
                    self._send_json({"ok": False, "error": str(e)})
                except (TypeError, ValueError, KeyError) as e:
                    # malformed payload values (null floats, short
                    # vectors) keep the same structured contract rather
                    # than aborting the request with a traceback
                    self._send_json({"ok": False,
                                     "error": f"bad payload: {e!r}"})
            elif self.path == "/pick":
                try:
                    gz = data.get("gizmo") or None
                    if gz is not None and not isinstance(gz, dict):
                        raise ValueError("gizmo must be an object")
                    hit = loop.pick(float(data.get("x", 0)),
                                    float(data.get("y", 0)),
                                    gizmo_sel=gz)
                except (TypeError, ValueError, KeyError) as e:
                    self._send_json({"shape": None,
                                     "error": f"bad payload: {e!r}"},
                                    code=400)
                    return
                self._send_json(hit)
            else:
                self._send(404, b"not found", "text/plain")

    return Handler


def serve(scene, camera, options: RenderOptions, port: int = 8008,
          host: str = "127.0.0.1", fps_limit: float = 60.0,
          screenshot_path: str = "out.ppm", device=None):
    """Render ``scene`` on ``device`` (default the card; a list of band
    devices under ``options.all_devices``) and serve the page until
    interrupted."""
    renderer = Renderer(options, scene=scene, device=device)
    # the first pass and image() on the MAIN thread, before the loop
    # starts: the kernels build at their first use (ops/cuda/build.py),
    # so the first frame appears as soon as the loop spins up
    print("building the render path's kernels...", file=sys.stderr,
          flush=True)
    renderer.step(camera)
    renderer.image()
    renderer.clear_canvas()
    loop = RenderLoop(renderer, camera, fps_limit=fps_limit,
                      screenshot_path=screenshot_path, scene=scene)
    loop.start()
    server = ThreadingHTTPServer((host, port),
                                 make_handler(loop, options.width,
                                              options.height))
    print(f"viewer: http://{host}:{server.server_address[1]}/", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        loop.stop()
        server.server_close()
    return server


def main(argv=None) -> int:
    import torch

    from .models.presets import CONFIGS

    p = argparse.ArgumentParser(prog=PROG)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene")
    src.add_argument("--config", type=int, choices=sorted(CONFIGS))
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=272)
    p.add_argument("--samples", type=int, default=1)
    p.add_argument("--bounces", type=int, default=6)
    p.add_argument("--fps-limit", type=float, default=60.0,
                   help="cap render loop fps (reference default: 60); 0 = off")
    p.add_argument("--screenshot-path", default="out.ppm",
                   help="where the P key saves the PPM screenshot")
    p.add_argument("--all-devices", action="store_true",
                   help="render in horizontal bands over every local card "
                        "(height must divide by the card count); "
                        "render-param edits keep the bands")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; the hand-written "
                        "kernels) or cpu (their plain PyTorch versions)")
    args = p.parse_args(argv)

    if args.device.split(":")[0] == "cuda" and not torch.cuda.is_available():
        print(f"{PROG}: error: CUDA is not available; pass --device cpu to "
              "render with the plain PyTorch versions", file=sys.stderr)
        return 1
    if args.scene:
        from .io.scene_json import load_scene
        scene, camera = load_scene(args.scene)
        camera = camera or Camera()
    else:
        scene, camera, _ = CONFIGS[args.config]()
    options = RenderOptions(width=args.width, height=args.height,
                            num_samples=args.samples,
                            num_bounces=args.bounces,
                            all_devices=args.all_devices)
    # under --all-devices the bare card means every local card
    device = (None if args.device == "cuda" and args.all_devices
              else args.device)
    serve(scene, camera, options, port=args.port, fps_limit=args.fps_limit,
          screenshot_path=args.screenshot_path, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
