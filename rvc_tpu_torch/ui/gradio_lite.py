"""Minimal gradio-compatible renderer (stdlib-only fallback); the port's
own copy of ``rvc_tpu/ui/gradio_lite.py``.

Parity target: the subset of the gradio Blocks API that app.py/tabs.py use
(reference app.py:22-112 runs the real gradio wheel). In environments
without the wheel the UI still needs to LAUNCH — this module renders the
same component tree to a real HTML page over http.server and dispatches
event callbacks over a JSON POST API, so every tab builder, i18n string,
and callback runs live. It is not a re-implementation of gradio (no
queuing, no websockets, no themes beyond light CSS); it is the smallest
server that makes the UI a product instead of an import error.

Surface implemented: Blocks, Tab, Row, Column, Accordion, Markdown,
Textbox, Slider, Button, Checkbox, Dropdown, Radio, Audio, Image, File,
JSON, update(), events .click/.change/.input/.upload/.submit/.select,
Blocks.launch(server_name, server_port, share, favicon_path,
prevent_thread_lock).

Event protocol (also how tests drive the UI headlessly):
  GET  /            -> rendered page (all tabs)
  GET  /config      -> JSON component/event manifest
  POST /api/<eid>   -> {"data": [input values...]} -> {"data": [outputs]}
  GET  /file?p=...  -> serve a local file (audio/image playback)
"""

from __future__ import annotations

import html as _html
import io
import json
import mimetypes
import os
import socket
import tempfile
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

_CTX: List["Container"] = []  # container nesting stack (build time)


def _current() -> Optional["Container"]:
    return _CTX[-1] if _CTX else None


def update(**kwargs) -> Dict[str, Any]:
    """gr.update equivalent: a partial-property patch for an output slot."""
    return {"__type__": "update", **kwargs}


class Event:
    def __init__(self, trigger: str, fn: Callable, inputs, outputs):
        self.trigger = trigger
        self.fn = fn
        self.inputs = inputs if isinstance(inputs, (list, tuple)) else (
            [inputs] if inputs is not None else [])
        self.outputs = outputs if isinstance(outputs, (list, tuple)) else (
            [outputs] if outputs is not None else [])
        self.eid = -1  # assigned by Blocks


class Component:
    kind = "component"

    def __init__(self, *args, label=None, value=None, choices=None,
                 info=None, step=None, minimum=None, maximum=None,
                 lines=None, visible=True, interactive=True, type=None,
                 variant=None, placeholder=None, open=None, scale=None,
                 allow_custom_value=None, sources=None, **_ignored):
        # positional conventions per component are normalized in subclasses;
        # generic fallback: first positional is label-or-value
        self.args = args
        self.label = label
        self.value = value
        self.choices = list(choices) if choices is not None else None
        self.info = info
        self.step = step
        self.minimum = minimum
        self.maximum = maximum
        self.lines = lines
        self.visible = visible
        self.interactive = interactive
        self.type = type
        self.variant = variant
        self.placeholder = placeholder
        self.events: List[Event] = []
        self.cid = None  # assigned by Blocks at render
        blocks = Blocks._building
        if blocks is not None:
            blocks._register(self)
        parent = _current()
        if parent is not None:
            parent.children.append(self)

    # -- event registration (gradio signature: fn, inputs, outputs) --------
    def _on(self, trigger, fn, inputs=None, outputs=None, **_kw):
        ev = Event(trigger, fn, inputs, outputs)
        self.events.append(ev)
        blocks = Blocks._building
        if blocks is not None:
            blocks._register_event(ev)
        return ev

    def click(self, fn, inputs=None, outputs=None, **kw):
        return self._on("click", fn, inputs, outputs, **kw)

    def change(self, fn, inputs=None, outputs=None, **kw):
        return self._on("change", fn, inputs, outputs, **kw)

    def input(self, fn, inputs=None, outputs=None, **kw):
        return self._on("input", fn, inputs, outputs, **kw)

    def upload(self, fn, inputs=None, outputs=None, **kw):
        return self._on("upload", fn, inputs, outputs, **kw)

    def submit(self, fn, inputs=None, outputs=None, **kw):
        return self._on("submit", fn, inputs, outputs, **kw)

    def select(self, fn, inputs=None, outputs=None, **kw):
        return self._on("select", fn, inputs, outputs, **kw)

    # -- rendering ----------------------------------------------------------
    def _label_html(self):
        lab = _html.escape(str(self.label)) if self.label else ""
        info = (f'<div class="info">{_html.escape(str(self.info))}</div>'
                if self.info else "")
        return f'<label for="{self.cid}">{lab}</label>{info}'

    def render(self) -> str:
        return (f'<div class="comp" id="wrap_{self.cid}">'
                f'{self._label_html()}{self._control_html()}</div>')

    def _control_html(self) -> str:
        return ""


class Markdown(Component):
    kind = "markdown"

    def __init__(self, value="", **kw):
        super().__init__(value=value, **kw)

    def render(self):
        # headings + bold only (enough for the app's banner strings)
        text = _html.escape(str(self.value or ""))
        for n in (3, 2, 1):
            pre = "#" * n
            if text.startswith(pre + " "):
                text = f"<h{n}>{text[n + 1:]}</h{n}>"
                break
        return f'<div class="md" id="{self.cid}">{text}</div>'


class Textbox(Component):
    kind = "textbox"

    def __init__(self, value="", *a, **kw):
        super().__init__(value=value, **kw)

    def _control_html(self):
        v = _html.escape(str(self.value if self.value is not None else ""))
        if self.lines and self.lines > 1:
            return (f'<textarea class="ctl" id="{self.cid}" '
                    f'rows="{self.lines}">{v}</textarea>')
        return f'<input class="ctl" id="{self.cid}" type="text" value="{v}">'


class Slider(Component):
    kind = "slider"

    def __init__(self, minimum=0, maximum=1, value=None, *a, **kw):
        kw.setdefault("step", None)
        super().__init__(minimum=minimum, maximum=maximum,
                         value=value if value is not None else minimum, **kw)

    def _control_html(self):
        step = self.step if self.step is not None else "any"
        return (f'<input class="ctl" id="{self.cid}" type="number" '
                f'min="{self.minimum}" max="{self.maximum}" step="{step}" '
                f'value="{self.value}">')


class Button(Component):
    kind = "button"

    def __init__(self, value="Run", *a, **kw):
        super().__init__(value=value, **kw)

    def render(self):
        v = _html.escape(str(self.value))
        cls = f"btn {self.variant or ''}"
        return (f'<button class="{cls}" id="{self.cid}" '
                f'onclick="fire(\'{self.cid}\')">{v}</button>')


class Checkbox(Component):
    kind = "checkbox"

    def __init__(self, value=False, *a, **kw):
        super().__init__(value=bool(value), **kw)

    def _control_html(self):
        chk = "checked" if self.value else ""
        return (f'<input class="ctl" id="{self.cid}" type="checkbox" {chk}>')


class Dropdown(Component):
    kind = "dropdown"

    def __init__(self, choices=None, *a, value=None, **kw):
        super().__init__(choices=choices or [], value=value, **kw)
        if self.value is None and self.choices:
            self.value = self.choices[0]

    def _control_html(self):
        opts = "".join(
            f'<option value="{_html.escape(str(c))}"'
            f'{" selected" if c == self.value else ""}>'
            f'{_html.escape(str(c))}</option>'
            for c in (self.choices or []))
        return f'<select class="ctl" id="{self.cid}">{opts}</select>'


class Radio(Dropdown):
    kind = "radio"


class Audio(Component):
    kind = "audio"

    def _control_html(self):
        path = self.value if isinstance(self.value, str) else ""
        src = f"/file?p={urllib.parse.quote(path)}" if path else ""
        audio = (f'<audio controls id="{self.cid}_player" src="{src}">'
                 "</audio>" if src else
                 f'<audio controls id="{self.cid}_player" hidden></audio>')
        return (f'<input class="ctl" id="{self.cid}" type="text" '
                f'placeholder="path to audio file" '
                f'value="{_html.escape(path)}">{audio}')


class Image(Audio):
    kind = "image"

    def _control_html(self):
        path = self.value if isinstance(self.value, str) else ""
        src = f"/file?p={urllib.parse.quote(path)}" if path else ""
        img = f'<img id="{self.cid}_img" src="{src}" class="preview">' \
            if src else f'<img id="{self.cid}_img" class="preview" hidden>'
        return (f'<input class="ctl" id="{self.cid}" type="text" '
                f'value="{_html.escape(path)}">{img}')


class File(Audio):
    kind = "file"

    def _control_html(self):
        path = self.value if isinstance(self.value, str) else ""
        return (f'<input class="ctl" id="{self.cid}" type="text" '
                f'placeholder="path to file" value="{_html.escape(path)}">')


class JSON(Component):
    kind = "json"

    def _control_html(self):
        v = json.dumps(self.value, indent=2) if self.value is not None else ""
        return f'<pre class="ctl json" id="{self.cid}">{_html.escape(v)}</pre>'


class Container(Component):
    kind = "container"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.children: List[Component] = []

    def __enter__(self):
        _CTX.append(self)
        return self

    def __exit__(self, *exc):
        assert _CTX.pop() is self
        return False

    def _children_html(self):
        return "".join(c.render() for c in self.children)

    def render(self):
        return f'<div class="{self.kind}">{self._children_html()}</div>'


class Row(Container):
    kind = "row"


class Column(Container):
    kind = "column"


class Accordion(Container):
    kind = "accordion"

    def __init__(self, label="", *a, open=True, **kw):
        super().__init__(label=label, **kw)
        self.open = open

    def render(self):
        op = " open" if self.open else ""
        return (f'<details class="accordion"{op}><summary>'
                f'{_html.escape(str(self.label))}</summary>'
                f'{self._children_html()}</details>')


class Tab(Container):
    kind = "tab"

    def __init__(self, label="", *a, **kw):
        super().__init__(label=label, **kw)


class Blocks(Container):
    """Top-level app: collects components/events, renders, serves."""

    kind = "blocks"
    _building: Optional["Blocks"] = None

    def __init__(self, title="app", theme=None, **kw):
        self.components: List[Component] = []
        self.event_list: List[Event] = []
        self._n = 0
        super().__init__(**kw)
        self.title = title
        self.theme = theme
        self.server = None
        self.server_port = None

    def _register(self, comp: Component):
        comp.cid = f"c{self._n}"
        self._n += 1
        self.components.append(comp)

    def _register_event(self, ev: Event):
        ev.eid = len(self.event_list)
        self.event_list.append(ev)

    def __enter__(self):
        Blocks._building = self
        return super().__enter__()

    def __exit__(self, *exc):
        Blocks._building = None
        return super().__exit__(*exc)

    # -- value plumbing -----------------------------------------------------
    @staticmethod
    def _coerce_in(comp: Component, raw):
        if comp.kind == "checkbox":
            return bool(raw)
        if comp.kind == "slider":
            try:
                f = float(raw)
                return int(f) if comp.step == 1 and f == int(f) else f
            except (TypeError, ValueError):
                return comp.value
        return raw

    @staticmethod
    def _encode_out(comp: Component, val):
        """Component output -> JSON patch {value:..., url?:..., choices?}."""
        patch: Dict[str, Any] = {}
        if isinstance(val, dict) and val.get("__type__") == "update":
            patch.update({k: v for k, v in val.items() if k != "__type__"})
            val = patch.get("value", None)
        else:
            patch["value"] = val
        if comp.kind in ("audio", "image") and isinstance(val, tuple) \
                and len(val) == 2:
            # (sr, ndarray) -> write a wav under tmp and serve it
            sr, arr = val
            path = _write_wav(int(sr), arr)
            patch["value"] = path
        if comp.kind in ("audio", "image", "file") and \
                isinstance(patch.get("value"), str) and patch["value"]:
            patch["url"] = f"/file?p={urllib.parse.quote(patch['value'])}"
        if comp.kind == "json" and patch.get("value") is not None \
                and not isinstance(patch["value"], str):
            patch["value"] = json.dumps(patch["value"], indent=2,
                                        default=str)
        return patch

    def call_event(self, eid: int, data: List[Any]) -> Dict[str, Any]:
        """Run event eid with raw input values -> {"data": [patches]}.
        This is the single dispatch path for the browser AND headless
        drivers/tests."""
        ev = self.event_list[eid]
        args = [self._coerce_in(c, v) for c, v in zip(ev.inputs, data)]
        out = ev.fn(*args)
        if len(ev.outputs) == 0:
            return {"data": []}
        if len(ev.outputs) == 1:
            out = (out,)
        elif not isinstance(out, (list, tuple)):
            out = (out,) * len(ev.outputs)
        patches = []
        for comp, val in zip(ev.outputs, out):
            patch = self._encode_out(comp, val)
            patch["id"] = comp.cid
            patch["kind"] = comp.kind
            # keep server-side state in sync for re-renders
            if "value" in patch:
                comp.value = patch["value"]
            if "choices" in patch:
                comp.choices = list(patch["choices"])
            patches.append(patch)
        return {"data": patches}

    def config(self) -> Dict[str, Any]:
        return {
            "title": self.title,
            "components": [
                {"id": c.cid, "kind": c.kind, "label": c.label}
                for c in self.components
            ],
            "events": [
                {"id": ev.eid, "trigger": ev.trigger,
                 "source": (ev_source.cid if (ev_source := _ev_src(self, ev))
                            else None),
                 "inputs": [c.cid for c in ev.inputs],
                 "outputs": [c.cid for c in ev.outputs]}
                for ev in self.event_list
            ],
        }

    # -- page ---------------------------------------------------------------
    def render_page(self) -> str:
        tabs = [c for c in self.children if isinstance(c, Tab)]
        other = [c for c in self.children if not isinstance(c, Tab)]
        nav = "".join(
            f'<button class="tabbtn" onclick="showTab({i})" id="tb{i}">'
            f'{_html.escape(str(t.label))}</button>'
            for i, t in enumerate(tabs))
        panes = "".join(
            f'<div class="pane" id="pane{i}" '
            f'style="display:{"block" if i == 0 else "none"}">'
            f'{t._children_html()}</div>'
            for i, t in enumerate(tabs))
        head = "".join(c.render() for c in other)
        ev_map = {
            str(ev.eid): {
                "inputs": [c.cid for c in ev.inputs],
                "outputs": [c.cid for c in ev.outputs],
                "trigger": ev.trigger,
                "source": (s.cid if (s := _ev_src(self, ev)) else None),
            }
            for ev in self.event_list
        }
        return _PAGE_TMPL % {
            "title": _html.escape(str(self.title)),
            "head": head, "nav": nav, "panes": panes,
            "events": json.dumps(ev_map),
        }

    # -- server -------------------------------------------------------------
    def launch(self, server_name="127.0.0.1", server_port=7860,
               share=False, favicon_path=None, prevent_thread_lock=False,
               **_kw):
        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="text/html; charset=utf-8"):
                if isinstance(body, str):
                    body = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path in ("/", "/index.html"):
                    self._send(200, app.render_page())
                elif parsed.path == "/config":
                    self._send(200, json.dumps(app.config()),
                               "application/json")
                elif parsed.path == "/health":
                    self._send(200, "ok", "text/plain")
                elif parsed.path == "/file":
                    q = urllib.parse.parse_qs(parsed.query)
                    p = (q.get("p") or [""])[0]
                    if p and os.path.isfile(p):
                        ctype = (mimetypes.guess_type(p)[0]
                                 or "application/octet-stream")
                        with open(p, "rb") as f:
                            self._send(200, f.read(), ctype)
                    else:
                        self._send(404, "not found", "text/plain")
                else:
                    self._send(404, "not found", "text/plain")

            def do_POST(self):
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path.startswith("/api/"):
                    try:
                        eid = int(parsed.path[len("/api/"):])
                        n = int(self.headers.get("Content-Length", "0"))
                        payload = json.loads(self.rfile.read(n) or b"{}")
                        result = app.call_event(eid, payload.get("data", []))
                        self._send(200, json.dumps(result, default=str),
                                   "application/json")
                    except Exception as e:  # surface errors to the page
                        self._send(500, json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}),
                            "application/json")
                else:
                    self._send(404, "not found", "text/plain")

        # bind first so the gradio-style port-retry (OSError) works
        self.server = ThreadingHTTPServer((server_name, server_port), Handler)
        self.server_port = server_port
        thread = threading.Thread(target=self.server.serve_forever,
                                  daemon=True)
        thread.start()
        print(f"[gradio_lite] serving on http://{server_name}:{server_port} "
              f"({len(self.components)} components, "
              f"{len(self.event_list)} events)")
        if not prevent_thread_lock:
            try:
                thread.join()
            except KeyboardInterrupt:
                self.server.shutdown()
        return self

    def close(self):
        if self.server is not None:
            self.server.shutdown()
            self.server = None


def _ev_src(blocks: Blocks, ev: Event) -> Optional[Component]:
    for c in blocks.components:
        if ev in c.events:
            return c
    return None


def _write_wav(sr: int, arr) -> str:
    import numpy as np
    import wave

    arr = np.asarray(arr)
    if arr.dtype != np.int16:
        arr = np.clip(arr.astype(np.float32), -1.0, 1.0)
        arr = (arr * 32767.0).astype(np.int16)
    fd, path = tempfile.mkstemp(suffix=".wav", prefix="gradio_lite_")
    os.close(fd)
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if arr.ndim == 1 else arr.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(arr.tobytes())
    return path


_PAGE_TMPL = """<!doctype html>
<html><head><meta charset="utf-8"><title>%(title)s</title>
<style>
body{font-family:system-ui,sans-serif;margin:0;background:#fafafa;color:#222}
.topbar{padding:10px 16px;background:#1f2937;color:#fff}
.tabbtn{padding:8px 14px;border:0;background:#e5e7eb;cursor:pointer;
  margin:6px 2px;border-radius:6px 6px 0 0}
.tabbtn.active{background:#fff;font-weight:600;border-bottom:2px solid #2563eb}
.pane{padding:12px 16px;background:#fff;min-height:300px}
.comp{margin:6px 8px;display:inline-block;vertical-align:top;min-width:220px}
.comp label{display:block;font-size:13px;font-weight:600;margin-bottom:2px}
.info{font-size:11px;color:#666;margin-bottom:2px}
.ctl{width:95%%;padding:4px;border:1px solid #cbd5e1;border-radius:4px}
pre.json{background:#f1f5f9;max-height:240px;overflow:auto}
.btn{padding:8px 16px;margin:8px;background:#2563eb;color:#fff;border:0;
  border-radius:6px;cursor:pointer}
.btn.primary{background:#16a34a}
.row{display:flex;flex-wrap:wrap;align-items:flex-end}
.accordion{margin:8px;border:1px solid #e5e7eb;border-radius:6px;
  padding:4px 8px}
.preview{max-width:480px;display:block;margin-top:4px}
#status{position:fixed;right:12px;bottom:8px;font-size:12px;color:#555}
</style></head><body>
<div class="topbar">%(title)s <span style="font-size:11px;opacity:.7">
(gradio_lite renderer)</span></div>
%(head)s
<div>%(nav)s</div>
%(panes)s
<div id="status"></div>
<script>
const EVENTS = %(events)s;
function showTab(i){
  document.querySelectorAll('.pane').forEach((p,j)=>
    p.style.display = i===j ? 'block':'none');
  document.querySelectorAll('.tabbtn').forEach((b,j)=>
    b.classList.toggle('active', i===j));
}
function getVal(id){
  const el = document.getElementById(id);
  if(!el) return null;
  if(el.type === 'checkbox') return el.checked;
  if(el.tagName === 'PRE') return el.textContent;
  return el.value;
}
function setPatch(p){
  const el = document.getElementById(p.id);
  if(!el) return;
  if('choices' in p && el.tagName === 'SELECT'){
    el.innerHTML = p.choices.map(c=>`<option>${c}</option>`).join('');
  }
  if('value' in p && p.value !== null){
    if(el.type === 'checkbox') el.checked = !!p.value;
    else if(el.tagName === 'PRE') el.textContent = String(p.value);
    else el.value = String(p.value);
  }
  if(p.url){
    const player = document.getElementById(p.id + '_player');
    if(player){ player.src = p.url; player.hidden = false; }
    const img = document.getElementById(p.id + '_img');
    if(img){ img.src = p.url; img.hidden = false; }
  }
}
async function runEvent(eid){
  const ev = EVENTS[eid];
  const data = ev.inputs.map(getVal);
  document.getElementById('status').textContent = 'running...';
  const r = await fetch('/api/' + eid, {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({data})});
  const out = await r.json();
  if(out.error){
    document.getElementById('status').textContent = out.error;
    return;
  }
  (out.data||[]).forEach(setPatch);
  document.getElementById('status').textContent = 'done';
}
function fire(cid){
  for(const [eid, ev] of Object.entries(EVENTS)){
    if(ev.source === cid && ev.trigger === 'click') runEvent(eid);
  }
}
// wire change/input/upload triggers
window.addEventListener('DOMContentLoaded', ()=>{
  for(const [eid, ev] of Object.entries(EVENTS)){
    if(['change','input','upload','submit'].includes(ev.trigger) && ev.source){
      const el = document.getElementById(ev.source);
      if(el) el.addEventListener('change', ()=>runEvent(eid));
    }
  }
  showTab(0);
});
</script></body></html>
"""
