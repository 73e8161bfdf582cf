"""Static checks of the browser client in the port's viewer._PAGE.

There is no JS engine here, so the client cannot be run under test; what
can be checked is the contract between the page's script and the port's
server (tests/test_viewer_client.py's checks, on the port): the ops it
posts exist, the endpoints it fetches are routed, the element ids it
reads exist, the JSON keys it reads are sent, and the drag guard is in
place.  The page itself is the JAX package's, its title aside.
"""
import re

from simple_raytracer_tpu import viewer as jviewer_mod
from simple_raytracer_tpu_torch import editor as editor_mod
from simple_raytracer_tpu_torch import viewer as viewer_mod

PAGE = viewer_mod._PAGE
SCRIPT = PAGE[PAGE.index("<script>"):PAGE.index("</script>")]
HTML = PAGE[:PAGE.index("<script>")]


def _strip_strings(js: str) -> str:
    """Remove string/template literals, comments, and (heuristically)
    regex literals so bracket counting and identifier scans don't trip
    on quoted text.  Regex literals are recognized only where a regex
    can start (after =, (, comma, :, ;, !, &&, ||, ?, return) — the
    standard division-vs-regex heuristic; a regex in a position this
    misses would make test_script_brackets_balanced false-fail, which
    is diagnosable from this docstring."""
    js = re.sub(r"//[^\n]*", "", js)
    js = re.sub(r"/\*.*?\*/", "", js, flags=re.S)
    js = re.sub(r"'(?:[^'\\\n]|\\.)*'", "''", js)
    js = re.sub(r'"(?:[^"\\\n]|\\.)*"', '""', js)
    js = re.sub(r"`(?:[^`\\]|\\.)*`", "``", js)
    js = re.sub(r"(?<=[=(,:;!&|?])\s*/(?:[^/\\\n\[]|\\.|"
                r"\[(?:[^\]\\\n]|\\.)*\])+/[a-z]*", " ''", js)
    js = re.sub(r"\breturn\s+/(?:[^/\\\n\[]|\\.|"
                r"\[(?:[^\]\\\n]|\\.)*\])+/[a-z]*", "return ''", js)
    return js


def _blank_strings(js: str) -> str:
    """Like _strip_strings but LENGTH-PRESERVING (literals/comments are
    replaced by spaces), so indices found in the blanked text slice the
    raw text correctly — used for brace-matching handler bodies."""
    def blank(m):
        return " " * len(m.group(0))
    js = re.sub(r"//[^\n]*", blank, js)
    js = re.sub(r"/\*.*?\*/", blank, js, flags=re.S)
    js = re.sub(r"'(?:[^'\\\n]|\\.)*'", blank, js)
    js = re.sub(r'"(?:[^"\\\n]|\\.)*"', blank, js)
    js = re.sub(r"`(?:[^`\\]|\\.)*`", blank, js)
    return js


def _handler_body(name: str) -> str:
    """Raw text of the `{...}` statement block assigned to `name = ...`
    (arrow or function), found by brace matching on the string-blanked
    script so braces inside literals don't miscount."""
    blanked = _blank_strings(SCRIPT)
    m = re.search(rf"{re.escape(name)}\s*=", blanked)
    assert m, f"{name} handler not found"
    start = blanked.index("{", m.end())
    depth, i = 0, start
    while i < len(blanked):
        if blanked[i] == "{":
            depth += 1
        elif blanked[i] == "}":
            depth -= 1
            if depth == 0:
                return SCRIPT[start:i + 1]
        i += 1
    raise AssertionError(f"unbalanced braces in {name} handler")


def test_page_template_keys():
    """_PAGE % {...} must only need the keys do_GET supplies
    (viewer.py builds the page with {'w': width, 'h': height})."""
    keys = set(re.findall(r"%\((\w+)\)s", PAGE))
    assert keys == {"w", "h"}
    # and the substitution itself must not raise
    assert "%(w)s" not in PAGE % {"w": 8, "h": 6}


def test_script_brackets_balanced():
    """A truncated or mis-pasted template edit shows up as unbalanced
    brackets long before anyone opens a browser."""
    js = _strip_strings(SCRIPT)
    for op, cl in ["{}", "()", "[]"]:
        assert js.count(op) == js.count(cl), f"unbalanced {op}{cl}"


def test_client_ops_exist_on_server():
    """Every op the client can POST to /edit must be dispatchable:
    either one of RenderLoop.handle_edit's special cases or an
    Editor._op_* handler (editor.py:143-152 dispatch)."""
    client_ops = set(re.findall(r"op\s*:\s*'([a-z_]+)'", SCRIPT))
    assert client_ops, "expected the client to reference edit ops"
    special = {"rerender", "screenshot", "set_camera", "set_render",
               "drag_shape"}  # handled in RenderLoop.handle_edit
    editor_ops = {name[len("_op_"):] for name in dir(editor_mod.SceneEditor)
                  if name.startswith("_op_")}
    unknown = client_ops - special - editor_ops
    assert not unknown, f"client references unhandled ops: {unknown}"


def test_client_endpoints_are_routed():
    """Every fetch('/path') in the client must be routed by the
    handler's do_GET/do_POST path checks."""
    fetched = set(re.findall(r"fetch\('(/[\w./]*)", SCRIPT))
    fetched |= {m.split("?")[0] for m in
                re.findall(r"src\s*=\s*'(/[\w./]+)", SCRIPT)}
    assert fetched >= {"/edit", "/scene", "/pick", "/input", "/frame.png"}
    import inspect
    server_src = inspect.getsource(viewer_mod)
    routed = set(re.findall(r"self\.path(?:\.startswith\(|\s*==\s*)"
                            r"['\"](/[\w.]*)", server_src))
    # a fetched path must match a routed literal exactly or by prefix
    # (the handler uses startswith for /frame.png, /state, /scene)
    unrouted = {p for p in fetched
                if p not in routed
                and not any(p.startswith(r) for r in routed if r != "/")}
    assert not unrouted, f"client fetches unrouted endpoints: {unrouted}"


def test_element_ids_resolve():
    """Every getElementById / val() target must exist: either a static
    id=... in the HTML or an element the script itself creates and
    assigns an id to."""
    wanted = set(re.findall(r"getElementById\('([\w-]+)'\)", SCRIPT))
    wanted |= set(re.findall(r"\bval\('([\w-]+)'\)", SCRIPT))
    # val('...') with computed ids (template literals) are skipped by the
    # regex by construction; the static ones are the regression surface
    static_ids = set(re.findall(r"\bid=([\w-]+)", HTML))
    static_ids |= set(re.findall(r"\bid=\"([\w-]+)\"", HTML))
    static_ids |= set(re.findall(r"\bid='([\w-]+)'", HTML))
    created = set(re.findall(r"\.id\s*=\s*'([\w-]+)'", SCRIPT))
    missing = wanted - static_ids - created
    assert not missing, f"client references missing element ids: {missing}"


def test_client_reads_match_server_json():
    """The JSON keys the client reads off /input, /pick and /edit
    responses must be keys the server actually sends (a rename on one
    side ships silently otherwise)."""
    import inspect
    server_src = inspect.getsource(viewer_mod)
    # /input response fields the tick loop consumes
    for key in ["frame", "steps", "ms", "fps", "hist", "camera", "gizmo"]:
        assert re.search(rf"[\"']{key}[\"']\s*:", server_src), key
        assert re.search(rf"\bs\.{key}\b", SCRIPT), \
            f"tick() no longer reads s.{key} — update this test"
    # /pick response fields onmousedown consumes
    pick_src = inspect.getsource(viewer_mod.RenderLoop.pick)
    for key in ["gizmo_axis", "shape"]:
        assert re.search(rf"hit\.{key}\b", SCRIPT), key
        assert re.search(rf"[\"']{key}[\"']", pick_src), \
            f"RenderLoop.pick no longer sends {key!r}"
    # /edit error contract: {ok, error}
    assert re.search(r"\bj\.ok\b", SCRIPT) and \
        re.search(r"\bj\.error\b|\br\.error\b", SCRIPT)


def test_drag_edit_payload_matches_handle_edit():
    """The drag_shape body built in document.onmousemove must carry the
    exact field names RenderLoop.handle_edit's drag path reads."""
    m = re.search(r"op\s*:\s*'drag_shape'[^}]*", SCRIPT)
    assert m, "drag_shape payload construction not found in client"
    body_fields = set(re.findall(r"(\w+)\s*:", m.group(0)))
    body_fields.add("axis")  # attached conditionally a line later
    assert re.search(r"body\.axis\s*=", SCRIPT)
    import inspect
    drag_src = inspect.getsource(viewer_mod.RenderLoop._drag_shape)
    handle_src = inspect.getsource(viewer_mod.RenderLoop.handle_edit)
    for field in ["kind", "index", "mode", "dx", "dy", "axis"]:
        assert field in body_fields, f"client drag body lost {field!r}"
        assert re.search(rf"[\"']{field}[\"']", drag_src + handle_src), \
            f"server drag path no longer reads {field!r}"


def test_drag_lifecycle_guards_structural():
    """The fast-click race guard: /pick is awaited, so mouseup can land
    mid-await; the client must track the physical button state and only
    engage the drag if it is still held.

    Checked STRUCTURALLY (no variable-name pins, so a rename doesn't
    break the test while deleting the guard still does):
      * some variable is set true in onmousedown BEFORE the awaited
        /pick and cleared in onmouseup — the physical-button tracker,
      * every drag-engage site (an `if` whose body sets the drag flag)
        after the await consults that variable in its condition,
      * onmouseup also drops the drag flag itself."""
    down = _handler_body("img.onmousedown")
    up = _handler_body("document.onmouseup")
    assert "await" in down, "onmousedown no longer awaits /pick"
    pre_await = down[:down.index("await")]
    post_await = down[down.index("await"):]

    # drag flag = variable(s) set true only AFTER the await and cleared
    # on mouseup; guard = set true BEFORE the await and cleared on mouseup
    cleared = set(re.findall(r"(\w+)\s*=\s*false\b", up))
    guards = set(re.findall(r"(\w+)\s*=\s*true\b", pre_await)) & cleared
    drag_flags = set(re.findall(r"(\w+)\s*=\s*true\b", post_await)) \
        & cleared - guards
    assert guards, "no button-state guard set before the /pick await " \
                   "and cleared in onmouseup"
    assert drag_flags, "no drag flag set after the await and cleared " \
                       "in onmouseup"

    # every engage site's condition must read a guard variable
    engages = re.findall(
        r"if\s*\(([^)]*)\)\s*(?:\{[^{}]*|[^;{]*)"
        rf"(?:{'|'.join(drag_flags)})\s*=\s*true",
        post_await)
    assert engages, "no drag-engage site found after the /pick await"
    for cond in engages:
        assert any(re.search(rf"\b{g}\b", cond) for g in guards), \
            f"drag engaged without consulting the button guard: " \
            f"if ({cond.strip()})"


def test_page_is_the_jax_page_but_its_title():
    title = "<title>simple_raytracer_tpu_torch</title>"
    assert PAGE.count(title) == 1
    assert PAGE.replace(title, "<title>simple_raytracer_tpu</title>") \
        == jviewer_mod._PAGE
