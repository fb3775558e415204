"""Streamlit UI smoke test (VERDICT r3 item 8) — the one reference component
with no coverage: drive ``app.run_streamlit`` with a FAKE streamlit module and
a stub orchestrator (no network, no accelerator, streamlit not even installed) and
assert the reference app behaviors (ref app.py:79-264): chat history append,
embedded plot HTML, and the two download-button payloads.
"""

import asyncio
import os
import sys
import types

import pytest


class _Rerun(Exception):
    """Stands in for streamlit's RerunException (st.rerun raises)."""


class _Ctx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _SessionState(dict):
    """Attribute + item access, like streamlit's SessionState."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def _make_fake_streamlit(chat_input_value):
    st = types.ModuleType("streamlit")
    st.session_state = _SessionState()
    st.calls = {"markdown": [], "download_button": [], "chat_message": [],
                "button_keys": [], "rerun": 0}

    st.set_page_config = lambda **kw: None
    st.title = lambda *a, **kw: None
    st.sidebar = _Ctx()
    st.spinner = lambda *a, **kw: _Ctx()
    st.markdown = lambda text, **kw: st.calls["markdown"].append(text)

    def button(label, key=None, **kw):
        st.calls["button_keys"].append(key or label)
        return False

    st.button = button

    def chat_message(role):
        st.calls["chat_message"].append(role)
        return _Ctx()

    st.chat_message = chat_message
    st.columns = lambda n: tuple(_Ctx() for _ in range(n))

    def download_button(label, data, file_name, mime, **kw):
        st.calls["download_button"].append(
            {"label": label, "data": data, "file_name": file_name,
             "mime": mime})

    st.download_button = download_button
    st.chat_input = lambda *a, **kw: chat_input_value

    def rerun():
        st.calls["rerun"] += 1
        raise _Rerun()

    st.rerun = rerun

    components = types.ModuleType("streamlit.components.v1")
    components.rendered = []
    components.html = lambda html, **kw: components.rendered.append(html)
    components_pkg = types.ModuleType("streamlit.components")
    components_pkg.v1 = components

    runtime = types.ModuleType("streamlit.runtime")
    runtime.exists = lambda: True
    st.runtime = runtime
    st.components = components_pkg
    return st, components, runtime


class _StubOrchestrator:
    """Deterministic orchestrator: records prompts, returns fixed artifacts."""

    def __init__(self, html_path, data_file):
        self.prompts = []
        self._result = {
            "summary": "Simulation Summary:\n- PDE Type: heat (stub)",
            "html_path": html_path,
            "data_file": data_file,
        }

    async def solve(self, prompt):
        self.prompts.append(prompt)
        return dict(self._result)

    def clear_memory(self):
        pass


@pytest.fixture()
def fake_ui(tmp_path, monkeypatch):
    html_path = tmp_path / "plot.html"
    html_path.write_text("<html><body><script>Plotly.newPlot()"
                         "</script></body></html>")
    data_file = tmp_path / "result.pkl"
    data_file.write_bytes(b"\x80\x04pickle-payload")

    def build(chat_input_value):
        st, components, runtime = _make_fake_streamlit(chat_input_value)
        monkeypatch.setitem(sys.modules, "streamlit", st)
        monkeypatch.setitem(sys.modules, "streamlit.components", st.components)
        monkeypatch.setitem(sys.modules, "streamlit.components.v1", components)
        monkeypatch.setitem(sys.modules, "streamlit.runtime", runtime)
        stub = _StubOrchestrator(str(html_path), str(data_file))
        st.session_state.orchestrator = stub
        st.session_state.history = []
        return st, components, stub

    return build, html_path, data_file


def test_prompt_appends_history_and_reruns(fake_ui):
    build, _, _ = fake_ui
    st, _, stub = build("solve heat in a 2 m rod, ends at 20 and 0 C")

    import app
    with pytest.raises(_Rerun):
        app.run_streamlit()

    assert stub.prompts == ["solve heat in a 2 m rod, ends at 20 and 0 C"]
    hist = st.session_state.history
    assert [h["role"] for h in hist] == ["user", "assistant"]
    assert hist[0]["content"].startswith("solve heat")
    assert "Simulation Summary" in hist[1]["content"]
    assert hist[1]["html_path"].endswith("plot.html")
    assert hist[1]["data_file"].endswith("result.pkl")
    assert st.calls["rerun"] == 1


def test_history_render_embeds_html_and_downloads(fake_ui):
    """On the post-rerun render (no new prompt) every assistant entry with a
    plot embeds the HTML and offers BOTH download payloads (ref
    app.py:236-264: two columns when both artifacts exist)."""
    build, html_path, data_file = fake_ui
    st, components, _ = build(None)
    st.session_state.history = [
        {"role": "user", "content": "q"},
        {"role": "assistant", "content": "a",
         "html_path": str(html_path), "data_file": str(data_file)},
    ]

    import app
    app.run_streamlit()  # chat_input None → pure render, no rerun

    assert st.calls["chat_message"] == ["user", "assistant"]
    assert components.rendered == [html_path.read_text()]
    dls = {d["file_name"]: d for d in st.calls["download_button"]}
    assert set(dls) == {"plot.html", "result.pkl"}
    assert dls["plot.html"]["data"] == html_path.read_bytes()
    assert dls["plot.html"]["mime"] == "text/html"
    assert dls["result.pkl"]["data"] == data_file.read_bytes()
    assert dls["result.pkl"]["mime"] == "application/octet-stream"
    assert st.calls["rerun"] == 0


def test_missing_data_file_offers_html_only(fake_ui, tmp_path):
    build, html_path, _ = fake_ui
    st, components, _ = build(None)
    st.session_state.history = [
        {"role": "assistant", "content": "a",
         "html_path": str(html_path),
         "data_file": str(tmp_path / "gone.pkl")},
    ]

    import app
    app.run_streamlit()

    labels = [d["file_name"] for d in st.calls["download_button"]]
    assert labels == ["plot.html"]
    assert components.rendered  # plot still embedded


def test_example_buttons_registered(fake_ui):
    build, _, _ = fake_ui
    st, _, _ = build(None)

    import app
    app.run_streamlit()

    # every example prompt gets a sidebar button, plus clear-memory
    for ex in app.EXAMPLES:
        assert ex in st.calls["button_keys"]
    assert "Clear memory" in st.calls["button_keys"]
