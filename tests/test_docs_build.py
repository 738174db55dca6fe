"""The documentation site must build: guides + a generated API-reference
page for every public module (the reference ships Sphinx API pages for
every module, ref ``/root/reference/documentation/source/files/technical/``;
``tools/build_docs.py`` is the no-Sphinx equivalent)."""

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

pytest.importorskip("markdown")


def test_docs_site_builds(tmp_path):
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "build_docs.py"),
         str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin",
             "JAX_PLATFORMS": "cpu", "HOME": "/tmp"})
    assert out.returncode == 0, out.stderr[-2000:]

    pages = sorted(p.name for p in tmp_path.glob("*.html"))
    # guides
    for required in ("index.html", "user_guide.html", "toolbox.html",
                     "model_description.html", "diagnostics_catalog.html"):
        assert required in pages
    # an API page for every core module a reference user would browse
    for mod in ("qgs_jax.integrators.integrator", "qgs_jax.params.params",
                "qgs_jax.toolbox.lyapunov", "qgs_jax.ops.contraction",
                "qgs_jax.diagnostics.streamfunctions"):
        assert f"api_{mod}.html" in pages, f"missing API page for {mod}"
    assert len([p for p in pages if p.startswith("api_")]) >= 40

    # signatures are browsable (the round-3 gap: no way to see
    # RungeKuttaTglsIntegrator's signature without reading source)
    integ = (tmp_path / "api_qgs_jax.integrators.integrator.html").read_text()
    assert "RungeKuttaTglsIntegrator" in integ
    assert "set_func" in integ and "integrate" in integ

    cat = (tmp_path / "diagnostics_catalog.html").read_text()
    assert cat.count("<tr>") > 30      # the full diagnostics catalog table
