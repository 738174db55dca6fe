#!/usr/bin/env python
"""Build the static HTML documentation site: guides + generated API
reference.

The reference ships a full Sphinx site with per-module API pages
(ref ``/root/reference/documentation/source/files/technical/``); Sphinx is
not installed in this image, so this generator produces the equivalent —
every ``docs/**/*.md`` guide rendered to HTML plus an introspected API
reference page for every public ``qgs_jax`` module (class/function
signatures and docstrings) — with only the stdlib + the ``markdown``
package.

Usage:  JAX_PLATFORMS=cpu \\
            python tools/build_docs.py [outdir]        (default docs/site)
"""

import html
import importlib
import inspect
import pathlib
import pkgutil
import sys

import markdown

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
DOCS = REPO / "docs"

MD_EXT = ["fenced_code", "tables", "codehilite", "toc"]

STYLE = """
body { font-family: -apple-system, "Segoe UI", Roboto, sans-serif;
       margin: 0; color: #1a202c; line-height: 1.55; }
.wrap { display: flex; max-width: 1200px; margin: 0 auto; }
nav { width: 250px; flex-shrink: 0; padding: 1.2rem; border-right: 1px solid #e2e8f0;
      font-size: 0.9rem; position: sticky; top: 0; height: 100vh; overflow-y: auto; }
nav h3 { margin: 0.8rem 0 0.3rem; font-size: 0.8rem; text-transform: uppercase;
         color: #718096; letter-spacing: 0.05em; }
nav a { display: block; color: #2b6cb0; text-decoration: none; padding: 0.12rem 0; }
nav a:hover { text-decoration: underline; }
main { padding: 1.5rem 2.5rem; min-width: 0; flex: 1; }
h1, h2, h3 { line-height: 1.25; }
h1 { border-bottom: 2px solid #e2e8f0; padding-bottom: 0.3rem; }
code, pre { font-family: "SF Mono", Menlo, Consolas, monospace; font-size: 0.88em;
            background: #f7fafc; }
pre { padding: 0.8rem 1rem; overflow-x: auto; border: 1px solid #e2e8f0;
      border-radius: 6px; }
table { border-collapse: collapse; margin: 1rem 0; }
th, td { border: 1px solid #cbd5e0; padding: 0.35rem 0.7rem; text-align: left; }
th { background: #edf2f7; }
.sig { background: #eef5ff; border: 1px solid #c3dafe; border-radius: 6px;
       padding: 0.5rem 0.9rem; margin: 1.4rem 0 0.4rem; font-family: Menlo, monospace;
       font-size: 0.88em; white-space: pre-wrap; }
.docstring { white-space: pre-wrap; background: none; border: none; padding: 0.2rem 0 0.6rem 1rem;
             font-family: inherit; font-size: 0.95em; color: #2d3748; }
.member { margin-left: 1.2rem; }
.kind { color: #805ad5; font-size: 0.75em; text-transform: uppercase;
        letter-spacing: 0.04em; margin-right: 0.4rem; }
.codehilite .k { color: #805ad5; } .codehilite .s, .codehilite .s1, .codehilite .s2 { color: #2f855a; }
.codehilite .c, .codehilite .c1 { color: #a0aec0; } .codehilite .n { color: #1a202c; }
"""

PAGE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — qgs-jax</title>
<style>{style}</style>
<script>MathJax = {{tex: {{inlineMath: [['$', '$'], ['\\\\(', '\\\\)']]}}}};</script>
<script async src="https://cdn.jsdelivr.net/npm/mathjax@3/es5/tex-mml-chtml.js"></script>
</head><body><div class="wrap">
<nav>{nav}</nav>
<main>{body}</main>
</div></body></html>
"""

GUIDES = [
    ("index.html", REPO / "README.md", "Overview"),
    ("user_guide.html", DOCS / "user_guide.md", "User guide"),
    ("model_description.html", DOCS / "model_description.md",
     "Model description"),
    ("technical_description.html", DOCS / "technical_description.md",
     "Technical description"),
    ("toolbox.html", DOCS / "toolbox.md", "Lyapunov toolbox"),
    ("model_oro.html", DOCS / "model" / "oro_model.md",
     "— Orographic model"),
    ("model_maooam.html", DOCS / "model" / "maooam_model.md",
     "— MAOOAM model"),
    ("model_ground.html", DOCS / "model" / "ground_model.md",
     "— Ground model"),
    ("model_dynT.html", DOCS / "model" / "dynamic_T_T4.md",
     "— Dynamic T / T⁴"),
    ("model_coefficients.html", DOCS / "model" / "coefficient_families.md",
     "— Coefficient families"),
]


def api_modules():
    import qgs_jax

    names = ["qgs_jax"]
    for m in pkgutil.walk_packages(qgs_jax.__path__, prefix="qgs_jax."):
        base = m.name.rsplit(".", 1)[-1]
        if base.startswith("_") or base.startswith("lib"):
            continue                  # private modules / native .so
        names.append(m.name)
    out = []
    for name in sorted(names):
        try:
            out.append((name, importlib.import_module(name)))
        except Exception as err:                       # pragma: no cover
            print(f"skipping {name}: {err}", file=sys.stderr)
    return out


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _doc(obj):
    d = inspect.getdoc(obj)
    return html.escape(d) if d else ""


def _public_members(mod):
    """Classes and functions defined IN this module (not re-exports),
    in source order."""
    members = []
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        if not (inspect.isclass(obj) or inspect.isfunction(obj)):
            continue
        if getattr(obj, "__module__", None) != mod.__name__:
            continue
        try:
            line = inspect.getsourcelines(obj)[1]
        except (OSError, TypeError):
            line = 1 << 30
        members.append((line, name, obj))
    return [(n, o) for _, n, o in sorted(members, key=lambda t: t[0])]


def render_module(name, mod):
    parts = [f"<h1><code>{name}</code></h1>"]
    if mod.__doc__:
        parts.append(f'<pre class="docstring">{_doc(mod)}</pre>')
    for mname, obj in _public_members(mod):
        anchor = html.escape(mname)
        if inspect.isclass(obj):
            parts.append(
                f'<div class="sig" id="{anchor}"><span class="kind">class'
                f'</span><b>{anchor}</b>{html.escape(_sig(obj))}</div>')
            if obj.__doc__:
                parts.append(f'<pre class="docstring">{_doc(obj)}</pre>')
            for aname in sorted(vars(obj)):
                if aname.startswith("_"):
                    continue
                attr = vars(obj)[aname]
                if inspect.isfunction(attr):
                    parts.append(
                        f'<div class="sig member"><span class="kind">method'
                        f'</span><b>{html.escape(aname)}</b>'
                        f'{html.escape(_sig(attr))}</div>')
                    if attr.__doc__:
                        parts.append(f'<pre class="docstring member">'
                                     f'{_doc(attr)}</pre>')
                elif isinstance(attr, property):
                    parts.append(
                        f'<div class="sig member"><span class="kind">property'
                        f'</span><b>{html.escape(aname)}</b></div>')
                    if attr.fget and attr.fget.__doc__:
                        parts.append(f'<pre class="docstring member">'
                                     f'{_doc(attr.fget)}</pre>')
        else:
            parts.append(
                f'<div class="sig" id="{anchor}"><span class="kind">def'
                f'</span><b>{anchor}</b>{html.escape(_sig(obj))}</div>')
            if obj.__doc__:
                parts.append(f'<pre class="docstring">{_doc(obj)}</pre>')
    return "\n".join(parts)


def diagnostics_catalog():
    """The concrete-diagnostics catalog table (the reference user guide's
    §'Diagnostics' table, auto-generated from the classes)."""
    import qgs_jax.diagnostics as dg

    rows = []
    pkg = pathlib.Path(dg.__file__).parent
    for m in sorted(pkgutil.iter_modules([str(pkg)]), key=lambda m: m.name):
        if m.name.startswith("_") or m.name in ("base", "util", "misc"):
            continue
        mod = importlib.import_module(f"qgs_jax.diagnostics.{m.name}")
        for name, obj in sorted(vars(mod).items()):
            if (inspect.isclass(obj) and not name.startswith("_")
                    and obj.__module__ == mod.__name__
                    and name.endswith("Diagnostic")):
                first = (inspect.getdoc(obj) or "").split("\n\n")[0]\
                    .replace("\n", " ")
                rows.append((m.name, name, first))
    body = ["<h1>Diagnostics catalog</h1>",
            "<p>Every concrete diagnostic class (see the "
            '<a href="user_guide.html">user guide</a> §5 for usage).</p>',
            "<table><tr><th>module</th><th>class</th>"
            "<th>what it computes</th></tr>"]
    for mod, cls, doc in rows:
        body.append(f"<tr><td><code>{mod}</code></td>"
                    f'<td><a href="api_qgs_jax.diagnostics.{mod}.html'
                    f'#{cls}"><code>{cls}</code></a></td>'
                    f"<td>{html.escape(doc)}</td></tr>")
    body.append("</table>")
    return "\n".join(body), len(rows)


def main():
    out_dir = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 \
        else DOCS / "site"
    out_dir.mkdir(parents=True, exist_ok=True)

    mods = api_modules()

    nav = ["<h3>Guides</h3>"]
    for fname, _, title in GUIDES:
        nav.append(f'<a href="{fname}">{title}</a>')
    nav.append('<a href="diagnostics_catalog.html">Diagnostics catalog</a>')
    nav.append("<h3>API reference</h3>")
    for name, _ in mods:
        nav.append(f'<a href="api_{name}.html"><code>{name}</code></a>')
    nav_html = "\n".join(nav)

    def write(fname, title, body):
        (out_dir / fname).write_text(PAGE.format(
            title=html.escape(title), style=STYLE, nav=nav_html, body=body))

    n_pages = 0
    for fname, src, title in GUIDES:
        body = markdown.markdown(src.read_text(), extensions=MD_EXT)
        write(fname, title.lstrip("— "), body)
        n_pages += 1

    cat_html, n_diag = diagnostics_catalog()
    write("diagnostics_catalog.html", "Diagnostics catalog", cat_html)
    n_pages += 1

    for name, mod in mods:
        write(f"api_{name}.html", name, render_module(name, mod))
        n_pages += 1

    print(f"wrote {n_pages} pages ({len(mods)} API modules, "
          f"{n_diag} diagnostics) to {out_dir}")


if __name__ == "__main__":
    main()
