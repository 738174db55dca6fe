#!/usr/bin/env python
"""Generate the Jupyter notebook catalog from the runnable example scripts.

The reference ships its executable integration examples as notebooks
(ref ``notebooks/*.ipynb``, 16 files); this repo keeps the single source of
truth in ``examples/*.py`` (plain scripts, runnable in CI) and derives the
notebooks mechanically: the module docstring becomes the title cell, the
``sys.path`` shim is dropped (the notebooks assume an installed/checked-out
package at the repo root), and top-level blocks separated by blank lines
become code cells.

Usage:  python tools/make_notebooks.py        (writes notebooks/*.ipynb)

NOTE: regeneration rewrites the notebooks WITHOUT outputs — re-execute
with ``tools/run_notebooks.py`` (or ``git checkout`` the untouched ones)
so the committed notebooks keep their rendered results.
"""

import ast
import json
import pathlib
import re

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
OUT = REPO / "notebooks"

# example script -> (notebook name, extra intro markdown)
CATALOG = {
    "rp_atmosphere.py": (
        "simple_run.ipynb",
        "The Reinhold–Pierrehumbert 2-layer QG channel atmosphere with "
        "orography and Newtonian cooling — the introductory configuration "
        "(counterpart of the reference's `simple_run` / `introduction_qgs` "
        "notebooks)."),
    "maooam_coupled.py": (
        "maooam_run.ipynb",
        "The coupled ocean–atmosphere MAOOAM configuration (36 variables): "
        "atmosphere on a channel, shallow-water ocean on a basin, heat and "
        "momentum exchange."),
    "ground_coupled.py": (
        "maosoam_run.ipynb",
        "Atmosphere over land: ground heat exchange plus orography (the "
        "MAOSOAM-like configuration, counterpart of `maosoam_run` / "
        "`ground_heat`)."),
    "dynamic_temperature.py": (
        "maooam_dynamic_temperature.ipynb",
        "MAOOAM with dynamical 0-th order temperatures: T_a0 / T_o0 are "
        "prognostic variables and the tendency tensor is rank-5."),
    "t4_radiation.py": (
        "maooam_T4.ipynb",
        "MAOOAM with the full quartic T^4 longwave-radiation scheme "
        "(rank-5 tendency tensor, kept sparse/factored on device)."),
    "lyapunov_exponents.py": (
        "model_lyapunov.ipynb",
        "Lyapunov exponents and covariant Lyapunov vectors with the batched "
        "Benettin / Ginelli / subspace-intersection algorithms (counterpart "
        "of the reference's three `lyapunov/` notebooks)."),
    "diagnostics_tour.py": (
        "diagnostics.ipynb",
        "The full diagnostics catalog — streamfunctions, temperatures, "
        "winds (incl. the vertical velocity omega), vorticities, eddy heat "
        "fluxes — on one trajectory (counterpart of the `diagnostics/` "
        "notebooks)."),
    "symbolic_export.py": (
        "symbolic_output.ipynb",
        "Symbolic tendencies exported as Python / Julia / Fortran / "
        "Mathematica source and AUTO-07p continuation files (counterpart of "
        "the `symbolic_outputs/` notebooks)."),
    "custom_basis.py": (
        "manual_basis_setting.ipynb",
        "Building a model on user-provided (SymPy) basis functions instead "
        "of the built-in wavenumber blocks (counterpart of "
        "`manual_ocean_basis_setting`)."),
    "ensemble_statistics.py": (
        "ensemble_statistics.ipynb",
        "Device-sharded ensembles and trajectory statistics — the mesh "
        "replacement of the reference's one-process-per-trajectory pools."),
    "kernel_selection.py": (
        "kernel_selection.ipynb",
        "How the tendency contraction maps onto the device: the "
        "count-bucketed gather kernel, the dense matmul path, pair-factored "
        "quartics, and operand threading (no recompile across parameter "
        "sets) — no reference counterpart."),
    "precision_tiers.py": (
        "precision_tiers.ipynb",
        "The three device precision tiers (float32, double-float 2xf32, "
        "float64) and their accuracy/throughput trade-offs — no reference "
        "counterpart."),
    "distributed_ensembles.py": (
        "distributed_ensembles.ipynb",
        "The multi-process distributed layer: the "
        "('ensemble', 'model') device mesh, mode-sharded tendencies on the "
        "model axis, and a genuine 2-process `jax.distributed` run — the "
        "multi-host replacement of the reference's single-node process "
        "pools (no reference counterpart)."),
    "external_solvers.py": (
        "external_solvers.ipynb",
        "Feeding the `f(t, x)` tendency contract to external ODE suites "
        "(scipy RK45 / LSODA) — counterpart of the reference's "
        "`diffeq_test` notebook (DifferentialEquations.jl via diffeqpy)."),
    "clv_walkthrough.py": (
        "clv_walkthrough.ipynb",
        "Covariant Lyapunov vectors in depth: spectrum, state-dependent "
        "local exponents, the leading CLV as a physical perturbation "
        "pattern over the background flow, near-tangency statistics, and "
        "a numerical check of the covariance property — counterpart of "
        "the reference's `notebooks/lyapunov` deep dives."),
    "auto_continuation.py": (
        "auto_continuation.ipynb",
        "AUTO-07p continuation export end to end: generate and inspect "
        "the Fortran model file and the c.* constants file, then validate "
        "the emitted equations against the numeric pipeline by exec-ing "
        "the python target — counterpart of the reference's "
        "`notebooks/symbolic_outputs` walkthrough."),
}

SHIM = re.compile(
    r"import sys as _sys\nimport pathlib as _pathlib\n\n"
    r"_sys\.path\.insert\(0, str\(_pathlib\.Path\(__file__\)\.resolve\(\)\.parents\[1\]\)\)\n",
    re.M)


def cells_from_script(path):
    src = path.read_text()
    tree = ast.parse(src)
    doc = ast.get_docstring(tree) or path.stem
    # strip shebang, docstring, path shim
    body = src
    body = re.sub(r"\A#!.*\n", "", body)
    body = re.sub(r'\A"""' + r"[\s\S]*?" + r'"""\n', "", body)
    body = SHIM.sub("", body)
    # notebooks display figures inline: drop the headless-Agg switch and
    # turn file-writing savefig calls into inline shows
    body = re.sub(r"import matplotlib\n\nmatplotlib\.use\(\"Agg\"\)\n", "", body)
    body = re.sub(r"plt\.savefig\([^)]*\)", "plt.show()", body)
    body = re.sub(r'print\("wrote [^"]*"\)\n?', "", body)
    body = body.strip("\n")
    # split into cells on >=2 consecutive blank lines or at top-level
    # comment headers preceded by a blank line, but only where the next
    # block starts at column 0 (never inside an indented suite)
    body = re.sub(r"\n\n(#[^!\n])", r"\n\n\n\1", body)
    raw = [b.strip("\n") for b in re.split(r"\n\n\n+", body) if b.strip()]
    blocks = []
    for b in raw:
        if blocks and b[:1].isspace():
            blocks[-1] = blocks[-1] + "\n\n\n" + b
        else:
            blocks.append(b)
    return doc, blocks


def notebook(doc, intro, blocks):
    cells = [{
        "cell_type": "markdown",
        "metadata": {},
        "source": [f"# {doc.splitlines()[0].rstrip('.')}\n", "\n", intro + "\n"],
    }, {
        # make the checked-out repo importable when running from notebooks/
        "cell_type": "code", "execution_count": None, "metadata": {},
        "outputs": [],
        "source": ["import sys\n", "sys.path.insert(0, \"..\")"],
    }]
    for b in blocks:
        lines = b.splitlines()
        # leading top-level comment lines become a markdown narration cell
        n_c = 0
        while n_c < len(lines) - 1 and lines[n_c].startswith("#"):
            n_c += 1
        if n_c:
            text = " ".join(ln.lstrip("# ").rstrip() for ln in lines[:n_c])
            text = text[0].upper() + text[1:]
            # short labels render bold; real narration as a paragraph
            md = f"**{text}**" if len(text) < 60 else text
            cells.append({"cell_type": "markdown", "metadata": {},
                          "source": [md]})
            lines = lines[n_c:]
            while lines and not lines[0].strip():
                lines = lines[1:]
        src = [ln + "\n" for ln in lines]
        if src:
            src[-1] = src[-1].rstrip("\n")
        cells.append({"cell_type": "code", "execution_count": None,
                      "metadata": {}, "outputs": [], "source": src})
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def _has_outputs(path):
    try:
        nb = json.loads(path.read_text())
    except Exception:
        return False
    return any(c.get("outputs") for c in nb.get("cells", [])
               if c.get("cell_type") == "code")


def main():
    """Regenerate the notebooks from the example scripts.

    EXECUTED notebooks are never silently overwritten (round 3 lost 10
    notebooks' committed outputs exactly this way): a target that already
    carries outputs is skipped unless ``--force`` is passed — and with
    ``--force`` you are expected to re-run ``tools/run_notebooks.py``
    afterwards (the repo test suite asserts every committed notebook is
    executed)."""
    import sys

    force = "--force" in sys.argv[1:]
    OUT.mkdir(exist_ok=True)
    skipped = []
    for script, (nb_name, intro) in CATALOG.items():
        out = OUT / nb_name
        if out.exists() and _has_outputs(out) and not force:
            skipped.append(nb_name)
            continue
        doc, blocks = cells_from_script(EXAMPLES / script)
        nb = notebook(doc, intro, blocks)
        out.write_text(json.dumps(nb, indent=1) + "\n")
        print(f"{script} -> notebooks/{nb_name} ({len(blocks)} code cells)")
    if skipped:
        print(f"skipped {len(skipped)} executed notebook(s) "
              f"(pass --force to overwrite, then re-execute them): "
              + ", ".join(skipped))


if __name__ == "__main__":
    main()
