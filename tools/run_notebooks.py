#!/usr/bin/env python
"""Execute every notebook in notebooks/ in place, embedding outputs.

Runs on the CPU backend (deterministic); each notebook
is executed with its working directory set to notebooks/ so the repo import
shim in the first code cell resolves.

Usage:  JAX_PLATFORMS=cpu \
            python tools/run_notebooks.py [name.ipynb ...]
"""

import pathlib
import sys
import time

import nbformat
from nbclient import NotebookClient

REPO = pathlib.Path(__file__).resolve().parents[1]
NB_DIR = REPO / "notebooks"


def run_one(path):
    nb = nbformat.read(path, as_version=4)
    client = NotebookClient(nb, timeout=2400, kernel_name="python3",
                            resources={"metadata": {"path": str(NB_DIR)}})
    t0 = time.perf_counter()
    client.execute()
    nbformat.write(nb, path)
    n_out = sum(len(c.get("outputs", [])) for c in nb.cells)
    print(f"{path.name}: executed in {time.perf_counter() - t0:.0f}s, "
          f"{n_out} outputs", flush=True)


def main():
    names = sys.argv[1:]
    paths = ([NB_DIR / n for n in names] if names
             else sorted(NB_DIR.glob("*.ipynb")))
    failures = []
    for p in paths:
        try:
            run_one(p)
        except Exception as err:
            failures.append((p.name, str(err)[:500]))
            print(f"{p.name}: FAILED — {str(err)[:200]}", flush=True)
    if failures:
        sys.exit(f"{len(failures)} notebook(s) failed")


if __name__ == "__main__":
    main()
