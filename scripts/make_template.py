"""Generate docs/TEMPLATE.ipynb.

The reference ships a second notebook, ``MaD_template.ipynb`` — a one-cell
blank-slate user template (add map, add components, run, build). This
mirrors it for mad_tpu, plus a demo-inputs preamble cell so the template is
executable out of the box (tests/test_walkthrough.py runs every code cell);
users point ``map_file``/``component_file`` at their own data instead.
"""

import json
import os

MD = "markdown"
CODE = "code"

cells = []


def cell(kind, src):
    cells.append({
        "cell_type": kind,
        "metadata": {},
        "source": src.strip("\n").splitlines(keepends=True),
        **({"outputs": [], "execution_count": None} if kind == CODE else {}),
    })


cell(MD, """
# mad_tpu template

Fill in your own inputs below and run the pipeline (the structure mirrors
the reference `MaD_template.ipynb`). The first cell builds a small
synthetic demo system so the template runs as-is; replace `map_file`,
`component_file`, `resolution` and `n_copies` with your own data.
""")

cell(CODE, """
import os
import numpy as np

workdir = os.environ.get("MAD_TEMPLATE_DIR", "template_results")
os.makedirs(workdir, exist_ok=True)

# --- replace with your own data ------------------------------------
# map_file = "/path/to/map.mrc";  resolution = 7.0;  n_copies = 6
# component_file = "/path/to/subunit.pdb"
# -------------------------------------------------------------------
# demo values: a synthetic homodimer and its simulated 8 A map
from mad_tpu.testing import make_assembly
from mad_tpu.ops.simulate import simulate_density
from mad_tpu.core.grid import write_mrc
from mad_tpu.core.structure import write_pdb

subunit, copies = make_assembly(n_copies=2, n_res=60, seed=11, spread=14.0)
coords = np.concatenate([c.coords for c in copies])
masses = np.concatenate([c.masses for c in copies])
map_file = os.path.join(workdir, "demo_map.mrc")
component_file = os.path.join(workdir, "demo_subunit.pdb")
write_mrc(simulate_density(coords, 8.0, 2.0, masses=masses), map_file)
write_pdb(subunit, component_file)
resolution = 8.0
n_copies = 2
""")

cell(CODE, """
from mad_tpu import MaD

# Make instance
mad = MaD(workdir=workdir)

# Add map (specify resolution after path), then add components
mad.add_map(map_file, resolution)

# Add component and specify number of copies
mad.add_subunit(component_file, n_copies=n_copies)

# Get solutions
mad.run(transform_subunits=True)

# Build assembly
mad.build_assembly()
""")

nb = {
    "cells": cells,
    "metadata": {
        "kernelspec": {"display_name": "Python 3", "language": "python",
                       "name": "python3"},
        "language_info": {"name": "python", "version": "3.12"},
    },
    "nbformat": 4,
    "nbformat_minor": 5,
}

out = os.path.join(os.path.dirname(__file__), "..", "docs",
                   "TEMPLATE.ipynb")
with open(out, "w") as fh:
    json.dump(nb, fh, indent=1)
print(f"wrote {os.path.normpath(out)} ({len(cells)} cells)")
