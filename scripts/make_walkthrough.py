"""Generate docs/WALKTHROUGH.ipynb.

The reference ships MaD_notebook_instructions.ipynb (31 cells: minimal
examples, parameter-tweak matrix, ensemble docking, anchor-file docs); its
test data (EMDB maps / PDB entries) is not redistributable, so this
walkthrough mirrors the same structure on synthetic self-fit systems that
run end-to-end in minutes. tests/test_walkthrough.py executes every code
cell to keep the document honest.
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
# mad_tpu — Macromolecular Descriptors on JAX

This walkthrough contains all the necessary information to run mad_tpu. It
mirrors the reference MaD walkthrough (`MaD_notebook_instructions.ipynb`)
section by section; because the reference's EMDB/PDB testing data is not
redistributable, the runnable examples here build **synthetic self-fit
systems** (simulated assemblies, the protocol of the reference's own
simulated dataset, notebook cell 22). Every cell runs end-to-end on one
GPU or on CPU.

1. **Minimal examples**
    1. Homomultimer (synthetic trimer) + output explanation
    2. Heteromultimer (two distinct subunits)
2. **Tweaking parameters** — the reference's documented system matrix
3. **Ensemble docking**
4. **Anchor files**
5. **Device notes: meshes, caches, debugging**

You'll find the solutions in the `individual_solutions` and
`assembly_models` subfolders within the folder created for your assembly,
inside the main `results` folder.
""")

cell(MD, """
## 1. Minimal examples

### A. Homomultimer

This minimal code predicts the assembly of a synthetic homotrimer from a
single monomer and a 8 Å map simulated from the trimer. As in the
reference protocol, `transform_subunits=True` first moves the subunit away
from its deposited pose (rotation + 150 Å translation), so recovering the
fit is unbiased (self-fit decoy protocol, reference
`structure_utils.py:30-56`).

For homomultimeric assemblies, only a single copy of the repeated
structure is required (`n_copies` tells MaD the stoichiometry).

Results are saved in the `results` folder; the folder name is built from
the map and component names, resolution, copies and isovalue. Re-running
the same system creates `..._1`, `..._2`, and so on. Descriptors are
cached in `dsc_db/` — restarting is faster because descriptors are loaded
instead of recomputed.
""")

cell(CODE, """
import os
import numpy as np

workdir = os.environ.get("MAD_WALKTHROUGH_DIR", "walkthrough_results")
os.makedirs(workdir, exist_ok=True)

# --- synthetic system: a homotrimer and its simulated 8 A map ---
from mad_tpu.testing import make_assembly
from mad_tpu.ops.simulate import simulate_density
from mad_tpu.core.grid import write_mrc
from mad_tpu.core.structure import write_pdb

subunit, copies = make_assembly(n_copies=3, n_res=60, seed=4, spread=18.0)
coords = np.concatenate([c.coords for c in copies])
masses = np.concatenate([c.masses for c in copies])
write_mrc(simulate_density(coords, 8.0, 2.0, masses=masses),
          os.path.join(workdir, "trimer_map.mrc"))
write_pdb(subunit, os.path.join(workdir, "subunit.pdb"))
""")

cell(CODE, """
from mad_tpu import MaD

mad = MaD(workdir=workdir)
mad.add_map(os.path.join(workdir, "trimer_map.mrc"), resolution=8.0)
mad.add_subunit(os.path.join(workdir, "subunit.pdb"), n_copies=3)
mad.run(transform_subunits=True)
mad.build_assembly()
""")

cell(MD, """
#### Explanation of output

1. Descriptors are generated for all structures (anchor detection,
   orientation, description). If available in the database (`dsc_db`
   folder), descriptors are loaded instead.
2. Matching occurs:
   1. Local descriptor matching identifies pairs that may yield a valid
      transformation of the subunit into the density (one MXU matmul).
   2. Filtering: ranking according to global anchor matching
      (repeatability), then clustering; one solution per cluster.
   3. Local rigid refinement fixes inaccuracies from anchor coordinates
      and orientations (all candidates refine together in one program).
3. Scoring:
   * **Repeat** — repeatability, the percentage of anchors with a
     correspondence in the target density.
   * **Weight** — the size of the corresponding cluster (descriptor pairs
     agreeing with that localization).
   * **mCC** — map cross-correlation.
   * **RWmCC** — the product of the previous scores.
4. Assembly building is a combinatorial exploration respecting the target
   stoichiometry: pairwise overlaps (structural clashes estimated from
   co-located non-zero voxels) are printed as a table; candidate tuples
   rank by overlap and the best clash-free ones are CC-scored and written
   to `assembly_models/Model_*.pdb` with `complex_ranking.csv`.

Verify the recovered fit below: each copy of the trimer should be matched
by a solution within a couple of Å of CA-RMSD.
""")

cell(CODE, """
sols = mad.solutions["subunit"]
print(f"{len(sols)} solutions")
for i, c in enumerate(copies):
    best = min(s.structure.rmsd_ca_with(c) for s in sols)
    print(f"copy {i}: best CA-RMSD {best:.2f} A")
assert min(s.structure.rmsd_ca_with(c) for s in sols) < 4.0
""")

cell(MD, """
### B. Heteromultimer

Heteromers list several components; each is docked independently and the
assembly stage builds per-component subcomplexes, then combines them
across components (cartesian product, device-ranked). Components can have
different copy numbers.
""")

cell(CODE, """
from mad_tpu.testing import make_protein

# two distinct subunits placed side by side
a = make_protein(n_res=60, seed=7)
b = make_protein(n_res=80, seed=9)
a = a.with_coords(a.coords - a.coords.mean(0))
b = b.with_coords(b.coords - b.coords.mean(0) + np.array([34.0, 0.0, 0.0]))
coords = np.concatenate([a.coords, b.coords])
masses = np.concatenate([a.masses, b.masses])
write_mrc(simulate_density(coords, 8.0, 2.0, masses=masses),
          os.path.join(workdir, "hetero_map.mrc"))
write_pdb(a, os.path.join(workdir, "subA.pdb"))
write_pdb(b, os.path.join(workdir, "subB.pdb"))

het = MaD(workdir=workdir)
het.add_map(os.path.join(workdir, "hetero_map.mrc"), resolution=8.0)
het.add_subunit(os.path.join(workdir, "subA.pdb"), n_copies=1)
het.add_subunit(os.path.join(workdir, "subB.pdb"), n_copies=1)
het.run(transform_subunits=True)
het.build_assembly()
""")

cell(MD, """
## 2. Tweaking parameters

All examples above use default parameters — MaD is as plug-and-play as it
gets. The reference documents eight experimental systems and the few
parameter tweaks they need (`run_MaD.py:6-60`, notebook cells 7-20); the
same knobs exist here with the same names and defaults:

| System (EMDB / PDB) | Resolution | Tweaks | Why |
|---|---|---|---|
| RAG complex (EMD-7845 / 6dbl) | 5 Å | defaults | — |
| NMDA receptor (EMD-8581 / 5up2) | 6 Å | defaults | 5 hetero-subunits |
| VAT complex (EMD-3436 / 5g4f) | 7 Å | defaults | 6 copies |
| Actin:tropomyosin (EMD-5751 / 3j4k) | 8 Å | defaults | ×5 |
| Microtubule + kinesin (EMD-1340 / 2p4n) | 9 Å | `cc_threshold=0.5, n_samples=80` | poorly resolved kinesin, large voxels |
| MecA-ClpC (EMD-5609 / 3j3u) | 10 Å | `n_samples=100, cc_threshold=0.5` | MecA (~25 kDa) undockable |
| GluK2 (EMD-8290 / 5kuh) | 11.6 Å | `patch_size=24` | low resolution: larger descriptor support |
| β-galactosidase (EMD-2548 / 4ckd) | 13 Å | `n_samples=120, patch_size=12` | 3 Å voxels: shrink patch to 36 Å; Fabs undockable |

Guidance distilled from the reference:
* **`cc_threshold`** (default 0.6) — descriptor-matching cosine cut. Lower
  to 0.5 when density is poorly resolved so valid pairs survive.
* **`n_samples`** (default 60) — descriptor pairs consumed by clustering
  (per copy). Raise (80-120) together with lower `cc_threshold`.
* **`patch_size`** (default 16 voxels) — descriptor support diameter. At
  large voxel spacings shrink it (12) so the patch stays comparable to the
  subunit; at low resolution with small voxels, grow it (24).
* **minimum dockable size** — roughly 90-100 kDa at 13 Å resolution;
  smaller domains (Fabs, MecA) cannot be reliably docked at such
  resolutions.

The same tweaks apply through `run()` here:
""")

cell(CODE, """
# cc_threshold / n_samples / weight_threshold don't change the descriptors,
# so this run loads them from dsc_db and only redoes matching onwards.
# (patch_size DOES change descriptors and would recompute them.)
tweaked = MaD(workdir=workdir)
tweaked.add_map(os.path.join(workdir, "trimer_map.mrc"), resolution=8.0)
tweaked.add_subunit(os.path.join(workdir, "subunit.pdb"), n_copies=3)
tweaked.run(transform_subunits=True, cc_threshold=0.5, n_samples=80)
print(f"{len(tweaked.solutions['subunit'])} solutions with tweaked knobs")
""")

cell(MD, """
## 3. Ensemble docking

An ensemble is passed like any other structure: give `add_subunit` a
**folder** of PDB frames instead of a file. Each frame docks
independently; `score_ensembles()` aggregates the per-frame
`Solutions_refined_*.csv` tables and ranks conformers by mean
Repeatability / Weight / mCC / RWmCC (a 4-panel bar plot is saved as
`Plot_score_ensemble.png`).

For large stoichiometries (e.g. GroEL ×14 in the reference) skip
`build_assembly()` on the full ensemble: rank the conformers first, then
re-run MaD on the best frame alone and build the assembly from it.
""")

cell(CODE, """
ens_dir = os.path.join(workdir, "ensemble")
os.makedirs(ens_dir, exist_ok=True)
rng = np.random.default_rng(0)
write_pdb(subunit, os.path.join(ens_dir, "frame_a.pdb"))
jit = subunit.with_coords(
    subunit.coords + rng.normal(scale=0.4, size=subunit.coords.shape))
write_pdb(jit, os.path.join(ens_dir, "frame_b.pdb"))

ens = MaD(workdir=workdir)
ens.add_map(os.path.join(workdir, "trimer_map.mrc"), resolution=8.0)
ens.add_subunit(ens_dir, n_copies=3)
ens.run(transform_subunits=True)
rankings = ens.score_ensembles()
print(rankings)
""")

cell(MD, """
The ranking reports, per conformer:

* **R** — repeatability (percentage of corresponding anchors),
* **|clust|** — cluster size (descriptor pairs agreeing with a
  localization),
* **CC** — cross-correlation with the map,
* **S** — the merged score (their product).

The undeformed frame (`frame_a`) should rank at or near the top on S.
""")

cell(MD, """
## 4. Anchor files

Within `results/<system>/individual_solutions` you will find an
`anchor_files` folder with the anchors and descriptors behind each
solution (all ChimeraX/VMD-ready, same formats as the reference):

* `anchor_cor_<COMPONENT>_<IDX>.bld` — correspondences between component
  and map anchors that yielded solution IDX (cylinders).
* `anchor_hi/lo_<COMPONENT>_<IDX>.pdb` — coordinates of the anchors with
  valid descriptors; `hi` = component anchors, `lo` = map anchors.
* `anchor_ori_hi/lo_<COMPONENT>_<IDX>.bld` — dominant orientation arrows
  of those anchors.
* `corresp_anchors_<COMPONENT>_<IDX>.pdb` — corresponding anchors for a
  solution (useful during global matching even without valid
  descriptors).

Pre-refinement artifacts (`pre_solutions/` + `Solutions_filtered_*.csv`)
can be enabled with `mad.save_pre_solutions = True` before `run()`.
""")

cell(MD, """
## 5. Device notes: meshes, caches, debugging

* **Multi-device**: pass a mesh to shard the whole pipeline —
  `MaD(workdir, mesh="auto")` uses every local device; `mesh=None`
  (default) runs single-device. Volumes shard spatially for the
  scale-space filters, anchors/descriptor-pairs/pose-candidates shard
  across devices for the gather/matmul stages; results equal the
  single-device run.
* **Compile cache**: XLA programs persist in `JAX_COMPILATION_CACHE_DIR`
  when it is set, else in `.jax_cache/` inside the checkout (override
  with `MAD_TPU_CACHE`), so repeat runs skip compilation.
* **Descriptor cache**: `dsc_db/*.h5` holds descriptors keyed by all
  describe parameters; delete it to force recomputation.
* **NaN debugging**: set `MAD_TPU_NANCHECK=1` (or call
  `mad_tpu.core.config.set_nan_checks(True)`) to raise at the first
  NaN/inf inside any jitted stage.
""")

cell(CODE, """
import jax
from mad_tpu.parallel.mesh import auto_mesh

mesh = auto_mesh()
print(f"{len(jax.devices())} device(s); mesh = {mesh}")
# With >= 2 devices this runs the fully sharded pipeline:
if mesh is not None:
    sharded = MaD(workdir=workdir, mesh=mesh)
    sharded.add_map(os.path.join(workdir, "trimer_map.mrc"), resolution=8.0)
    sharded.add_subunit(os.path.join(workdir, "subunit.pdb"), n_copies=3)
    sharded.run(transform_subunits=True)
    print(f"sharded run: {len(sharded.solutions['subunit'])} solutions")
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
                   "WALKTHROUGH.ipynb")
with open(out, "w") as fh:
    json.dump(nb, fh, indent=1)
print(f"wrote {os.path.normpath(out)} ({len(cells)} cells)")
