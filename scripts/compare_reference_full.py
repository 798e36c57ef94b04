"""Cross-implementation e2e agreement beyond the dimer (VERDICT r2 item 6).

Runs BOTH full sessions (add_map / add_subunit / run / build_assembly /
score_ensembles) on the same synthetic systems and compares results:

(a) 3-component heteromer with a x2 subunit — the RAG/6dbl shape
    (/root/reference/run_MaD.py:6-12): per-subunit solution sets and the
    final assembly model composition must agree;
(b) small ensemble conformer ranking — the GroEL shape (reference
    notebook cells 24-27): the true conformer must top both rankings.

The reference code is untouched: its CWD-relative EQSP tables are served
through a ``mad`` symlink inside a scratch workdir, and the skimage /
mrcfile imports it needs are shimmed (see compare_reference.py).

Usage: PYTHONPATH=/root/repo python scripts/compare_reference_full.py
(CPU-only; the reference is pure NumPy. Takes several minutes.)
"""

import os
import sys
import time

# Force CPU before any jax import: the comparison with the NumPy reference
# runs on the host (the env var plus jax.config, before any jax use).
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from compare_reference import install_shims, REF  # noqa: E402


def bend(struct, angle=0.35, seed=0):
    """Smooth conformational deformation: rotate the chain's second half
    about its joint (decoy conformer generator)."""
    from mad_tpu.core.geometry import axis_angle_mat
    import jax.numpy as jnp
    c = struct.coords.copy()
    half = len(c) // 2
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    R = np.asarray(axis_angle_mat(jnp.asarray(axis), jnp.asarray(angle)))
    pivot = c[half]
    c[half:] = (c[half:] - pivot) @ R.T + pivot
    return struct.with_coords(c)


def rmsd_ca(coords_a, ca_a, coords_b, ca_b):
    d = np.square(coords_a[ca_a] - coords_b[ca_b])
    return float(np.sqrt(d.sum() / max(1, d.shape[0])))


def build_heteromer(workdir):
    """Subunit A (x2) + B + C placed clash-free; 8 A combined map."""
    from mad_tpu.testing import make_protein
    from mad_tpu.core.structure import write_pdb
    from mad_tpu.core.grid import write_sit
    from mad_tpu.ops.simulate import simulate_density

    A = make_protein(n_res=50, seed=21)
    B = make_protein(n_res=60, seed=22)
    C = make_protein(n_res=44, seed=23)
    placements = [  # (structure, center)
        (A, np.array([0.0, 0.0, 0.0])),
        (A, np.array([44.0, 0.0, 0.0])),
        (B, np.array([22.0, 38.0, 0.0])),
        (C, np.array([22.0, 16.0, 34.0])),
    ]
    truth = []
    for s, t in placements:
        truth.append(s.with_coords(s.coords - s.coords.mean(axis=0) + t))
    coords = np.concatenate([s.coords for s in truth])
    masses = np.concatenate([s.masses for s in truth])
    dmap = simulate_density(coords, 8.0, 2.0, masses=masses)
    write_sit(dmap, os.path.join(workdir, "het_map.sit"))
    for name, s in (("subA", A), ("subB", B), ("subC", C)):
        write_pdb(s, os.path.join(workdir, f"{name}.pdb"))
    return truth


def build_ensemble(workdir):
    """Dimer map of conformer 'true'; ensemble folder with the true frame
    and two bent decoys."""
    from mad_tpu.testing import make_assembly
    from mad_tpu.core.structure import write_pdb
    from mad_tpu.core.grid import write_sit
    from mad_tpu.ops.simulate import simulate_density

    sub, copies = make_assembly(n_copies=2, n_res=50, seed=31, spread=16.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, masses=masses)
    write_sit(dmap, os.path.join(workdir, "ens_map.sit"))
    ens = os.path.join(workdir, "conformers")
    os.makedirs(ens, exist_ok=True)
    write_pdb(sub, os.path.join(ens, "conf_true.pdb"))
    write_pdb(bend(sub, 0.35, seed=1), os.path.join(ens, "conf_bentA.pdb"))
    write_pdb(bend(sub, 0.6, seed=2), os.path.join(ens, "conf_bentB.pdb"))
    return copies


def run_mad_tpu(workdir, het=True, ens=True):
    from mad_tpu.api import MaD

    out = {}
    if het:
        wd = os.path.join(workdir, "mad_het")
        os.makedirs(wd, exist_ok=True)
        mad = MaD(workdir=wd)
        mad.add_map(os.path.join(workdir, "het_map.sit"), 8.0)
        mad.add_subunit(os.path.join(workdir, "subA.pdb"), n_copies=2)
        mad.add_subunit(os.path.join(workdir, "subB.pdb"), n_copies=1)
        mad.add_subunit(os.path.join(workdir, "subC.pdb"), n_copies=1)
        t0 = time.time()
        mad.run(transform_subunits=True)
        mad.build_assembly()
        out["het_time"] = time.time() - t0
        out["het"] = mad
    if ens:
        wd = os.path.join(workdir, "mad_ens")
        os.makedirs(wd, exist_ok=True)
        mad = MaD(workdir=wd)
        mad.add_map(os.path.join(workdir, "ens_map.sit"), 8.0)
        mad.add_subunit(os.path.join(workdir, "conformers"), n_copies=2)
        t0 = time.time()
        mad.run(transform_subunits=True)
        rankings = mad.score_ensembles()
        out["ens_time"] = time.time() - t0
        out["ens"] = rankings
    return out


def run_reference(workdir, het=True, ens=True):
    install_shims()
    out = {}

    def session(wd, map_file, subunits):
        os.makedirs(wd, exist_ok=True)
        link = os.path.join(wd, "mad")
        if not os.path.exists(link):
            os.symlink(os.path.join(REF, "mad"), link)
        cwd = os.getcwd()
        os.chdir(wd)
        try:
            from mad import MaD as refMaD
            mad = refMaD.MaD()
            mad.add_map(map_file, 8.0)
            for sub, n in subunits:
                mad.add_subunit(sub, n_copies=n)
            mad.run(transform_subunits=True)
            mad.build_assembly()
            return mad
        finally:
            os.chdir(cwd)

    if het:
        t0 = time.time()
        out["het"] = session(
            os.path.join(workdir, "ref_het"),
            os.path.join(workdir, "het_map.sit"),
            [(os.path.join(workdir, "subA.pdb"), 2),
             (os.path.join(workdir, "subB.pdb"), 1),
             (os.path.join(workdir, "subC.pdb"), 1)])
        out["het_time"] = time.time() - t0
    if ens:
        t0 = time.time()
        wd = os.path.join(workdir, "ref_ens")
        os.makedirs(wd, exist_ok=True)
        link = os.path.join(wd, "mad")
        if not os.path.exists(link):
            os.symlink(os.path.join(REF, "mad"), link)
        cwd = os.getcwd()
        os.chdir(wd)
        try:
            from mad import MaD as refMaD
            mad = refMaD.MaD()
            mad.add_map(os.path.join(workdir, "ens_map.sit"), 8.0)
            mad.add_subunit(os.path.join(workdir, "conformers"), n_copies=2)
            mad.run(transform_subunits=True)
            mad.score_ensembles()
            out["ens"] = mad
        finally:
            os.chdir(cwd)
        out["ens_time"] = time.time() - t0
    return out


def compare_het(our_mad, ref_mad, truth, workdir):
    from mad_tpu.core.structure import parse_pdb

    print("\n=== heteromer (subA x2 + subB + subC) ===")
    labels = ["subA#0", "subA#1", "subB", "subC"]
    # per-copy best solution RMSD, both implementations
    our_sols = {k: v for k, v in our_mad.solutions.items()
                if not k.endswith("_files")}
    agree = 0
    for lab, t in zip(labels, truth):
        key = "subA" if lab.startswith("subA") else lab
        best_t = min((s.structure.rmsd_ca_with(t)
                      for s in our_sols.get(key, [])), default=np.inf)
        # reference: refined solution PDBs on disk
        ref_dir = os.path.join(workdir, "ref_het")
        best_r = np.inf
        for root, _dirs, files in os.walk(ref_dir):
            for f in files:
                if f.startswith("sol_" + key) and f.endswith(".pdb"):
                    p = parse_pdb(os.path.join(root, f))
                    best_r = min(best_r, rmsd_ca(p.coords, p.ca_idx,
                                                 t.coords, t.ca_idx))
        mark = "AGREE" if (best_t < 4.0) == (best_r < 4.0) else "DISAGREE"
        if mark == "AGREE":
            agree += 1
        print(f"{lab}: best CA-RMSD vs truth  reference={best_r:6.2f} A  "
              f"mad_tpu={best_t:6.2f} A   [{mark}]")

    # final model composition: every truth copy covered by Model_1?
    def model_cover(model_path):
        if not os.path.exists(model_path):
            return None
        m = parse_pdb(model_path)
        hits = []
        for t in truth:
            # a model covers a truth copy when its CAs all have a model
            # atom within 3 A (composition check, pose-agnostic)
            ca_t = t.coords[t.ca_idx]
            dist = np.linalg.norm(
                m.coords[None, :, :] - ca_t[:, None, :], axis=-1).min(axis=1)
            hits.append(float(np.mean(dist < 3.0)))
        return hits

    for name, base in (("mad_tpu", os.path.join(our_mad.out_folder,
                                                "assembly_models")),):
        cov = model_cover(os.path.join(base, "Model_1.pdb"))
        print(f"{name} Model_1 truth coverage: "
              + (", ".join(f"{c:.2f}" for c in cov) if cov else "missing"))
    ref_models = []
    for root, _dirs, files in os.walk(os.path.join(workdir, "ref_het")):
        for f in files:
            if f.startswith("Model_") and f.endswith(".pdb"):
                ref_models.append(os.path.join(root, f))
    if ref_models:
        cov = model_cover(sorted(ref_models)[0])
        print("reference Model_1 truth coverage: "
              + ", ".join(f"{c:.2f}" for c in cov))
    else:
        print("reference produced no assembly model")
    return agree


def compare_ens(our_rankings, workdir):
    import csv
    print("\n=== ensemble conformer ranking (true + 2 bent decoys) ===")
    # mad_tpu ranking: {ens_key: [[frame, R, W, CC, S], ...]}
    our_top = None
    for _k, ranking in (our_rankings or {}).items():
        by_score = sorted(ranking, key=lambda r: r[4], reverse=True)
        our_top = by_score[0][0]
        print("mad_tpu   ranking by MaD score: "
              + "  ".join(f"{r[0]}={r[4]:.1f}" for r in by_score))
    # reference ranking: read its Solutions_refined CSVs
    ref_scores = {}
    for root, _dirs, files in os.walk(os.path.join(workdir, "ref_ens")):
        for f in files:
            if f.startswith("Solutions_refined_") and f.endswith(".csv"):
                frame = f[len("Solutions_refined_"):-len(".csv")]
                with open(os.path.join(root, f)) as fh:
                    rows = list(csv.DictReader(fh))
                col = "RWmCC" if rows and "RWmCC" in rows[0] else None
                if rows and col:
                    ref_scores[frame] = float(np.mean(
                        [float(r[col]) for r in rows]))
    ref_top = None
    if ref_scores:
        order = sorted(ref_scores.items(), key=lambda kv: -kv[1])
        ref_top = order[0][0]
        print("reference ranking by MaD score: "
              + "  ".join(f"{k}={v:.1f}" for k, v in order))
    print(f"top conformer: reference={ref_top}  mad_tpu={our_top}  "
          f"[{'AGREE' if ref_top == our_top else 'DISAGREE'}]")
    return ref_top, our_top


def main():
    workdir = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                              else "/tmp/parity_full")
    os.makedirs(workdir, exist_ok=True)
    truth = build_heteromer(workdir)
    build_ensemble(workdir)

    print("--- mad_tpu sessions ---")
    ours = run_mad_tpu(workdir)
    print(f"mad_tpu: heteromer {ours['het_time']:.1f}s, "
          f"ensemble {ours['ens_time']:.1f}s")

    print("\n--- reference sessions ---")
    ref = run_reference(workdir)
    print(f"reference: heteromer {ref['het_time']:.1f}s, "
          f"ensemble {ref['ens_time']:.1f}s")

    agree = compare_het(ours["het"], ref.get("het"), truth, workdir)
    ref_top, our_top = compare_ens(ours.get("ens"), workdir)
    print(f"\nsummary: {agree}/4 per-copy agreements; "
          f"ensemble top agreement: {ref_top == our_top}")


if __name__ == "__main__":
    main()
