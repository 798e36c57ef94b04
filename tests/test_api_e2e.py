"""End-to-end session test: self-fit of a synthetic dimer with the decoy
transform protocol (the reference's de-facto correctness check,
SURVEY.md section 4)."""

import os

import numpy as np
import pytest

from mad_tpu.api import MaD
from mad_tpu.core.structure import write_pdb, parse_pdb
from mad_tpu.ops.simulate import simulate_density
from mad_tpu.core.grid import write_mrc
from mad_tpu.testing import make_assembly

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    sub, copies = make_assembly(n_copies=2, n_res=60, seed=4, spread=16.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, masses=masses)
    map_path = str(root / "dimer_map.mrc")
    write_mrc(dmap, map_path)
    sub_path = str(root / "subunit.pdb")
    write_pdb(copies[0], sub_path)
    return root, map_path, sub_path, copies


@pytest.fixture(scope="module")
def session(system):
    root, map_path, sub_path, copies = system
    mad = MaD(workdir=str(root))
    mad.add_map(map_path, resolution=8.0)
    mad.add_subunit(sub_path, n_copies=2)
    mad.save_pre_solutions = True
    mad.run(transform_subunits=True)
    return mad


def test_full_session(system, session):
    root, map_path, sub_path, copies = system
    mad = session
    # solutions exist and recover both copies
    key = "subunit"
    sols = mad.solutions[key]
    assert len(sols) >= 2
    for c in copies:
        best = min(s.structure.rmsd_ca_with(c) for s in sols)
        assert best < 4.0, best

    # artifact tree parity
    out = mad.out_folder
    assert os.path.isdir(os.path.join(out, "initial_files"))
    assert os.path.isdir(os.path.join(out, "individual_solutions"))
    assert os.path.exists(os.path.join(out, f"Solutions_refined_{key}.csv"))
    sols_dir = os.path.join(out, "individual_solutions")
    assert any(f.startswith("sol_") for f in os.listdir(sols_dir))
    assert os.path.isdir(os.path.join(sols_dir, "anchor_files"))
    # anchor dumps come in both pseudo-PDB and raw .npy form
    # (parity mad/Detector.py:47-49)
    anchor_files = os.listdir(os.path.join(sols_dir, "anchor_files"))
    for target in ("hi", "lo"):
        pdbs = [f for f in anchor_files
                if f.startswith(f"anchor_{target}_") and f.endswith(".pdb")]
        npys = [f for f in anchor_files
                if f.startswith(f"anchor_{target}_") and f.endswith(".npy")]
        assert pdbs and len(npys) == len(pdbs)
        arr = np.load(os.path.join(sols_dir, "anchor_files", npys[0]))
        assert arr.ndim == 2 and arr.shape[1] == 4     # x, y, z, bin
    # descriptor cache populated and reusable
    db = os.path.join(str(root), "dsc_db")
    assert len(os.listdir(db)) >= 2

    # assembly building
    mad.build_assembly()
    models_dir = os.path.join(out, "assembly_models")
    assert os.path.isdir(models_dir)
    models = [f for f in os.listdir(models_dir) if f.startswith("Model_")]
    assert models
    m1 = parse_pdb(os.path.join(models_dir, "Model_1.pdb"))
    total = sum(c.n_atoms for c in copies)
    assert m1.n_atoms == total
    assert os.path.exists(os.path.join(out, "complex_ranking.csv"))


def test_pre_solutions_artifacts(system, session):
    # save_pre_solutions emits the pre-refinement artifact set
    # (parity mad/MaD.py:891-921; call site commented out at :404-405).
    import csv
    mad = session
    out = mad.out_folder
    pre = os.path.join(out, "pre_solutions")
    assert os.path.isdir(pre)
    presols = [f for f in os.listdir(pre) if f.startswith("presol_subunit_")]
    assert presols
    csv_path = os.path.join(out, "Solutions_filtered_subunit.csv")
    assert os.path.exists(csv_path)
    with open(csv_path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == len(presols)
    assert set(rows[0]) == {"ID", "dCC", "Repeatability", "Weight", "RW"}
    # each pre-solution is a full copy of the subunit
    sub = parse_pdb(os.path.join(out, "initial_files", "subunit.pdb"))
    p0 = parse_pdb(os.path.join(pre, presols[0]))
    assert p0.n_atoms == sub.n_atoms
    # score column is weight * repeat (mad/MaD.py:547)
    for r in rows:
        assert float(r["RW"]) == pytest.approx(
            float(r["Weight"]) * float(r["Repeatability"]), rel=1e-4)


def test_descriptor_cache_roundtrip(system):
    # Cached descriptors short-cut the pipeline and load identically.
    root, map_path, sub_path, copies = system
    from mad_tpu import cache as dsc_cache
    db = os.path.join(str(root), "dsc_db")
    files = [f for f in os.listdir(db) if f.endswith(".h5")]
    assert files
    ds = dsc_cache.load_descriptors(os.path.join(db, files[0]))
    assert ds.n > 0
    assert ds.desc.shape[1] == 1024
    np.testing.assert_allclose(np.linalg.norm(ds.desc_norm, axis=1), 1.0,
                               atol=1e-5)


def test_heteromer_assembly_path(system, session):
    # Exercise the subcomplex + cartesian-product assembly path
    # (mad/MaD.py:216-222, 748-843) by registering the docked solutions
    # under two distinct subunit keys.
    root, map_path, sub_path, copies = system
    mad = session
    n_copies, files = mad.buildable_subunits["subunit"]
    assert len(files) >= 2
    mad.buildable_subunits = {
        "subA": [1, [files[0], files[1]]],
        "subB": [1, list(files)],
    }
    mad.build_assembly()
    out = mad.out_folder
    assert os.path.isdir(os.path.join(out, "subcomplexes"))
    subs = os.listdir(os.path.join(out, "subcomplexes"))
    assert any(f.startswith("SubComplexsubA") for f in subs)
    models_dir = os.path.join(out, "assembly_models")
    models = [f for f in os.listdir(models_dir) if f.startswith("Model_")]
    assert models
    # Best heteromer model = the two distinct placements (no self-overlap)
    m1 = parse_pdb(os.path.join(models_dir, "Model_1.pdb"))
    chains = {row[3] for row in m1.info}
    assert chains == {"A", "B"}


def test_ensemble_scoring(system):
    # Two-frame ensemble of the same subunit: both frames dock, the ensemble
    # ranking aggregates their CSVs (parity mad/MaD.py:225-286).
    root, map_path, sub_path, copies = system
    ens_dir = os.path.join(str(root), "ensemble")
    os.makedirs(ens_dir, exist_ok=True)
    sub = parse_pdb(sub_path)
    write_pdb(sub, os.path.join(ens_dir, "frame_a.pdb"))
    jittered = sub.with_coords(
        sub.coords + np.random.default_rng(0).normal(scale=0.3,
                                                     size=sub.coords.shape))
    write_pdb(jittered, os.path.join(ens_dir, "frame_b.pdb"))

    mad = MaD(workdir=str(root))
    mad.add_map(map_path, resolution=8.0)
    mad.add_subunit(ens_dir, n_copies=2)
    mad.run(transform_subunits=True)
    rankings = mad.score_ensembles()
    assert "ensemble" in rankings
    assert len(rankings["ensemble"]) == 2
    for row in rankings["ensemble"]:
        assert row[3] > 0.5          # mean mCC of a correct dock is high
    assert os.path.exists(os.path.join(mad.out_folder,
                                       "Plot_score_ensemble.png"))


def test_ensemble_frames_batch_through_describe_pool(system, monkeypatch,
                                                     tmp_path):
    """Cache-miss ensemble frames describe through the SAME describe_many
    pool call as the map and plain subunits (api.get_descriptors), so an
    N-frame ensemble's host work overlaps instead of serializing
    (round-2 verdict item 5)."""
    from mad_tpu.engine import pipeline as pl

    root, map_path, sub_path, copies = system
    ens_dir = os.path.join(str(tmp_path), "ens3")
    os.makedirs(ens_dir, exist_ok=True)
    sub = parse_pdb(sub_path)
    rng = np.random.default_rng(1)
    for fk in ("fa", "fb", "fc"):
        write_pdb(sub.with_coords(
            sub.coords + rng.normal(scale=0.2, size=sub.coords.shape)),
            os.path.join(ens_dir, f"{fk}.pdb"))

    calls = []
    orig = pl.describe_many

    def recording(jobs, *a, **kw):
        calls.append(len(jobs))
        return orig(jobs, *a, **kw)

    monkeypatch.setattr(pl, "describe_many", recording)
    mad = MaD(workdir=str(tmp_path))      # fresh dsc_db: all jobs miss
    mad.add_map(map_path, resolution=8.0)
    mad.add_subunit(ens_dir, n_copies=2)
    mad.check_preprocess_data()
    mad.get_descriptors()                 # describe phase only (no docking)
    # ONE pool call carrying map + all 3 frames together.
    assert calls == [4]
    assert mad.map_dsc is not None and mad.map_dsc.n > 0
    assert sum(1 for v in mad.dsc_dict.values() if isinstance(v, str)) == 3
