"""mad_tpu — accelerator-native macromolecular docking framework.

A from-scratch JAX/XLA re-design of the capabilities of LBM-EPFL/MaD (rigid
fitting of atomic subunits into intermediate-resolution cryo-EM maps via
rotation-invariant 3D density descriptors), running on one GPU or a mesh of
them:

  * batched/vmapped kernels with static shapes instead of per-anchor Python
    loops (detection, orientation, descriptors, matching, refinement);
  * device matmuls for descriptor similarity and pose scoring;
  * device-mesh sharding (jax.sharding + shard_map) for volumes, descriptor
    pairs and pose candidates — the reference has no parallelism at all.

Public surface mirrors the reference's user API (mad/MaD.py):

    from mad_tpu import MaD
    mad = MaD()
    mad.add_map("emd_3436.mrc", 7)
    mad.add_subunit("5g4f_subunit.pdb", n_copies=6)
    mad.run()
    mad.build_assembly()
"""

from .api import MaD
from .core.config import MadConfig
from .core.grid import DensityGrid, read_map, write_mrc, write_sit
from .core.structure import Structure, parse_pdb, write_pdb
from .engine.pipeline import DescriptorSet, describe_grid, describe_structure
from .engine.docking import dock_structure, Solution
from .ops.simulate import simulate_density

__version__ = "0.1.0"

__all__ = [
    "MaD", "MadConfig", "DensityGrid", "Structure", "DescriptorSet",
    "Solution", "read_map", "write_mrc", "write_sit", "parse_pdb",
    "write_pdb", "describe_grid", "describe_structure", "dock_structure",
    "simulate_density",
]
