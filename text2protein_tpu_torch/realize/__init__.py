"""3-D realization: 6D maps -> backbone coordinates by restrained
minimization, and fixed-backbone sequence design."""

from .geometry import (build_backbone, random_dihedrals,
                       virtual_cb_from_backbone)
from .minimize import realize_batch, realize_6d_sample, run_minimization
from .restraints import Restraints, inverse_scale, restraints_from_maps
