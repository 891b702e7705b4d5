"""Architecture config registry of the port. Importing it registers the
recsys archs (the JAX package's LM and GNN archs wait for their families:
``launch/train.py`` names them and exits)."""
from repro_torch.configs.base import (ArchDef, ShapeSpec, get_arch,  # noqa: F401
                                      list_archs, register)
from repro_torch.configs import (bert4rec, bst, dcn_v2, dlrm_rm2,  # noqa: F401
                                 guitar_deepfm)
