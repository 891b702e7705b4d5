"""Architecture config registry of the port. Importing it registers the
recsys, LM and GNN archs of the JAX package but DeepSeek-V3, whose family
is not ported yet (``launch/train.py`` names it and exits)."""
from repro_torch.configs.base import (ArchDef, ShapeSpec, get_arch,  # noqa: F401
                                      list_archs, register)
from repro_torch.configs import (  # noqa: F401
    bert4rec, bst, command_r_plus_104b, dcn_v2, dlrm_rm2, gin_tu,
    granite_moe_3b_a800m, guitar_deepfm, starcoder2_3b, yi_9b,
)
