"""Architecture config registry of the port. Importing it registers every
arch of the JAX package: the recsys, LM (DeepSeek-V3 among them) and GNN
families."""
from repro_torch.configs.base import (ArchDef, ShapeSpec, get_arch,  # noqa: F401
                                      list_archs, register)
from repro_torch.configs import (  # noqa: F401
    bert4rec, bst, command_r_plus_104b, dcn_v2, deepseek_v3_671b, dlrm_rm2,
    gin_tu, granite_moe_3b_a800m, guitar_deepfm, starcoder2_3b, yi_9b,
)
