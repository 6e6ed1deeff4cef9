from clover_tpu_torch.models.bert import BertConfig, BertTextEncoder  # noqa: F401
from clover_tpu_torch.models.bridge import load_jax_params, state_from_jax  # noqa: F401
from clover_tpu_torch.models.finetune import CloverFinetune, FinetuneConfig  # noqa: F401
from clover_tpu_torch.models.heads import NCEHeadForMM  # noqa: F401
from clover_tpu_torch.models.layers import init_params  # noqa: F401
from clover_tpu_torch.models.swin3d import (  # noqa: F401
    SwinConfig,
    SwinTransformer3D,
    swin_bias_cache,
)
