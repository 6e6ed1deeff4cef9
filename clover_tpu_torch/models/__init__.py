from clover_tpu_torch.models.bert import BertConfig, BertTextEncoder  # noqa: F401
from clover_tpu_torch.models.bridge import (  # noqa: F401
    load_jax_params,
    opt_state_from_jax,
    state_from_jax,
)
from clover_tpu_torch.models.finetune import CloverFinetune, FinetuneConfig  # noqa: F401
from clover_tpu_torch.models.fusion import CrossModalTransformer, FusionConfig  # noqa: F401
from clover_tpu_torch.models.heads import (  # noqa: F401
    MASK_TOKEN_ID,
    ITMHead,
    MLMHead,
    NCEHeadForMM,
    NCEHeadForText,
    NCEHeadForVision,
    QAMCHead,
    QAOEHead,
)
from clover_tpu_torch.models.layers import init_params  # noqa: F401
from clover_tpu_torch.models.pretrain import CloverPretrain, PretrainConfig  # noqa: F401
from clover_tpu_torch.models.swin3d import (  # noqa: F401
    SwinConfig,
    SwinTransformer3D,
    swin_bias_cache,
)
