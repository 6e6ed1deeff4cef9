from clover_tpu_torch.engine.checkpoint import (  # noqa: F401
    CheckpointManager,
    load_params,
    merge_pretrained_params,
    restore_or_init,
)
from clover_tpu_torch.engine.eval_loop import (  # noqa: F401
    run_itm_retrieval_eval,
    run_mc_retrieval_eval,
    run_qa_eval,
    run_retrieval_eval,
    run_zeroshot_action_eval,
)
from clover_tpu_torch.engine.model_batch import to_model_batch  # noqa: F401
from clover_tpu_torch.engine.optim import (  # noqa: F401
    freeze_by_prefix,
    freeze_mask_from_cfg,
    make_optimizer,
    step_schedule,
    weight_decay_mask,
)
from clover_tpu_torch.engine.steps import (  # noqa: F401
    ema_momentum_schedule,
    make_embed_eval_step,
    make_itm_embed_step,
    make_itm_score_step,
    make_pretrain_train_step,
    make_qa_eval_step,
    make_qa_train_step,
    make_retrieval_train_step,
)
from clover_tpu_torch.engine.train_state import TrainState  # noqa: F401
from clover_tpu_torch.engine.trainer import Trainer, interleave_loaders  # noqa: F401
