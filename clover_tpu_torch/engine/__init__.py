from clover_tpu_torch.engine.eval_loop import run_retrieval_eval  # noqa: F401
from clover_tpu_torch.engine.steps import make_embed_eval_step  # noqa: F401
