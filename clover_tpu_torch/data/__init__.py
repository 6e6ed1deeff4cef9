from clover_tpu_torch.data.datasets import (  # noqa: F401
    VideoQADataset,
    VideoTextDataset,
    load_annotations,
    make_synthetic_retrieval_dataset,
)
from clover_tpu_torch.data.loader import (  # noqa: F401
    DataLoader,
    ShardedSampler,
    default_collate,
    prefetch_to_device,
)
from clover_tpu_torch.data.sampling import sample_frame_indices  # noqa: F401
from clover_tpu_torch.data.text_masking import MASK_ENGINES  # noqa: F401
from clover_tpu_torch.data.tokenization import BertTokenizer, build_test_vocab  # noqa: F401
from clover_tpu_torch.data.video_masking import (  # noqa: F401
    MaskingGenerator,
    RandomMaskGenerator,
)
