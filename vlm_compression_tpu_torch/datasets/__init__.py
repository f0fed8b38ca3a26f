"""Data layer of the port (counterpart of ``vlm_compression_tpu.datasets``):
processors, item datasets, builders, loaders and tokenization.  Importing
the package registers the processors and the builders."""

from vlm_compression_tpu_torch.datasets import builders  # noqa: F401
from vlm_compression_tpu_torch.datasets import processors  # noqa: F401
from vlm_compression_tpu_torch.datasets.builders import (  # noqa: F401
    BaseDatasetBuilder,
    load_builder,
)
from vlm_compression_tpu_torch.datasets.loaders import (  # noqa: F401
    ConcatDataset,
    DataLoader,
    IterLoader,
    MultiIterLoader,
    PrefetchLoader,
    concat_datasets,
    prepare_sample,
    reorg_datasets_by_split,
)
from vlm_compression_tpu_torch.datasets.processors import (  # noqa: F401
    load_processor,
)
from vlm_compression_tpu_torch.datasets.tokenization import (  # noqa: F401
    SimpleTokenizer,
    batch_encode,
    batch_labels,
    load_tokenizer,
    pack_qa,
)
