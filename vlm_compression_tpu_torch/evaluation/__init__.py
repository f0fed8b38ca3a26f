"""Evaluation metrics of the port (counterpart of
``vlm_compression_tpu.evaluation``): the official VQAv2 accuracy, GQA exact
match, the OK-VQA answer lemmatizer, the COCO caption metrics (with
host-only copies of nltk's Treebank tokenizer and Porter stemmer) and the
retrieval R@k (``itm_eval``)."""

from vlm_compression_tpu_torch.evaluation.retrieval_metrics import (  # noqa: F401
    itm_eval,
)
