"""Evaluation metrics of the port (counterpart of
``vlm_compression_tpu.evaluation``): the official VQAv2 accuracy, GQA exact
match, the OK-VQA answer lemmatizer and the COCO caption metrics (with
host-only copies of nltk's Treebank tokenizer and Porter stemmer)."""
