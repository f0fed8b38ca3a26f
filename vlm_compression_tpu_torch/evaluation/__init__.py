"""Evaluation metrics of the port (counterpart of
``vlm_compression_tpu.evaluation``): the official VQAv2 accuracy, GQA exact
match and the OK-VQA answer lemmatizer."""
