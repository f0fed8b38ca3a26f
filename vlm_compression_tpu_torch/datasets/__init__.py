"""Data layer of the port (counterpart of ``vlm_compression_tpu.datasets``):
tokenization and batch collation, and the text processors.  The image
processors and the dataset builders come with the runner and data layer."""
