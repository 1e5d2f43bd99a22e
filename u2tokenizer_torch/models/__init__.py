"""Model modules of the port, mirroring ``u2tokenizer_tpu/models``."""
