"""Meshes and collectives on ``torch.distributed`` (counterpart of
``u2tokenizer_tpu/parallel/``): ``mesh`` for the (data, fsdp, tensor) mesh
and the parameter placements, ``collectives`` for the collectives over a
mesh dim."""
