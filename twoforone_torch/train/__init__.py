"""Training (port of ``twoforone_tpu/train``): the EMA of the weights and
the trainer."""
