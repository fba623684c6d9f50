"""Training of the port: AdamW, the synthetic corpus, the train step and
checkpoints (the JAX package's ``repro.training``)."""
