"""Training: AdamW, int8 gradient compression, the train step,
checkpoints and fault tolerance (port of ``repro.training``)."""
