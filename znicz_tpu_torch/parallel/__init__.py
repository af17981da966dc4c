"""Training steps of the port: the transformer trainer and the fused
Unit/Workflow train step."""
