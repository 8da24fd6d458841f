"""Training of the port: AdamW and its schedules (``optim``) and the
trainer with microbatch accumulation and checkpoints (``trainer``)."""
