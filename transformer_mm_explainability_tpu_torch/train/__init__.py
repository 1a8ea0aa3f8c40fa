"""The training path: steps, optimizers, schedules, checkpoints, the
trainer and the LXMERT and DETR training loops."""
