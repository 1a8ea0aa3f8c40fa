"""Multi-rank execution of the port over torch.distributed."""
