"""The LM training substrate: checkpoints, fault tolerance and gradient
compression."""
