"""Optimizers on torch tensors."""
