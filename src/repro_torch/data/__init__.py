"""Data pipelines: the synthetic token stream that LM training reads."""
