"""Architecture configurations: copies of ``repro.configs`` (only imports
differ) — the ten registered LM architectures and their reduced twins."""
