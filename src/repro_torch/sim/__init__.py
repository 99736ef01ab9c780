"""Stage compiler, execution engine, gate application, oracles and measurement."""
