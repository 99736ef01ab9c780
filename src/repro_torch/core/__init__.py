"""Circuit IR, gate library, circuit families and the planner (copies of ``repro/core``)."""
