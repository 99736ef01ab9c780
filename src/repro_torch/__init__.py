"""PyTorch/CUDA port of the Atlas statevector simulator.

Runs the planned path of the JAX package ``repro`` (partition, compile,
staged execution, measurement) on an NVIDIA GPU, with hand-written CUDA
kernels in place of the Pallas ones. Imports nothing of ``repro`` or JAX:
the JAX-free planner modules it needs are copied into ``core/`` and
``sim/``.
"""
