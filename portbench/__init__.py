"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on an
NVIDIA H100: the paper's packet data plane served through the program's
own entry points, held to a plain NumPy reference.  ``portbench/run.py``
runs one cell of ``BENCHMARK.json``; the yardstick (traffic, reference,
work counts, peaks, trace reading) lives here, where program changes
cannot move it.  Nothing here imports JAX or the JAX package.
"""
