"""The benchmark of ``raymarchdenoisercuda_torch`` on NVIDIA H100 cards:
``python3 -m benchmark.run`` (see ``run.py``).  The program it measures is
the port; nothing here imports JAX or the JAX package, and the reference
(``reference/``) imports nothing of the port."""
