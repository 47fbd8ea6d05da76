"""The plain PyTorch reference that decides ``correct``: frozen copies of
the renderer's, the denoiser's and the training step's arithmetic.  It
imports neither JAX nor anything of the program."""
