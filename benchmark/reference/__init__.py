"""The benchmark's plain reference: the training iterations of its cells
in plain PyTorch, float32 with TF32 off, written from the published
models and the recipes' step, with its own template and event synthesis.
It imports neither JAX nor the JAX package nor anything of the program
(``gennet_tpu_torch``); it reads the program's outputs only to judge them.
"""
