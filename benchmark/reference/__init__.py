"""The plain reference the benchmark judges the program against.

Plain PyTorch and NumPy, written from the published descriptions of the
models and of DaliID's training step. It imports nothing of the program
(``daliid_tpu_torch``), nothing of the JAX package and no JAX. It runs in
float32 with TF32 off; :mod:`.precision` lowers it to float8 for the
control that every limit must reject.
"""
