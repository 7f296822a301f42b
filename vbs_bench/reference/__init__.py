"""The benchmark's plain reference of the sensor pipeline.

Plain PyTorch and numpy only: it imports nothing of
``vision_basedsensor_tpu_torch`` nor of the JAX package. The modules are
frozen copies of the port's plain versions (the kernels' plain PyTorch
versions in their place), kept here so that a later change to the program
cannot change the yardstick. ``pipeline.py`` is the entry point.
"""
