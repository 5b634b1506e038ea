"""Test support of the port: its own copy of the JAX package's shared
fake serving-cluster bring-up (``fake_serving.py``), over fabricated GPU
hosts."""
