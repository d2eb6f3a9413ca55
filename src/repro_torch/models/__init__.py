"""The model zoo of the port: every family of the JAX package on one device."""
