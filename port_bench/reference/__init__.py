"""The plain reference the benchmark judges the port against.

Plain torch and numpy only: nothing here imports the port, jax or the
JAX package, and nothing takes a value the port computed except the
outputs it judges.
"""
