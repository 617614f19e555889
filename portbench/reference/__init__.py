"""Plain NumPy references of the deployments the benchmark runs.

Each module here states the semantics a configuration promises, from the
same float weights, trees and traffic the benchmark hands the program, and
imports nothing of the program, of JAX or of the JAX package.
"""
