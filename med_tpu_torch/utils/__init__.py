"""Helpers: device selection and the JAX weight carry-over."""
