"""Solver core of the port: thresholding, operator backends, (Q)NIHT, metrics."""
