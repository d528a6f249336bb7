"""Problem generators of the port: Gaussian toy and LOFAR station sky."""
