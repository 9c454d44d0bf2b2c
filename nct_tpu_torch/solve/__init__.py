"""Clustering, k-NN graph and PCG solvers (counterparts of ``nct_tpu.solve``)."""
