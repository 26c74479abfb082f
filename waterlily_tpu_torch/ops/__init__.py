"""Operators: boundary conditions, convection, Poisson, multigrid, kernels."""
