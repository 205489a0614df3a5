"""Operators: quaternions, RPY blocks, mobility and force products, Krylov solvers, CUDA kernels."""
