"""Solvers for the GLM objective: L-BFGS and NEWTON, and the problem that runs them."""
